"""ctypes loader for the native administrator kernels (``csrc/admin.c``).

Builds the shared library on first use (gcc -O3) and exposes numpy-friendly
wrappers; every entry point has a pure-numpy fallback, so the framework works
without a toolchain.  This is the framework's native runtime layer — the
counterpart of the reference's compiled core + C++ shims.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
from typing import Optional

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC = os.path.join(_REPO, "csrc", "admin.c")

_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build_and_load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if os.environ.get("POLYCHORD_TPU_NO_NATIVE"):
        return None
    try:
        cache = os.path.join(tempfile.gettempdir(), "pcadmin")
        os.makedirs(cache, exist_ok=True)
        so = os.path.join(cache, "libpcadmin.so")
        if not os.path.exists(so) or os.path.getmtime(so) < os.path.getmtime(_SRC):
            subprocess.run(
                ["gcc", "-O3", "-march=native", "-shared", "-fPIC",
                 "-o", so, _SRC, "-lm"],
                check=True,
                capture_output=True,
                timeout=120,
            )
        lib = ctypes.CDLL(so)
        dp = ctypes.POINTER(ctypes.c_double)
        ip = ctypes.POINTER(ctypes.c_int)
        lib.similarity_matrix.argtypes = [dp, ctypes.c_long, ctypes.c_long, dp]
        lib.compute_knn.argtypes = [dp, ctypes.c_long, ctypes.c_long, ip]
        lib.mutual_knn_cluster.argtypes = [ip, ctypes.c_long, ctypes.c_long, ip]
        lib.mutual_knn_cluster.restype = ctypes.c_int
        lib.identify_clusters.argtypes = [
            dp, ctypes.c_long, ctypes.c_long, dp, ctypes.c_long, ip, ip,
        ]
        _lib = lib
    except Exception:
        _lib = None
    return _lib


def _dptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _iptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))


def has_native() -> bool:
    return _build_and_load() is not None


def similarity_matrix(pts: np.ndarray) -> Optional[np.ndarray]:
    lib = _build_and_load()
    if lib is None:
        return None
    pts = np.ascontiguousarray(pts, dtype=np.float64)
    n, d = pts.shape
    out = np.empty((n, n))
    lib.similarity_matrix(_dptr(pts), n, d, _dptr(out))
    return out


def compute_knn(sim: np.ndarray, k: int) -> Optional[np.ndarray]:
    lib = _build_and_load()
    if lib is None:
        return None
    sim = np.ascontiguousarray(sim, dtype=np.float64)
    n = sim.shape[0]
    knn = np.empty((n, k), dtype=np.int32)
    lib.compute_knn(_dptr(sim), n, k, _iptr(knn))
    return knn


def mutual_knn_cluster(knn: np.ndarray) -> Optional[np.ndarray]:
    lib = _build_and_load()
    if lib is None:
        return None
    knn = np.ascontiguousarray(knn, dtype=np.int32)
    n, k = knn.shape
    labels = np.empty(n, dtype=np.int32)
    lib.mutual_knn_cluster(_iptr(knn), n, k, _iptr(labels))
    return labels.astype(int)


def identify_clusters(
    points: np.ndarray, live: np.ndarray, cluster_of_live: np.ndarray
) -> Optional[np.ndarray]:
    lib = _build_and_load()
    if lib is None:
        return None
    points = np.ascontiguousarray(points, dtype=np.float64)
    live = np.ascontiguousarray(live, dtype=np.float64)
    cl = np.ascontiguousarray(cluster_of_live, dtype=np.int32)
    out = np.empty(points.shape[0], dtype=np.int32)
    lib.identify_clusters(
        _dptr(points), points.shape[0], points.shape[1],
        _dptr(live), live.shape[0], _iptr(cl), _iptr(out),
    )
    return out.astype(int)
