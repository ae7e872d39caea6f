"""B2 at dims 33 to 128 on the CPU: the wide kernel's order (classical CGS2
column by column, each sweep's coefficients from one v) and the rounded
square root of the narrow and wide plain versions.

The kernel's own warp body (``csrc/gram_schmidt_wide.cuh::gsw_basis``),
built by ``g++`` as host C++ with its shuffles run by 32 threads, is held
bitwise to ``gram_schmidt_plain`` at each rows-a-lane bucket and its edges,
in float32 and float64 (skips without ``g++``); the plain version is held
to orthonormality and to the JAX package's XLA ``_gram_schmidt`` within
the tolerances of ``tests/test_torch_highd.py`` (and to its order spelled
out in numpy by ``tests/test_torch_gram_schmidt_long.py``), and the narrow
and wide plain versions to those orders on numpy's root (C28).  The
kernel on the card is held to the same plain version by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polychordlite_tpu.ops.directions import _gram_schmidt as jax_xla_gram_schmidt
from polychordlite_tpu_torch.experiments import gs_wide_times, ptxas_parity
from polychordlite_tpu_torch.ops import pallas_dirs
from polychordlite_tpu_torch.utils import nvcc

from test_torch_gram_schmidt_long import _narrow_spelled, _wide_spelled
from test_torch_lane_order import _STUB

torch.set_num_threads(2)

#: each rows-a-lane bucket of the wide kernel (R = 2, 3, 4) at its edges
EDGE_DIMS = [33, 64, 65, 96, 97, 128]


def _torch_root(a):
    """The CPU's torch.sqrt, the root the plain versions took before C28."""
    return torch.sqrt(torch.as_tensor(a)).numpy()


def _bases(x):
    """(dim, dim, n) numpy -> gram_schmidt_plain's (1, dim, dim, n) tensor."""
    return torch.as_tensor(np.ascontiguousarray(x[None]))


# ------------------------------------------------------------ C28: the root
#: a seed whose (dim, dim, 16) Gaussians make the CPU's torch.sqrt round some
#: norm of the orthonormalisation otherwise than the rounded root does
#: (experiments/cpu_ops_rounding.py: ~0.7 % of its inputs), at dims 20 and
#: 64 in float32 and float64
C28_SEED = 0


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("dim", [20, 64])
def test_plain_takes_the_rounded_root(dim, dtype):
    """C28: the narrow (dim 20) and wide (dim 64) plain versions give, on
    the CPU, the entries of their order spelled out with numpy's root (the
    processor's correctly rounded one, as the kernels' ``__fsqrt_rn`` and
    ``__dsqrt_rn``); where this CPU's torch.sqrt is not correctly rounded,
    the same order on it differs at this seed."""
    x = np.random.default_rng(C28_SEED).standard_normal((dim, dim, 16)).astype(dtype)
    spelled = _narrow_spelled if dim <= pallas_dirs.NARROW_MAXD else _wide_spelled
    want = spelled(x)
    got = pallas_dirs.gram_schmidt_plain(_bases(x)).numpy()[0]
    np.testing.assert_array_equal(got, want)
    r = np.random.default_rng(1).random(100_000).astype(dtype) * 300
    if (_torch_root(r) != np.sqrt(r)).any():
        assert not np.array_equal(spelled(x, _torch_root), want)


# ------------------------------------------- rows a lane: orthonormal, JAX
def _jax_atol(dim):
    """tests/test_torch_highd.py's tolerances against the JAX package: 1e-5
    to dim 40, 2e-5 to 64, 5e-5 above."""
    return 1e-5 if dim <= 40 else 2e-5 if dim <= 64 else 5e-5


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("dim", EDGE_DIMS)
def test_wide_order_at_the_rows_a_lane_edges(dim, dtype):
    """At each edge of the kernel's rows-a-lane buckets the plain version is
    orthonormal (QtQ = I to 1e-5 in float32, 1e-12 in float64) and within
    the JAX tolerances of the XLA ``_gram_schmidt`` (float64 under
    ``jax.enable_x64``)."""
    g = np.random.default_rng(dim).standard_normal((1, dim, dim, 8)).astype(dtype)
    got = pallas_dirs.gram_schmidt_plain(torch.as_tensor(g)).numpy()
    assert got.dtype == dtype
    qtq = np.einsum("nikb,nijb->nkjb", got.astype(np.float64), got.astype(np.float64))
    orth = np.abs(qtq - np.eye(dim)[None, :, :, None]).max()
    assert orth < (1e-5 if dtype == np.float32 else 1e-12)
    with jax.enable_x64(dtype == np.float64):
        want = np.asarray(jax_xla_gram_schmidt(jnp.asarray(g.transpose(0, 3, 1, 2))))
    assert want.dtype == dtype
    np.testing.assert_allclose(got, want.transpose(0, 2, 3, 1), rtol=0, atol=_jax_atol(dim))


# ------------------------------------- the kernel's warp body as host C++
_MAIN = r"""
#include <stdio.h>
#include <stdlib.h>
#include <thread>
#include <vector>
#include "gram_schmidt_wide.cuh"

// stdin: dim, n, bytes (int32), then n bases [b][i][j] in the type; stdout:
// their q in the same layout.  Each basis: staged column-major into a warp's
// shared memory (column j at j P, row i at i), gsw_basis on 32 threads.
template <class T, int R>
static void run(int dim, int n) {
    constexpr int P = GsWide<T, R>::P, KC = GsWide<T, R>::KC;
    std::vector<T> x((size_t)n * dim * dim);
    if (fread(x.data(), sizeof(T), x.size(), stdin) != x.size()) exit(1);
    std::vector<T> s((size_t)dim * P + 2 * KC + 4);
    T* s0 = s.data() + ((16 - (size_t)s.data() % 16) % 16) / sizeof(T);  // 16-byte aligned
    std::barrier<> bar(32);
    warp_barrier = &bar;
    for (int b = 0; b < n; ++b) {
        for (size_t e = 0; e < (size_t)dim * P; ++e) s0[e] = T(1e30);  // rows past dim: not read
        for (int i = 0; i < dim; ++i)
            for (int j = 0; j < dim; ++j) s0[j * P + i] = x[((size_t)b * dim + i) * dim + j];
        std::vector<std::thread> lanes;
        for (int l = 0; l < 32; ++l)
            lanes.emplace_back([&, l] { lane_id = l; gsw_basis<T, R>(s0, dim, l); });
        for (auto& t : lanes) t.join();
        for (int i = 0; i < dim; ++i)
            for (int j = 0; j < dim; ++j) x[((size_t)b * dim + i) * dim + j] = s0[j * P + i];
    }
    fwrite(x.data(), sizeof(T), x.size(), stdout);
}

template <class T>
static void by_rows(int dim, int n) {
    switch ((dim + 31) / 32) {
        case 2: return run<T, 2>(dim, n);
        case 3: return run<T, 3>(dim, n);
        default: return run<T, 4>(dim, n);
    }
}

int main() {
    int h[3];
    if (fread(h, sizeof(int), 3, stdin) != 3) return 1;
    if (h[2] == 8)
        by_rows<double>(h[0], h[1]);
    else
        by_rows<float>(h[0], h[1]);
    return 0;
}
"""

_EXTRA = r"""
#define __fsqrt_rn(x) sqrtf(x)
#define __dsqrt_rn(x) sqrt(x)
struct float4 { float x, y, z, w; };
struct double2 { double x, y; };
static void __syncwarp(unsigned = 0xffffffffu) { warp_barrier->arrive_and_wait(); }
"""


@pytest.fixture(scope="module")
def wide_host(tmp_path_factory):
    """The host program of _MAIN: gsw_basis on 32 threads; skips without g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ on the PATH")
    tmp = tmp_path_factory.mktemp("gs_wide_host")
    (tmp / "cuda_runtime.h").write_text(_STUB + _EXTRA)
    (tmp / "main.cpp").write_text('#include "cuda_runtime.h"\n' + _MAIN)
    exe = tmp / "gs_wide"
    subprocess.run([gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-pthread", "-I", str(tmp),
                    "-I", str(nvcc.CSRC), str(tmp / "main.cpp"), "-o", str(exe)],
                   check=True, capture_output=True, timeout=600)
    return exe


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("dim", [33, 40, 64, 65, 96, 97, 128])
def test_kernel_warp_body_is_the_plain_version(wide_host, dim, dtype):
    """The wide kernel's warp body (its loads, the coefficients' reduction
    KC at a time across the lanes, the update, the norm) run as host C++ on
    two bases bitwise gram_schmidt_plain, at each rows-a-lane bucket and its
    edges, in float32 and float64."""
    n = 2
    x = np.random.default_rng(dim).standard_normal((n, dim, dim)).astype(dtype)
    head = np.array([dim, n, np.dtype(dtype).itemsize], np.int32).tobytes()
    out = subprocess.run([str(wide_host)], input=head + x.tobytes(), capture_output=True,
                         check=True, timeout=600).stdout
    got = np.frombuffer(out, dtype).reshape(n, dim, dim)
    want = pallas_dirs.gram_schmidt_plain(torch.as_tensor(x.transpose(1, 2, 0)[None].copy()))
    np.testing.assert_array_equal(got, want.numpy()[0].transpose(2, 0, 1))


# ------------------------------------------------------ the studies' texts
def test_wide_times_variants_patch_this_source():
    """experiments/gs_wide_times.py's variants find their text in this
    checkout: the long path's dispatch and scratch lowered to dim 32, the
    bases a block fixed, the coefficients a chunk fixed (in the header)."""
    root = gs_wide_times.HERE
    tree = gs_wide_times.variant_source("tree", root)
    long33 = gs_wide_times.variant_source("long33", root)
    assert "if (dim > GS_MAXD)\n        return gram_schmidt_long(" in long33
    assert "if (dim <= GS_MAXD) return 0;" in long33 and long33 != tree
    assert "(1 << x) <= 4" in gs_wide_times.variant_source("w4", root)
    head = gs_wide_times.header_source("kc16", root, "gram_schmidt_wide.cuh")
    assert "static constexpr int KC = 16;" in head
    assert gs_wide_times.header_source("tree", root, "gram_schmidt_wide.cuh") != head
    assert gs_wide_times.variant_source("parent", root).endswith(gs_wide_times.PARENT_PROBE)


def test_ptxas_parity_counts_the_narrow_kernels_as_d32():
    """experiments/ptxas_parity.py holds B2's thread-per-basis kernels (dims
    1 to 32) among the D <= 32 kernels that must keep their report, and
    neither the wide nor the long kernel."""
    assert ptxas_parity.in_d32("gram_schmidt", "_Z19gram_schmidt_kernelIfLi20ELi32EEvPKT_PS0_i")
    assert ptxas_parity.in_d32("gram_schmidt", "_Z19gram_schmidt_kernelIdLi32ELi16EEvPKT_PS0_i")
    assert not ptxas_parity.in_d32("gram_schmidt",
                                   "_Z24gram_schmidt_wide_kernelIfLi2EEvPKT_PS0_iii")
    assert not ptxas_parity.in_d32("gram_schmidt", "_Z24gram_schmidt_long_kernelIfEvPT_S1_iiii")
