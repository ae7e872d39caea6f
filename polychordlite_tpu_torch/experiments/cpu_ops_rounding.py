"""Which elementwise torch operation rounds differently on the host's CPU
than on the card: the comparison behind the plain versions held to a
kernel bit for bit (B2's, the fused route's) taking their square root from
numpy on the CPU (``ops/precision.py::sqrt_rn``).

    python -m polychordlite_tpu_torch.experiments.cpu_ops_rounding [n]

For float32 and float64, ``n`` inputs (default 2**22) made from a seed with
numpy, in the ranges Gram-Schmidt feeds each operation: products and sums
of unit-scale values, quotients by a norm, square roots of sums of
squares.  Each operation runs in torch on the CPU, in torch on the card
(when there is one) and in numpy (the processor's own instructions, each
rounded to nearest); prints one JSON line with the entries that differ,
CPU torch against numpy and against the card, and the card against numpy.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch


def operands(n: int, dtype, seed: int = 0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(n).astype(dtype)
    b = rng.standard_normal(n).astype(dtype)
    norm = (rng.random(n) * 300.0 + 1e-3).astype(dtype)  # a sum of squares
    return a, b, norm


OPS = {"mul": (lambda x, y: x * y, 2), "add": (lambda x, y: x + y, 2),
       "sub": (lambda x, y: x - y, 2), "div": (lambda x, y: x / y, 2),
       "sqrt": (None, 1)}


def compare(n: int = 1 << 22) -> dict:
    cuda = torch.cuda.is_available()
    out = {"n": n, "card": torch.cuda.get_device_name(0) if cuda else None,
           "torch": torch.__version__, "cpu_capability": torch.backends.cpu.get_cpu_capability()}
    for dtype in (np.float32, np.float64):
        a, b, norm = operands(n, dtype)
        res = {}
        for name, (fn, arity) in OPS.items():
            if name == "sqrt":
                ref = np.sqrt(norm)
                cpu = torch.sqrt(torch.from_numpy(norm)).numpy()
                dev = torch.sqrt(torch.from_numpy(norm).cuda()).cpu().numpy() if cuda else None
            else:
                y = np.abs(b) + 0.5 if name == "div" else b
                ref = fn(a, y)
                cpu = fn(torch.from_numpy(a), torch.from_numpy(y)).numpy()
                dev = (fn(torch.from_numpy(a).cuda(), torch.from_numpy(y).cuda()).cpu().numpy()
                       if cuda else None)
            res[name] = {"cpu_vs_numpy": int((cpu != ref).sum()),
                         "cpu_vs_card": None if dev is None else int((cpu != dev).sum()),
                         "card_vs_numpy": None if dev is None else int((dev != ref).sum())}
        out[np.dtype(dtype).name] = res
    return out


if __name__ == "__main__":
    print(json.dumps(compare(*(int(x) for x in sys.argv[1:]))))
