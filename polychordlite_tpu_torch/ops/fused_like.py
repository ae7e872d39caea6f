"""A torch likelihood lowered into B1's kernel: the fused route
(counterpart of ``polychordlite_tpu/ops/pallas_slice.py::_validated_tile_logL``,
the JAX package's in-kernel likelihood adapter, ``pallas_slice.py:125-175``).

The JAX v4 kernel evaluates any traced jnp likelihood inside its body
(``pallas_slice_v4.py:266``).  The port does the same for a torch model
without a hand-written functor: :func:`lower` traces the calc's own prior
and likelihood, lowers the trace to a small IR, and that IR has two
consumers, so that they cannot drift apart:

* :meth:`Lowered.plain_logL` interprets it in torch, in the lowering's
  dtype, one rounded operation at a time, reductions in the kernel's order
  (below): the kernel's plain version;
* :meth:`Lowered.emit_functor` writes it as C++ for B1's two-stage functor
  interface (``csrc/likelihoods.cuh``), which ``csrc/slice_epoch_fused.cu``
  instantiates (``ops/pallas_slice_v4.py::slice_epoch_fused``).

**Trace.**  ``make_fx`` in fake mode, from one cube ``(D,)`` to ``logL ()``:
the model's per-point function for a per-point calc, the batched one
applied to ``cube[None]`` for a batched calc.  Derived outputs are dropped
(theta and phi are recomputed from the accepted cubes after the kernel, as
the JAX package does).  A prior with an ``affine`` descriptor stays B1's
``AffinePrior`` and the trace starts at theta; any other prior (the
``GaussianPrior``'s erfinv) is lowered into the body.  The wall, the clamp
and NaN -> logzero stay the kernel's (``like_result``).

**Op table.**  Over static shapes, a value that is not a constant holding at
most :data:`MAX_ELEMENTS` elements (the largest D of any bucket) and a
constant at most ``MAX_ELEMENTS**2`` (the (D, D) matrix): elementwise arithmetic and
comparisons, ``neg``, ``abs``, ``pow``; ``exp``, ``log``, ``log1p``, ``expm1``,
``sqrt``, ``rsqrt``, ``sin``, ``cos``, ``tanh``, ``erfinv``, ``ndtri``;
``where``, ``clamp``, ``maximum``, ``minimum``; ``sum``, ``mean``,
``amax``, ``logsumexp``; ``select``, ``slice``, ``view``, ``unsqueeze``,
``squeeze``, ``expand``, ``permute``, ``cat``, ``stack``, ``_to_copy``;
``mv``, ``mm``, ``dot``.  An op whose inputs are all constants is evaluated
once, here (a matrix inverted inside the likelihood becomes a constant).
Anything else refuses lowering with the op's name as the reason (:class:`Refused`),
as do data-dependent control flow, a larger shape, a dtype other than the
lowering's (float32, or float64 below) or bool, and a D past the stream
bucket's bound for the lowering's terms and dtype
(``pallas_slice_v4.stream_max_d``: the chain's (2 + NT) D values must fit a
block's shared memory).  The header names the kernel template's dimension
bucket of D (``FUSED_MAXD``: 32; 128, where the combine reads the terms
staged in shared memory; or ``SLICE_MAXD_STREAM`` above 128, where the
chain's x0 and n̂ live there too and the prior comes by pointer,
``csrc/slice_epoch.cuh``).

**IR.**  Statement lists over references (below).  ``term`` is the
per-coordinate chain, evaluated for coordinate d on the lane that owns it;
the values it hands on are ``exports`` (``T[j][d]``).  ``combine`` is
everything else, scalarised at the static D: the ordered sums and the scalar
tail; a graph that couples coordinates exports the coordinate and keeps its
body here.  Up to D = 32 a reduction (``sum``, ``mean``, ``amax``,
``logsumexp``) is a chain in index order, one statement a coordinate.
Above, where a chain holds the 32 lanes of a warp, a reduction over the
coordinate axis of an export is one statement, ``lane_add`` or
``lane_max`` of an item: an export, or a ``lane`` statement, the third
list, per-coordinate statements of a reduction's items that may read the
combine's scalars (logsumexp's exp(x - max)).  The kernel folds it in the
lane order (``csrc/likelihoods.cuh::fold`` on a lane view: each lane its own
coordinates in index order, then a butterfly of shuffles) and the plain
version repeats that order (``models/examples.py::coordinate_fold``);
products that couple coordinates (``mv``, ``mm``, ``dot``) and reductions
over anything else keep the chain.  Model constants (captured tensors and
numbers) are slots of one buffer of the lowering's dtype, never in the
source, so the source — and its hash, the library's name — depends on the
graph only.

**Validation** before a run uses it: :func:`lower` holds ``plain_logL``
against the calc's own logL on ``ops/evaluate.py``'s probe cubes at the
model-form tolerance (rtol 1e-5, atol 1e-6; the JAX package accepts its tile
path at 1e-4) and refuses on a mismatch; on the card,
``pallas_slice_v4.validate_fused`` holds the kernel bitwise against
``plain_logL`` and raises on a mismatch.

**float64.**  A calc made at ``precision='highest'`` (``calc.dtype``) is
lowered in float64: the trace, the constants, the literals and the plain
version in float64, and the functor emitted in double (``__dadd_rn`` for
``__fadd_rn``, ``exp`` for ``expf``, ...; the dtype is in the source and so
in the library's name).  The prior is always lowered into the body there:
the ``affine`` descriptors of ``priors.py`` hold float32 values.  ``erfinv``
and ``ndtri`` are refused (``csrc/fused_ops.cuh`` has float32 sequences
only), so a model with them takes the traced route.  :func:`lower` holds
the plain version to the calc at rtol = atol = 1e-12 (:data:`F64_TOL`): the
two differ only in the order of sums.
"""

from __future__ import annotations

import hashlib
import operator
import time
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..models.examples import coordinate_fold
from ..utils import nvcc
from .evaluate import probe_cubes, same_values
from .pallas_slice_v4 import SLICE_MAXD, SLICE_MAXD_WIDE, stream_max_d
from .precision import calc_dtype, sqrt_rn

#: the most elements of a value that is not a constant — the largest D of any
#: bucket, the stream bucket's in float32 at one term — and of a constant
MAX_ELEMENTS = stream_max_d(1, torch.float32)
MAX_CONST_ELEMENTS = MAX_ELEMENTS * MAX_ELEMENTS
SOURCE = "slice_epoch_fused.cu"
#: the float64 lowering's tolerance against the calc (rtol, atol)
F64_TOL = (1e-12, 1e-12)
#: the dtypes a lowering takes
DTYPES = (torch.float32, torch.float64)

# A reference is a tuple:
#   ("x",)        the coordinate's theta (term only)
#   ("p", i)      term statement i
#   ("t", j, d)   export j of coordinate d (combine only)
#   ("s", i)      combine statement i
#   ("c", k)      constant slot k
#   ("cv", k)     constant slots k .. k + D - 1, slot k + d for coordinate d (term only)
#   ("k", v)      a literal of an op's own definition (not a model value), in the
#                 lowering's dtype
#   ("o", j)      export j of the lane's own coordinate (lane statements and the
#                 item of a lane reduction)
#   ("q", i)      lane statement i
# A statement is (op, args), its value the reference of its position; the
# operations are the keys of PLAIN and "f32", a boolean as a real of the
# lowering's dtype (float32 in the name only); and in the combine above D = 32
# the keys of LANE_OPS, a reduction over the coordinates of its one argument.
BOOL_OPS = frozenset(("lt", "le", "gt", "ge", "eq", "ne"))
#: the lane reductions (above D = 32) and the binary operation each folds with
LANE_OPS = {"lane_add": "add", "lane_max": "max"}
#: float operations per IR statement, for the kernels' bound (the quantile's
#: rational approximation ~30, a library call ~20)
OP_COST = {"erfinv": 24, "ndtri": 28, "pow": 20, "exp": 20, "log": 20, "log1p": 20,
           "expm1": 20, "sin": 20, "cos": 20, "tanh": 20, "sqrt": 1}


class Refused(Exception):
    """The model cannot be lowered; ``reason`` names the op or condition."""

    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


# ------------------------------------------------------------------ plain
_LITERALS: Dict[Tuple[float, str], torch.Tensor] = {}


def _lit(v: float, device, dtype=torch.float32) -> torch.Tensor:
    """A 0-d tensor of ``dtype`` on ``device``: every operand of the plain
    version is a tensor, so no division becomes a multiplication by a host
    scalar's reciprocal."""
    key = (float(v), str(device), dtype)
    if key not in _LITERALS:
        _LITERALS[key] = torch.tensor(v, dtype=dtype, device=device)
    return _LITERALS[key]


def _where_max(a, b):
    return torch.where(a != a, a, torch.where(b != b, b, torch.where(a > b, a, b)))


def _where_min(a, b):
    return torch.where(a != a, a, torch.where(b != b, b, torch.where(a < b, a, b)))


def _hexes(*hs):
    return [float.fromhex(h) for h in hs]


# the coefficients of csrc/fused_ops.cuh, the same float32 values
_GILES_CENTRE = _hexes("0x1.e2cb1p-26", "0x1.70966cp-22", "-0x1.d8e6aep-19", "-0x1.26b582p-18",
                       "0x1.ca65b6p-13", "-0x1.48a81p-10", "-0x1.11c9dep-8", "0x1.f91ec6p-3",
                       "0x1.805c5ep+0")
_GILES_TAIL = _hexes("-0x1.a3e136p-13", "0x1.a76ad6p-14", "0x1.61b8e4p-10", "-0x1.e17bcep-9",
                     "0x1.7824f6p-8", "-0x1.f38baep-8", "0x1.354afcp-7", "0x1.006db6p+0",
                     "0x1.6a9efcp+1")
_ACKLAM_C = _hexes("-0x1.fe30dap-8", "-0x1.4a224cp-2", "-0x1.334c0cp+1", "-0x1.465da2p+1",
                   "0x1.17fa8p+2", "0x1.7815c2p+1")
_ACKLAM_D = _hexes("0x1.fe2d86p-8", "0x1.4a34d2p-2", "0x1.38fa28p+1", "0x1.e09076p+1", "0x1p+0")
_P_LOW = float.fromhex("0x1.8d4fep-6")
_SQRT2 = float.fromhex("0x1.6a09e6p+0")


def _horner(coef, t):
    """c0 t^n + ... as fused_ops.cuh writes it: v = v t + c."""
    v = _lit(coef[0], t.device)
    for c in coef[1:]:
        v = torch.add(torch.mul(v, t), _lit(c, t.device))
    return v


def _giles(x, y):
    """``fused_giles``: both polynomials, the one for w chosen."""
    w = torch.neg(torch.log(y))
    centre = _horner(_GILES_CENTRE, torch.sub(w, _lit(2.5, x.device)))
    tail = _horner(_GILES_TAIL, torch.sub(sqrt_rn(w), _lit(3.0, x.device)))
    return torch.mul(torch.where(w < 5.0, centre, tail), x)


def _tail(p):
    t = sqrt_rn(torch.mul(_lit(-2.0, p.device), torch.log(p)))
    return torch.div(_horner(_ACKLAM_C, t), _horner(_ACKLAM_D, t))


def _erfinv(x):
    """``fused_erfinv`` of ``csrc/fused_ops.cuh``, step for step."""
    one = _lit(1.0, x.device)
    r = _giles(x, torch.mul(torch.sub(one, x), torch.add(one, x)))
    return torch.where(torch.abs(x) == 1.0, torch.mul(x, _lit(float("inf"), x.device)), r)


def _ndtri(p):
    """``fused_ndtri`` of ``csrc/fused_ops.cuh``, step for step."""
    dev = p.device
    one, two = _lit(1.0, dev), _lit(2.0, dev)
    q = torch.sub(one, p)
    tp = torch.mul(two, p)
    x = torch.mul(_giles(torch.sub(tp, one), torch.mul(tp, torch.sub(two, tp))),
                  _lit(_SQRT2, dev))
    x = torch.where(q < _P_LOW, torch.neg(_tail(q)), x)
    x = torch.where(p < _P_LOW, _tail(p), x)
    x = torch.where(p == 1.0, _lit(float("inf"), dev), x)
    return torch.where(p == 0.0, _lit(float("-inf"), dev), x)


PLAIN = {
    "add": torch.add, "sub": torch.sub, "mul": torch.mul, "div": torch.div,
    "max": _where_max, "min": _where_min, "pow": torch.pow,
    "lt": torch.lt, "le": torch.le, "gt": torch.gt, "ge": torch.ge, "eq": torch.eq,
    "ne": torch.ne, "where": torch.where, "neg": torch.neg, "abs": torch.abs,
    "exp": torch.exp, "log": torch.log, "log1p": torch.log1p, "expm1": torch.expm1,
    "sqrt": sqrt_rn, "sin": torch.sin, "cos": torch.cos, "tanh": torch.tanh,
    "erfinv": _erfinv, "ndtri": _ndtri,
}

# ------------------------------------------------------------------ C++
_C_CALL = {
    "add": "__fadd_rn", "sub": "__fsub_rn", "mul": "__fmul_rn", "div": "__fdiv_rn",
    "max": "fused_max", "min": "fused_min", "pow": "fused_powf", "abs": "fabsf",
    "exp": "expf", "log": "logf", "log1p": "log1pf", "expm1": "expm1f", "sqrt": "sqrtf",
    "sin": "fused_sinf", "cos": "fused_cosf", "tanh": "tanhf", "erfinv": "fused_erfinv",
    "ndtri": "fused_ndtri",
}
#: the calls of a double functor (no erfinv or ndtri: refused at float64)
_C_CALL_F64 = {
    "add": "__dadd_rn", "sub": "__dsub_rn", "mul": "__dmul_rn", "div": "__ddiv_rn",
    "max": "fused_max", "min": "fused_min", "pow": "fused_pow", "abs": "fabs",
    "exp": "exp", "log": "log", "log1p": "log1p", "expm1": "expm1", "sqrt": "sqrt",
    "sin": "fused_sin", "cos": "fused_cos", "tanh": "tanh",
}
_C_INFIX = {"lt": "<", "le": "<=", "gt": ">", "ge": ">=", "eq": "==", "ne": "!="}
#: the C++ type of each dtype
_C_TYPE = {torch.float32: "float", torch.float64: "double"}


def _c_float(v: float, dtype=torch.float32) -> str:
    """A literal of ``dtype``: float32 (suffix f) or float64, in hex."""
    if dtype == torch.float32:
        v = float(np.float32(v))
    if np.isinf(v):
        return "INFINITY" if v > 0 else "(-INFINITY)"
    return f"{v.hex()}f" if dtype == torch.float32 else v.hex()


def _c_stmt(op: str, a: List[str], dtype=torch.float32) -> str:
    if op in _C_INFIX:
        return f"({a[0]} {_C_INFIX[op]} {a[1]})"
    if op == "where":
        return f"({a[0]} ? {a[1]} : {a[2]})"
    if op == "neg":
        return f"(-{a[0]})"
    if op == "f32":
        return f"({a[0]} ? 1.0f : 0.0f)" if dtype == torch.float32 else f"({a[0]} ? 1.0 : 0.0)"
    calls = _C_CALL if dtype == torch.float32 else _C_CALL_F64
    return f"{calls[op]}({', '.join(a)})"


# ------------------------------------------------------------------ the IR
@dataclass
class Lowered:
    """A model lowered for B1: the IR (module docstring), its constants and
    the prior's affine form ``(a, s)`` (the identity when the prior was
    lowered into the body)."""

    n_dims: int
    prior: Tuple[np.ndarray, np.ndarray]
    consts: np.ndarray
    term: List[tuple]
    exports: List[tuple]
    combine: List[tuple]
    out: tuple
    logzero: float
    prior_lowered: bool
    #: the dtype of the plain version and the kernel: float32, or float64 for
    #: a calc made at precision='highest'
    dtype: torch.dtype = torch.float32
    #: the lane statements (above D = 32: the items of the lane reductions)
    lane: List[tuple] = field(default_factory=list)
    #: seconds each group size's library took to build (or load) in this
    #: process, by G (another engine's by "G/<engine>": "G/ring", "G/cuda5")
    build_seconds: Dict[object, float] = field(default_factory=dict)
    _device_consts: Dict[str, torch.Tensor] = field(default_factory=dict, repr=False)

    @property
    def n_terms(self) -> int:
        return len(self.exports)

    def flops_per_probe(self) -> int:
        """Floating operations (of :attr:`dtype`) of one probe: the probe and the prior's affine
        map (4 per coordinate), the per-coordinate chain D times, the
        combine, and the machine's ~7."""
        def cost(stmts):
            return sum(OP_COST.get(op, 1) for op, _ in stmts)
        per_coordinate = cost(self.term) + cost(self.lane) + sum(
            op in LANE_OPS for op, _ in self.combine)
        return 4 * self.n_dims + self.n_dims * per_coordinate + cost(self.combine) + 7

    def device_consts(self, device) -> torch.Tensor:
        """The constant buffer on ``device``, made once: the slots, then the
        prior's a and s (which the plain version reads; the kernel takes the
        prior as its AffinePrior up to D = 128, and reads it there, through
        :meth:`device_prior`, in the stream bucket)."""
        key = str(device)
        if key not in self._device_consts:
            self._device_consts[key] = torch.tensor(
                np.concatenate([self.consts, *self.prior]), dtype=self.dtype, device=device)
        return self._device_consts[key]

    def device_prior(self, device) -> torch.Tensor:
        """[a (D), s (D)]: the tail of :meth:`device_consts`, a view."""
        return self.device_consts(device)[len(self.consts):]

    @property
    def bucket_macro(self) -> str:
        """The header's FUSED_MAXD: the kernel template's bucket of D."""
        if self.n_dims <= SLICE_MAXD:
            return str(SLICE_MAXD)
        return str(SLICE_MAXD_WIDE) if self.n_dims <= SLICE_MAXD_WIDE else "SLICE_MAXD_STREAM"

    # ---- the plain version
    def plain_logL(self, cube: torch.Tensor) -> torch.Tensor:
        """logL (B,) of :attr:`dtype` of the probes ``cube (B, D)`` with the
        kernel's semantics: theta = cube s + a, the IR's operations in torch
        one at a time, a NaN as logzero, a probe outside [0, 1]^D as
        logzero."""
        dev, D, dt = cube.device, self.n_dims, self.dtype
        c = self.device_consts(dev)
        a, s = c[-2 * D:-D], c[-D:]
        p = cube.to(dt)
        inside = ((p >= 0.0) & (p <= 1.0)).all(dim=1)
        x = torch.add(torch.mul(p, s), a)
        vals: List[torch.Tensor] = []

        def apply(op, args):
            return args[0].to(dt) if op == "f32" else PLAIN[op](*args)

        def term_arg(ref):
            kind = ref[0]
            if kind == "x":
                return x
            if kind == "p":
                return vals[ref[1]]
            if kind == "c":
                return c[ref[1]]
            if kind == "cv":
                return c[ref[1]:ref[1] + D]
            return _lit(ref[1], dev, dt)

        for op, args in self.term:
            vals.append(apply(op, [term_arg(r) for r in args]))
        T = [term_arg(r) for r in self.exports]
        svals: List[torch.Tensor] = []
        lvals: Dict[int, torch.Tensor] = {}

        def comb_arg(ref):
            kind = ref[0]
            if kind == "t":
                return T[ref[1]][:, ref[2]]
            if kind == "s":
                return svals[ref[1]]
            if kind == "c":
                return c[ref[1]]
            return _lit(ref[1], dev, dt)

        def lane_arg(ref):  # a (B, D) value, or one that broadcasts to it
            kind = ref[0]
            if kind == "o":
                return T[ref[1]]
            if kind == "q":
                i = ref[1]
                if i not in lvals:
                    op, args = self.lane[i]
                    lvals[i] = apply(op, [lane_arg(r) for r in args])
                return lvals[i]
            v = comb_arg(ref)
            return v[:, None] if v.dim() == 1 else v

        for op, args in self.combine:
            if op in LANE_OPS:
                items = lane_arg(args[0]).expand(p.shape[0], D)
                svals.append(coordinate_fold(items, PLAIN[LANE_OPS[op]], D))
            else:
                svals.append(apply(op, [comb_arg(r) for r in args]))
        out = comb_arg(self.out).expand(p.shape[0])
        logzero = _lit(self.logzero, dev, dt)
        out = torch.where(torch.isnan(out), logzero, out)
        return torch.where(inside, out, logzero)

    # ---- the kernel
    def emit_functor(self) -> str:
        """The C++ functor ``FusedLike`` with B1's two-stage interface, in
        float or (at float64) double."""
        dt, real = self.dtype, _C_TYPE[self.dtype]

        def ref_c(ref):
            kind = ref[0]
            if kind == "x":
                return "x"
            if kind == "o":
                return f"o[{ref[1]}]"
            if kind in ("p", "s", "q"):
                return f"{kind}{ref[1]}"
            if kind == "t":
                return f"T[{ref[1]}][{ref[2]}]"
            if kind == "c":
                return f"__ldg(c + {ref[1]})"
            if kind == "cv":
                return f"__ldg(c + {ref[1]} + d)"
            return _c_float(ref[1], dt)

        def stmt(prefix, i, op, args, indent="        "):
            return (f"{indent}const {'bool' if op in BOOL_OPS else real} {prefix}{i} = "
                    f"{_c_stmt(op, [ref_c(r) for r in args], dt)};")

        def body(stmts, prefix):
            return [stmt(prefix, i, op, args) for i, (op, args) in enumerate(stmts)]

        def fold_stmt(i, op, item):
            """A lane reduction: a fold over the item's statements, which the
            view of the terms runs in the lane order."""
            need = set()

            def mark(ref):
                if ref[0] == "q" and ref[1] not in need:
                    need.add(ref[1])
                    for r in self.lane[ref[1]][1]:
                        mark(r)

            mark(item)
            fold = _c_stmt(LANE_OPS[op], ["u", "v"], dt)
            return [f"        const {real} s{i} = fold(",
                    f"            T, D, [&](const {real}* o, int d) {{",
                    "                (void)d;",
                    *[stmt("q", q, *self.lane[q], indent="                ")
                      for q in sorted(need)],
                    f"                return {ref_c(item)};",
                    f"            }}, []({real} u, {real} v) {{ return {fold}; }});"]

        term = body(self.term, "p") + [f"        out[{j}] = {ref_c(r)};"
                                       for j, r in enumerate(self.exports)]
        if self.n_dims > SLICE_MAXD:  # the lane order (csrc/likelihoods.cuh)
            combine = []
            for i, (op, args) in enumerate(self.combine):
                combine += (fold_stmt(i, op, args[0]) if op in LANE_OPS
                            else [stmt("s", i, op, args)])
            combine += [f"        return {ref_c(self.out)};"]
            staged = any(r[0] == "t" for _, args in self.combine for r in args)
            lanes = [f"    static constexpr bool STAGED = {str(staged).lower()};"]
            signature = ["    template <class TT>",
                         f"    __device__ __forceinline__ {real} combine(const TT& T, int D) const {{",
                         "        (void)T;",
                         "        (void)D;"]
        else:
            combine = body(self.combine, "s") + [f"        return {ref_c(self.out)};"]
            lanes = []
            signature = ["    template <class TT>",
                         f"    __device__ __forceinline__ {real} combine(const TT& T, int) const {{"]
        if self.n_dims > SLICE_MAXD_WIDE:  # the stream bucket: by pointer
            prior = f"    DevicePriorT<{real}> prior;"
        elif dt == torch.float32:
            prior = "    AffinePriorT<MAXD> prior;"
        else:
            prior = f"    AffinePriorT<MAXD, {real}> prior;"
        return "\n".join([
            "struct FusedLike {",
            "    static constexpr int MAXD = FUSED_MAXD;",
            prior,
            f"    const {real}* __restrict__ c;  // the model's constants (device)",
            f"    {real} logzero;",
            f"    static constexpr int NT = {self.n_terms};",
            *lanes,
            "",
            f"    __device__ __forceinline__ void term({real} x, int d, {real}* out) const {{",
            "        (void)d;",
            *term,
            "    }",
            *signature,
            *combine,
            "    }",
            "};",
        ])

    def source(self, group: int, engine: str = "cuda", ring: bool = False) -> str:
        """The generated header ``fused_like.cuh`` for ``group`` lanes per
        chain and ``engine``'s library (:data:`ENGINE_DEFINES`): ``"cuda"``,
        B1's; ``"ring"`` (or ``ring=True``), the ring engine's
        (``FUSED_RING``: its entry is ``slice_epoch_fused_ring_launch``);
        ``"cuda5"``, ``"cuda3"``, ``"cuda2"``, the forced engines' B3, B4
        and B5 (``slice_epoch_fused_v5_launch`` and so on)."""
        define = ENGINE_DEFINES[_engine(engine, ring)]
        return "\n".join([
            "// Generated by polychordlite_tpu_torch/ops/fused_like.py from a model's",
            "// torch trace; built by slice_epoch_fused.cu.  Do not edit.",
            "#pragma once",
            f"#define FUSED_D {self.n_dims}",
            f"#define FUSED_MAXD {self.bucket_macro}",
            f"#define FUSED_G {group}",
            f"#define FUSED_NC {len(self.consts)}",
            *([f"#define {define} 1"] if define else []),
            "",
            self.emit_functor(),
            "",
        ])

    def key(self, group: int, engine: str = "cuda", ring: bool = False) -> str:
        """A hash of :meth:`source`: the graph, G and the engine, not the constants."""
        return hashlib.sha256(self.source(group, engine, ring).encode()).hexdigest()[:16]

    def library_name(self, group: int, engine: str = "cuda", ring: bool = False) -> str:
        engine = _engine(engine, ring)
        return f"slice_epoch_fused_{ENGINE_PREFIX[engine]}{self.key(group, engine)}"

    def build(self, groups, engine: str = "cuda", ring: bool = False) -> None:
        """Build (or load) ``engine``'s libraries of ``groups``, one nvcc
        each, all started together; their seconds go to
        :attr:`build_seconds` by G, or by ``"G/<engine>"`` for another
        engine than ``"cuda"`` (``"G/ring"``; 0 for a library this process
        had loaded already)."""
        engine = _engine(engine, ring)
        names = {G: self.library_name(G, engine) for G in groups}
        loaded = {G for G, n in names.items() if nvcc.is_loaded(n)}
        nvcc.build_all({n: [SOURCE] for n in names.values()},
                       headers={names[G]: self.source(G, engine) for G in names})
        for G, n in names.items():
            self.build_seconds.setdefault(_seconds_key(G, engine),
                                          0.0 if G in loaded else nvcc.build_seconds[n])

    def library(self, group: int, engine: str = "cuda", ring: bool = False):
        """``engine``'s library of ``group`` lanes per chain, built at first use."""
        engine = _engine(engine, ring)
        name = self.library_name(group, engine)
        t0 = time.perf_counter()
        lib = nvcc.load(name, [SOURCE], header=self.source(group, engine))
        self.build_seconds.setdefault(_seconds_key(group, engine), time.perf_counter() - t0)
        return lib


#: the define that picks each engine's entry of ``csrc/slice_epoch_fused.cu``
#: in the generated header (none for B1's)
ENGINE_DEFINES = {"cuda": None, "ring": "FUSED_RING", "cuda5": "FUSED_V5",
                  "cuda3": "FUSED_V3", "cuda2": "FUSED_V2"}
#: ... and the prefix of its libraries' names
ENGINE_PREFIX = {"cuda": "", "ring": "ring_", "cuda5": "v5_", "cuda3": "v3_", "cuda2": "v2_"}


def _engine(engine: str, ring: bool) -> str:
    """The engine of a library: ``engine``, or ``"ring"`` for ``ring=True``."""
    engine = "ring" if ring else engine
    if engine not in ENGINE_DEFINES:
        raise ValueError(f"no fused library for engine {engine!r}; have {tuple(ENGINE_DEFINES)}")
    return engine


def _seconds_key(group: int, engine: str):
    return group if engine == "cuda" else f"{group}/{engine}"


# ------------------------------------------------------------------ lowering
class _Val:
    """A value of the trace: a constant (a real tensor), a per-coordinate
    value (``pc``, a term reference, flat index d = coordinate d), or an
    array of scalar references (``els``)."""

    __slots__ = ("shape", "const", "pc", "els", "boolean", "scalar_slot", "vec_slot")

    def __init__(self, shape, const=None, pc=None, els=None, boolean=False):
        self.shape = tuple(shape)
        self.const, self.pc, self.els, self.boolean = const, pc, els, boolean
        self.scalar_slot = self.vec_slot = None

    @property
    def numel(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64))


#: view and shape ops: they move no value; a per-coordinate value stays one
#: where the flat order is kept
_RESHAPES = ("view", "_unsafe_view", "reshape", "unsqueeze", "squeeze", "squeeze_", "clone",
             "alias", "detach", "contiguous", "lift_fresh_copy", "_to_copy")
_PERMUTES = ("permute", "t", "transpose")
#: factories: their tensor argument lends only its dtype, device (or shape)
_FACTORIES = ("new_full", "new_zeros", "new_ones", "full_like", "zeros_like", "ones_like")
_COMPARE = {"lt": "lt", "le": "le", "gt": "gt", "ge": "ge", "eq": "eq", "ne": "ne"}
_UNARY = {"neg": "neg", "abs": "abs", "exp": "exp", "log": "log", "log1p": "log1p",
          "expm1": "expm1", "sqrt": "sqrt", "sin": "sin", "cos": "cos", "tanh": "tanh",
          "erfinv": "erfinv", "special_ndtri": "ndtri"}
_BINARY = {"add": "add", "sub": "sub", "mul": "mul", "div": "div", "maximum": "max",
           "minimum": "min", **_COMPARE}
#: the op table: the aten packets lowered on values that are not constants
TABLE = frozenset(_RESHAPES + _PERMUTES + tuple(_UNARY) + tuple(_BINARY) + (
    "rsub", "rsqrt", "reciprocal", "where", "clamp", "clamp_min", "clamp_max", "pow",
    "expand", "select", "slice", "cat", "stack", "sum", "mean", "amax", "logsumexp",
    "mv", "mm", "dot"))
ONE, ZERO, INF = ("k", 1.0), ("k", 0.0), ("k", float("inf"))


def _pow_int(em, x, n: int):
    """x ** n for an integer n != 0 by repeated squaring from the top bit."""
    if n < 0:
        return em("div", ONE, _pow_int(em, x, -n))
    r = x
    for bit in bin(n)[3:]:
        r = em("mul", r, r)
        if bit == "1":
            r = em("mul", r, x)
    return r


class _Lowering:
    def __init__(self, gm, n_dims: int, device, dtype=torch.float32):
        self.gm, self.D, self.device, self.dtype = gm, n_dims, device, dtype
        self.consts: List[float] = []
        self.term: List[tuple] = []
        self.combine: List[tuple] = []
        self.lane: List[tuple] = []
        self.exports: List[tuple] = []
        self.export_bool: List[bool] = []

    # ---- slots and statements
    def slots(self, values) -> int:
        k = len(self.consts)
        np_dtype = np.float32 if self.dtype == torch.float32 else np.float64
        self.consts.extend(float(v) for v in np.asarray(values, np_dtype).ravel())
        return k

    def em_term(self, op, *args):
        self.term.append((op, args))
        return ("p", len(self.term) - 1)

    def em_comb(self, op, *args):
        self.combine.append((op, args))
        return ("s", len(self.combine) - 1)

    def em_lane(self, op, *args):
        self.lane.append((op, args))
        return ("q", len(self.lane) - 1)

    def lane_export(self, items):
        """j where ``items`` are export j of coordinates 0 .. D-1 in order and
        D > 32 (a reduction the lane order takes), else None."""
        if self.D <= SLICE_MAXD or len(items) != self.D:
            return None
        first = items[0]
        if not (isinstance(first, tuple) and first[0] == "t"):
            return None
        j = first[1]
        return j if all(r == ("t", j, d) for d, r in enumerate(items)) else None

    def elements(self, v: _Val) -> np.ndarray:
        """The value as an array of combine references."""
        if v.els is not None:
            return v.els
        if v.const is not None:
            if v.const.dtype == torch.bool:
                raise Refused("a boolean constant")
            k = self.slots(v.const.detach().cpu().numpy())
            refs = [("c", k + i) for i in range(v.numel)]
            if v.numel > MAX_ELEMENTS and v.const.dim() != 2:
                raise Refused(f"a constant of shape {v.shape} used elementwise")
        else:  # a per-coordinate value: export it
            j = len(self.exports)
            if v.boolean:  # exported as 0/1, compared back
                self.exports.append(self.em_term("f32", v.pc))
                refs = [self.em_comb("ne", ("t", j, d), ZERO) for d in range(self.D)]
            else:
                self.exports.append(v.pc)
                refs = [("t", j, d) for d in range(self.D)]
        els = np.empty(len(refs), object)
        for i, r in enumerate(refs):  # one by one: numpy would unpack the tuples
            els[i] = r
        v.els = els.reshape(v.shape)
        return v.els

    def term_arg(self, o):
        """A term reference for an operand of a per-coordinate statement."""
        if not isinstance(o, _Val):
            return ("c", self.slots([o]))
        if o.pc is not None:
            return o.pc
        if o.numel == 1:
            if o.scalar_slot is None:
                o.scalar_slot = ("c", self.slots(o.const.detach().cpu().numpy()))
            return o.scalar_slot
        if o.vec_slot is None:
            o.vec_slot = ("cv", self.slots(o.const.detach().cpu().numpy()))
        return o.vec_slot

    # ---- the walk
    def run(self):
        env: Dict[object, object] = {}
        out = None
        for node in self.gm.graph.nodes:
            if node.op == "placeholder":
                env[node] = _Val((self.D,), pc=("x",))
            elif node.op == "get_attr":
                t = getattr(self.gm, node.target)
                env[node] = _Val(t.shape, const=t)
            elif node.op == "call_function":
                env[node] = self.call(node, env)
            elif node.op == "output":
                (res,) = node.args[0] if isinstance(node.args[0], (tuple, list)) else (node.args[0],)
                v = env[res]
                if not isinstance(v, _Val) or v.numel != 1:
                    raise Refused("the likelihood's logL is not one value per point")
                if v.const is not None:
                    raise Refused("the likelihood does not depend on the point")
                out = self.elements(v).reshape(())[()]
        return out

    def call(self, node, env):
        def val(a):
            if isinstance(a, (list, tuple)):
                return type(a)(val(x) for x in a)
            return env[a] if hasattr(a, "op") else a

        args, kwargs = val(node.args), {k: val(v) for k, v in node.kwargs.items()}
        target = node.target
        if target is operator.getitem:
            seq, i = args
            if not isinstance(seq, (list, tuple)):
                raise Refused("operator.getitem of a traced value")
            return seq[i]
        name = getattr(getattr(target, "overloadpacket", None), "__name__", str(target))
        meta = node.meta.get("val")
        flat = [a for a in _flatten(args) + _flatten(list(kwargs.values())) if isinstance(a, _Val)]
        if name in _FACTORIES or all(v.const is not None for v in flat):
            return self.fold(node, target, args, kwargs, name)
        if name == "_local_scalar_dense":
            raise Refused("data-dependent: aten._local_scalar_dense (a tensor read on the host, "
                          "such as .item())")
        if name not in TABLE:
            raise Refused(f"aten.{name} is outside the lowering's op table")
        if not isinstance(meta, torch.Tensor):
            raise Refused(f"aten.{name} returns no tensor")
        if meta.dtype not in (self.dtype, torch.bool):
            raise Refused(f"dtype {meta.dtype} (aten.{name})")
        if meta.numel() > MAX_ELEMENTS:
            raise Refused(f"shape {tuple(meta.shape)} of aten.{name} is outside the table "
                          f"(at most {MAX_ELEMENTS} elements)")
        shape = tuple(meta.shape)
        boolean = meta.dtype == torch.bool
        x = args[0] if args else None
        if name in _RESHAPES:
            if name == "_to_copy" and x.boolean != boolean:  # bool <-> float32
                return self.elementwise(shape, boolean, (lambda em, a: em("f32", a)) if x.boolean
                                        else (lambda em, a: em("ne", a, ZERO)), [x])
            return self.reshape(x, shape, boolean)
        if name in _PERMUTES:
            if x.pc is not None and sum(n > 1 for n in x.shape) <= 1:
                return _Val(shape, pc=x.pc, boolean=x.boolean)
            nd = len(x.shape)
            if name == "permute":
                perm = list(args[1])
            elif name == "t":
                perm = list(range(nd))[::-1]
            else:
                perm = list(range(nd))
                d0, d1 = (int(d) % nd for d in args[1:3])
                perm[d0], perm[d1] = perm[d1], perm[d0]
            return _Val(shape, els=np.transpose(self.elements(x), perm), boolean=x.boolean)
        if name == "expand":
            if x.pc is not None and x.numel == int(np.prod(shape)):
                return _Val(shape, pc=x.pc, boolean=x.boolean)
            return self.from_array(np.broadcast_to(self.elements(x), shape), x.boolean)
        if name == "select":
            _, dim, idx = args
            return self.from_array(np.take(self.elements(x), [idx], axis=dim).reshape(shape),
                                   x.boolean)
        if name == "slice":
            dim = args[1] if len(args) > 1 else 0
            start = args[2] if len(args) > 2 else None
            end = args[3] if len(args) > 3 else None
            step = args[4] if len(args) > 4 else 1
            index = [slice(None)] * len(x.shape)
            index[dim] = slice(start, end, step)
            return self.from_array(self.elements(x)[tuple(index)], x.boolean)
        if name in ("cat", "stack"):
            parts = [self.elements(v) for v in args[0] if v.numel or v.shape != (0,)]
            dim = args[1] if len(args) > 1 else kwargs.get("dim", 0)
            joined = np.concatenate(parts, axis=dim) if name == "cat" else np.stack(parts, axis=dim)
            return self.from_array(joined, meta.dtype == torch.bool)
        if name in ("sum", "mean", "amax", "logsumexp"):
            return self.reduction(name, node, args, kwargs, shape)
        if name in ("mv", "mm", "dot"):
            return self.product(name, args, shape)
        return self.elementwise_op(name, node, args, kwargs, shape, boolean)

    def fold(self, node, target, args, kwargs, name):
        """Evaluate an op whose tensor inputs are constants (or only lend
        their dtype and shape), once, as torch computes it."""
        def real(a):
            if isinstance(a, (list, tuple)):
                return type(a)(real(x) for x in a)
            if isinstance(a, _Val):
                if a.const is not None:
                    return a.const
                return torch.zeros(a.shape, dtype=torch.bool if a.boolean else self.dtype,
                                   device=self.device)
            return a

        try:
            res = target(*real(args), **{k: real(v) for k, v in kwargs.items()})
        except Exception as e:  # the model's own error, at its constants
            raise Refused(f"aten.{name} on the model's constants failed: {e}") from e
        if isinstance(res, torch.Tensor):
            if res.numel() > MAX_CONST_ELEMENTS:
                raise Refused(f"a constant of shape {tuple(res.shape)} is outside the table "
                              f"(at most {MAX_CONST_ELEMENTS} elements)")
            return _Val(res.shape, const=res)
        if isinstance(res, (tuple, list)):
            return type(res)(_Val(r.shape, const=r) if isinstance(r, torch.Tensor) else r
                             for r in res)
        return res

    def from_array(self, els: np.ndarray, boolean) -> _Val:
        arr = np.empty(els.shape, object)
        arr[...] = els
        return _Val(arr.shape, els=arr, boolean=boolean)

    def reshape(self, x: _Val, shape, boolean) -> _Val:
        if x.pc is not None:
            return _Val(shape, pc=x.pc, boolean=boolean)
        return _Val(shape, els=self.elements(x).reshape(shape), boolean=boolean)

    def elementwise(self, shape, boolean, build, operands) -> _Val:
        """A value from ``build(em, *refs)`` applied elementwise: one term
        chain when the result is per coordinate (numel D, every operand per
        coordinate or a constant of numel 1 or D or a number), else one
        combine chain per element."""
        tensors = [o for o in operands if isinstance(o, _Val)]
        numel = int(np.prod(shape, dtype=np.int64))
        per_coord = (numel == self.D and any(t.pc is not None for t in tensors)
                     and all(t.pc is not None or (t.const is not None and t.numel in (1, self.D)
                                                  and t.const.dtype != torch.bool)
                             for t in tensors))
        if per_coord:
            return _Val(shape, pc=build(self.em_term, *(self.term_arg(o) for o in operands)),
                        boolean=boolean)
        refs = []
        for o in operands:
            if isinstance(o, _Val):
                refs.append(np.broadcast_to(self.elements(o), shape))
            else:
                refs.append(("c", self.slots([o])))
        out = np.empty(shape, object)
        for idx in np.ndindex(*shape):
            out[idx] = build(self.em_comb, *(r[idx] if isinstance(r, np.ndarray) else r
                                             for r in refs))
        return _Val(shape, els=out, boolean=boolean)

    def elementwise_op(self, name, node, args, kwargs, shape, boolean) -> _Val:
        overload = node.target._overloadname
        if name in ("add", "sub", "rsub") and kwargs.get("alpha", 1) != 1:
            raise Refused(f"aten.{name} with alpha")
        if name == "div" and kwargs.get("rounding_mode") is not None:
            raise Refused("aten.div with a rounding mode")
        if name in _BINARY:
            op = _BINARY[name]
            return self.elementwise(shape, boolean, lambda em, a, b: em(op, a, b), list(args[:2]))
        if name == "rsub":
            return self.elementwise(shape, boolean, lambda em, a, b: em("sub", b, a),
                                    list(args[:2]))
        if name in ("erfinv", "special_ndtri") and self.dtype != torch.float32:
            raise Refused(f"aten.{name} has no float64 sequence in the fused route "
                          "(csrc/fused_ops.cuh holds float32 ones only)")
        if name in _UNARY:
            op = _UNARY[name]
            return self.elementwise(shape, boolean, lambda em, a: em(op, a), [args[0]])
        if name == "rsqrt":
            return self.elementwise(shape, boolean, lambda em, a: em("div", ONE, em("sqrt", a)),
                                    [args[0]])
        if name == "reciprocal":
            return self.elementwise(shape, boolean, lambda em, a: em("div", ONE, a), [args[0]])
        if name == "where" and overload == "self":
            return self.elementwise(shape, boolean, lambda em, c, a, b: em("where", c, a, b),
                                    list(args[:3]))
        if name in ("clamp", "clamp_min", "clamp_max"):
            if name == "clamp":
                lo = args[1] if len(args) > 1 else kwargs.get("min")
                hi = args[2] if len(args) > 2 else kwargs.get("max")
            else:
                lo, hi = (args[1], None) if name == "clamp_min" else (None, args[1])
            ops = [(f, v) for f, v in (("max", lo), ("min", hi)) if v is not None]

            def clamp(em, x, *bounds):
                for (f, _), b in zip(ops, bounds):
                    x = em(f, x, b)
                return x

            return self.elementwise(shape, boolean, clamp, [args[0]] + [v for _, v in ops])
        if name == "pow" and overload == "Tensor_Scalar":
            e = args[1]
            if float(e).is_integer() and e != 0 and abs(e) <= 64:
                n = int(e)
                return self.elementwise(shape, boolean, lambda em, a: _pow_int(em, a, n),
                                        [args[0]])
            if e == 0:
                raise Refused("aten.pow by 0")
            return self.elementwise(shape, boolean, lambda em, a, b: em("pow", a, b),
                                    [args[0], float(e)])
        if name == "pow":  # a number or a tensor to a tensor's power (a log-uniform prior)
            return self.elementwise(shape, boolean, lambda em, a, b: em("pow", a, b),
                                    list(args[:2]))
        raise Refused(f"aten.{name}.{overload} is outside the lowering's op table")

    def reduction(self, name, node, args, kwargs, shape) -> _Val:
        x = args[0]
        if kwargs.get("dtype") not in (None, self.dtype) or x.boolean:
            raise Refused(f"aten.{name} of a {'boolean' if x.boolean else kwargs['dtype']} value")
        els = self.elements(x)
        nd = els.ndim
        dims = args[1] if len(args) > 1 else kwargs.get("dim")
        if dims is None or (isinstance(dims, (list, tuple)) and not dims):
            dims = range(nd)
        elif not isinstance(dims, (list, tuple)):
            dims = [dims]
        dims = sorted({int(d) % nd for d in dims}) if nd else []
        moved = np.moveaxis(els, dims, list(range(nd - len(dims), nd))) if nd else els
        kept = moved.shape[:nd - len(dims)]
        flat = moved.reshape(kept + (-1,))
        em = self.em_comb
        out = np.empty(kept, object)
        for idx in np.ndindex(*kept):
            items = list(flat[idx])
            j = self.lane_export(items)
            if j is not None:
                out[idx] = self.lane_reduction(name, ("o", j))
                continue
            if name in ("sum", "mean"):
                acc = _chain(em, "add", items, ZERO)
                if name == "mean":
                    acc = em("div", acc, ("k", float(len(items))))
            elif name == "amax":
                acc = _chain(em, "max", items, None)
            else:  # logsumexp: torch's own steps, the max shifted to 0 when infinite
                m = _chain(em, "max", items, None)
                m = em("where", em("eq", em("abs", m), INF), ZERO, m)
                s = _chain(em, "add", [em("exp", em("sub", v, m)) for v in items], ZERO)
                acc = em("add", em("log", s), m)
            out[idx] = acc
        return _Val(shape, els=out.reshape(shape))

    def lane_reduction(self, name, item):
        """``name`` over the coordinates of the export ``item`` in the lane
        order, with the chain's steps otherwise (logsumexp's items are lane
        statements that read the max)."""
        em = self.em_comb
        if name == "amax":
            return em("lane_max", item)
        if name in ("sum", "mean"):
            acc = em("lane_add", item)
            return em("div", acc, ("k", float(self.D))) if name == "mean" else acc
        m = em("lane_max", item)
        m = em("where", em("eq", em("abs", m), INF), ZERO, m)
        s = em("lane_add", self.em_lane("exp", self.em_lane("sub", item, m)))
        return em("add", em("log", s), m)

    def product(self, name, args, shape) -> _Val:
        a, b = (self.elements(v) for v in args[:2])
        em = self.em_comb

        def dot(u, v):
            return _chain(em, "add", [em("mul", p, q) for p, q in zip(u, v)], ZERO)

        if name == "dot":
            out = np.empty((), object)
            out[()] = dot(a, b)
        elif name == "mv":
            out = np.empty(a.shape[0], object)
            for i in range(a.shape[0]):
                out[i] = dot(a[i], b)
        else:
            out = np.empty((a.shape[0], b.shape[1]), object)
            for i in range(a.shape[0]):
                for k in range(b.shape[1]):
                    out[i, k] = dot(a[i], b[:, k])
        return _Val(shape, els=out.reshape(shape))


def _flatten(xs):
    out = []
    for x in xs:
        if isinstance(x, (list, tuple)):
            out.extend(_flatten(x))
        else:
            out.append(x)
    return out


def _chain(em, op, items, empty):
    """``op`` over ``items`` in index order, from the first item."""
    if not items:
        if empty is None:
            raise Refused("a reduction over no elements")
        return empty
    acc = items[0]
    for v in items[1:]:
        acc = em(op, acc, v)
    return acc


def _prune(low: _Lowering, out):
    """Drop the statements, exports and constant slots the result does not
    reach, and number what is left in order (a statement refers only to
    earlier ones, so one sweep backwards marks what is live)."""
    live_s, live_t, live_p, live_c, live_q = set(), set(), set(), set(), set()

    def mark(ref, D):
        kind = ref[0]
        if kind == "s":
            live_s.add(ref[1])
        elif kind in ("t", "o"):
            live_t.add(ref[1])
        elif kind == "q":  # a lane statement: its arguments at once (they precede it)
            if ref[1] not in live_q:
                live_q.add(ref[1])
                for r in low.lane[ref[1]][1]:
                    mark(r, D)
        elif kind == "p":
            live_p.add(ref[1])
        elif kind == "c":
            live_c.add((ref[1], 1))
        elif kind == "cv":
            live_c.add((ref[1], D))

    mark(out, low.D)
    for i in reversed(range(len(low.combine))):
        if i in live_s:
            for r in low.combine[i][1]:
                mark(r, low.D)
    for j in live_t:
        mark(low.exports[j], low.D)
    for i in reversed(range(len(low.term))):
        if i in live_p:
            for r in low.term[i][1]:
                mark(r, low.D)
    new_c: Dict[int, int] = {}
    consts: List[float] = []
    for k, n in sorted(live_c):
        new_c[k] = len(consts)
        consts.extend(low.consts[k:k + n])
    new_p = {i: n for n, i in enumerate(sorted(live_p))}
    new_t = {j: n for n, j in enumerate(sorted(live_t))}
    new_s = {i: n for n, i in enumerate(sorted(live_s))}
    new_q = {i: n for n, i in enumerate(sorted(live_q))}

    def remap(ref):
        kind = ref[0]
        if kind == "p":
            return ("p", new_p[ref[1]])
        if kind == "s":
            return ("s", new_s[ref[1]])
        if kind == "q":
            return ("q", new_q[ref[1]])
        if kind == "o":
            return ("o", new_t[ref[1]])
        if kind == "t":
            return ("t", new_t[ref[1]], ref[2])
        if kind in ("c", "cv"):
            return (kind, new_c[ref[1]])
        return ref

    term = [(op, tuple(map(remap, args))) for i, (op, args) in enumerate(low.term) if i in new_p]
    comb = [(op, tuple(map(remap, args))) for i, (op, args) in enumerate(low.combine)
            if i in new_s]
    lane = [(op, tuple(map(remap, args))) for i, (op, args) in enumerate(low.lane)
            if i in new_q]
    exports = [remap(low.exports[j]) for j in sorted(live_t)] or [("x",)]
    return term, exports, comb, lane, remap(out), np.asarray(consts, np.float64)


# ------------------------------------------------------------------ entry points
def _logL_only(out):
    return out[0] if isinstance(out, tuple) else out


def traced_function(calc, affine: bool):
    """The function the lowering traces: one cube (or, with the prior's
    affine form kept in the kernel, one theta) ``(D,)`` -> logL ``()``, per
    point or through the batched model at ``x[None]``, in the calc's dtype."""
    prior_fn, like_fn, _ = calc.model
    dt = calc_dtype(calc)

    def theta(x):
        return x if affine else prior_fn(x).to(dt)

    if calc.form == "per_point":
        return lambda x: _logL_only(like_fn(theta(x))).to(dt).reshape(())
    return lambda x: _logL_only(like_fn(theta(x[None]))).to(dt).reshape(())


def trace(calc, affine: bool):
    """The fx graph of :func:`traced_function`, dead code removed."""
    from torch.fx.experimental.proxy_tensor import make_fx

    D = calc.n_dims
    x = torch.full((D,), 0.5, dtype=calc_dtype(calc), device=calc.device)
    try:
        gm = make_fx(traced_function(calc, affine), tracing_mode="fake",
                     _allow_non_fake_inputs=True)(x)
    except Exception as e:
        kind = type(e).__name__
        if "DataDependent" in kind or "data-dependent" in str(e):
            raise Refused(f"data-dependent control flow ({kind})") from e
        raise Refused(f"the likelihood cannot be traced ({kind}: "
                      f"{str(e).splitlines()[0] if str(e) else ''})") from e
    gm.graph.eliminate_dead_code()
    return gm


def _too_wide(D: int, n_terms: int, dtype, limit: int) -> str:
    return (f"D = {D} exceeds the stream bucket's bound D <= {limit} for {n_terms} "
            f"per-coordinate term(s) in {str(dtype).replace('torch.', '')} (a block's shared "
            "memory holds (2 + terms) D values of the chain)")


def lower(calc) -> Lowered:
    """Lower ``calc`` (``ops/evaluate.make_batched_calculator``) for B1 in
    the calc's dtype, and hold the plain version against the calc's own logL
    on the probe cubes at the model-form tolerance (:data:`F64_TOL` at
    float64).  Raises :class:`Refused` with the reason."""
    if getattr(calc, "uses_callback", False):
        raise Refused("a host-callback likelihood")
    if getattr(calc, "model", None) is None:
        raise Refused("no model to trace")
    dt = calc_dtype(calc)
    if dt not in DTYPES:
        raise Refused(f"dtype {dt}")
    D = calc.n_dims
    if D > stream_max_d(1, dt):  # past every lowering's bound: not traced
        raise Refused(_too_wide(D, 1, dt, stream_max_d(1, dt)))
    prior_fn = calc.model[0]
    # the affine descriptors hold float32 values: a float64 lowering traces
    # the prior into the body
    affine = getattr(prior_fn, "affine", None) if dt == torch.float32 else None
    low = _Lowering(trace(calc, affine is not None), D, calc.device, dt)
    term, exports, comb, lane, out, consts = _prune(low, low.run())
    if D > SLICE_MAXD_WIDE and D > stream_max_d(len(exports), dt):
        raise Refused(_too_wide(D, len(exports), dt, stream_max_d(len(exports), dt)))
    np_dt = np.float32 if dt == torch.float32 else np.float64
    if affine is not None:
        prior = tuple(np.broadcast_to(np.asarray(v, np.float32), (D,)).copy() for v in affine)
    else:
        prior = (np.zeros(D, np_dt), np.ones(D, np_dt))
    lowered = Lowered(D, prior, consts.astype(np_dt), term, exports, comb, out,
                      float(np_dt(calc.logzero)), affine is None, dt, lane=lane)
    cube = probe_cubes(D, calc.device, dt)
    got, want = lowered.plain_logL(cube), calc(cube)[2].to(dt)
    if dt == torch.float32:
        agree = same_values(got, want)
    else:
        agree = got.shape == want.shape and torch.allclose(
            got, want, rtol=F64_TOL[0], atol=F64_TOL[1], equal_nan=True)
    if not agree:
        diff = (got.double() - want.double()).abs().nan_to_num(nan=float("inf")).max().item()
        raise Refused(f"the lowered body disagrees with the calc on the probe cubes "
                      f"(max |dlogL| = {diff:.3g})")
    return lowered


def lowering(calc):
    """``calc``'s :class:`Lowered`, or the :class:`Refused` that names why
    not: lowered once per calc and kept on it."""
    memo = calc.__dict__
    if "fused" not in memo:
        try:
            memo["fused"] = lower(calc)
        except Refused as r:
            memo["fused"] = r
    return memo["fused"]
