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
most :data:`MAX_ELEMENTS` elements (the largest D of any bucket; a value
along data axes, below, that many a row) and a constant at most
``MAX_ELEMENTS**2`` (the (D, D) matrix): elementwise arithmetic and
comparisons, logical and/or/not, ``neg``, ``abs``, ``pow``; ``exp``, ``log``,
``log1p``, ``expm1``, ``sqrt``, ``rsqrt``, ``reciprocal``, ``sin``, ``cos``,
``tanh``, ``erf``, ``erfinv``, ``ndtri``; ``where``, ``clamp``, ``maximum``,
``minimum``; ``sum``, ``mean``, ``amax``, ``logsumexp``, ``cumsum`` (a chain
in index order); ``select``, ``slice``, ``view``, ``unsqueeze``,
``squeeze``, ``expand``, ``permute``, ``cat``, ``stack``, ``_to_copy``, and,
by constant indices, ``index_select``, ``index_copy``, ``flip`` (references
moved, no statement: the block and sorted priors); ``searchsorted`` (torch's
own halving search, a fixed number of guarded steps over a row of static
length: equal to ``torch.searchsorted`` on any row, sorted or not) and
``gather`` by a computed index (a chain of selects, exact); ``mv``, ``mm``,
``dot``.  An op whose inputs are all constants is evaluated once, here (a
matrix inverted inside the likelihood becomes a constant).  Anything else
refuses lowering with the op's name as the reason (:class:`Refused`), as do
data-dependent control flow, a larger shape, a dtype other than the
lowering's (float32, or float64 below), float64 inside a float32 lowering
(Types, below), bool, or int (searchsorted's steps and their index
arithmetic: add, sub, clamp, compare, where), a reduction over some of a
value's data axes, and a D past the stream
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

**Data loops.**  An axis whose extent only the model's constants give (its
data: fitting's 50 points, object_detection's 20 x 20 pixels; the values
of the point have extent 1 there) is not scalarised: a value along such
axes holds the references of one row (row statements, ``("r", i)``; a
constant's values a row from a column slot, ``("rc", k)`` read at
``k + r``), and a reduction over all of them is a combine statement
``("loop", (("l", i),))``, :class:`Loop` i: its body (the row statements
its item needs) runs once a row and its item is folded over the rows in a
fixed order (:func:`row_fold`: 32 virtual lanes, then a butterfly), which
the plain version repeats.  In the kernel the lanes of a chain split the
rows (FUSED_ROW_LANES, ``csrc/fused_ops.cuh::FusedRowFold``); the order
does not depend on G.  So the source grows with the graph's ops, not with
the rows.

**Types.**  Each statement has its own type, from its operands' (the kinds
of reference: ``("cd", k)``, ``("rcd", k)``, ``("kd", v)`` float64,
``("ki", v)`` int), and a ``_to_copy`` between float32 and float64 is a
correctly rounded conversion (``to_f64``, ``to_f32``): a float32 model that
computes in float64 (fitting, ROADMAP C20) keeps its float64 body, its
float64 constants two words each at the buffer's tail
(:attr:`Lowered.nc64_at`).

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
BOOL_OPS = frozenset(("lt", "le", "gt", "ge", "eq", "ne", "and", "or", "not"))
#: the lane reductions (above D = 32) and the binary operation each folds with
LANE_OPS = {"lane_add": "add", "lane_max": "max"}
#: float operations per IR statement, for the kernels' bound (the quantile's
#: rational approximation ~30, a library call ~20)
OP_COST = {"erfinv": 24, "ndtri": 28, "pow": 20, "exp": 20, "log": 20, "log1p": 20,
           "expm1": 20, "sin": 20, "cos": 20, "tanh": 20, "erf": 20, "sqrt": 1}


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
    "erfinv": _erfinv, "ndtri": _ndtri, "erf": torch.erf,
    "and": torch.logical_and, "or": torch.logical_or, "not": torch.logical_not,
    "half": lambda a: torch.bitwise_right_shift(a, 1),
    "to_f64": lambda a: a.to(torch.float64), "to_f32": lambda a: a.to(torch.float32),
}

# ------------------------------------------------------------------ C++
_C_CALL = {
    "add": "__fadd_rn", "sub": "__fsub_rn", "mul": "__fmul_rn", "div": "__fdiv_rn",
    "max": "fused_max", "min": "fused_min", "pow": "fused_powf", "abs": "fabsf",
    "exp": "expf", "log": "logf", "log1p": "log1pf", "expm1": "expm1f", "sqrt": "sqrtf",
    "sin": "fused_sinf", "cos": "fused_cosf", "tanh": "tanhf", "erfinv": "fused_erfinv",
    "ndtri": "fused_ndtri", "erf": "erff",
}
#: the calls of a double functor (no erfinv or ndtri: refused at float64)
_C_CALL_F64 = {
    "add": "__dadd_rn", "sub": "__dsub_rn", "mul": "__dmul_rn", "div": "__ddiv_rn",
    "max": "fused_max", "min": "fused_min", "pow": "fused_pow", "abs": "fabs",
    "exp": "exp", "log": "log", "log1p": "log1p", "expm1": "expm1", "sqrt": "sqrt",
    "sin": "fused_sin", "cos": "fused_cos", "tanh": "tanh", "erf": "erf",
}
#: the calls of an int statement (searchsorted's steps and their index arithmetic)
_C_CALL_INT = {"max": "fused_max", "min": "fused_min"}
_C_INFIX = {"lt": "<", "le": "<=", "gt": ">", "ge": ">=", "eq": "==", "ne": "!=",
            "and": "&&", "or": "||"}
#: the C++ type of each dtype, and of each statement type (below)
_C_TYPE = {torch.float32: "float", torch.float64: "double"}
_C_TAG = {"f32": "float", "f64": "double", "i32": "int", "bool": "bool"}
#: a statement type of each torch dtype
_TAGS = {torch.float32: "f32", torch.float64: "f64", torch.int64: "i32", torch.int32: "i32",
         torch.bool: "bool"}
_TORCH_TAG = {"f32": torch.float32, "f64": torch.float64, "i32": torch.int32,
              "bool": torch.bool}
#: the identity each data loop's fold starts from, by operation
_FOLD_IDENTITY = {"add": -0.0, "max": float("-inf")}
#: the lanes of a data loop's fixed fold order: a data loop folds its rows as
#: this many virtual lanes (row r on lane r mod 32), then a butterfly
ROW_LANES = 32


def _c_float(v: float, dtype=torch.float32) -> str:
    """A literal of ``dtype``: float32 (suffix f) or float64, in hex."""
    if dtype == torch.float32:
        v = float(np.float32(v))
    if np.isinf(v):
        return "INFINITY" if v > 0 else "(-INFINITY)"
    return f"{v.hex()}f" if dtype == torch.float32 else v.hex()


def _c_stmt(op: str, a: List[str], dtype=torch.float32, tag: str = None) -> str:
    """The C++ expression of a statement; ``tag`` is the type of its operands
    where it is not ``dtype``'s (a float64 statement in a float32 lowering,
    an int statement)."""
    if op in _C_INFIX:
        return f"({a[0]} {_C_INFIX[op]} {a[1]})"
    if op == "where":
        return f"({a[0]} ? {a[1]} : {a[2]})"
    if op == "neg":
        return f"(-{a[0]})"
    if op == "not":
        return f"(!{a[0]})"
    if op == "f32":
        return f"({a[0]} ? 1.0f : 0.0f)" if dtype == torch.float32 else f"({a[0]} ? 1.0 : 0.0)"
    if op == "to_f64":
        return f"((double){a[0]})"
    if op == "to_f32":
        return f"__double2float_rn({a[0]})"
    tag = tag or _TAGS[dtype]
    if tag == "i32":
        if op == "half":
            return f"({a[0]} >> 1)"
        if op in ("add", "sub"):
            return f"({a[0]} {'+' if op == 'add' else '-'} {a[1]})"
        return f"{_C_CALL_INT[op]}({', '.join(a)})"
    calls = _C_CALL if tag == "f32" else _C_CALL_F64
    return f"{calls[op]}({', '.join(a)})"


# ------------------------------------------------------------------ the IR
@dataclass
class Loop:
    """A data loop (module docstring): ``op`` (``"add"`` or ``"max"``) of
    ``item`` over rows 0 .. ``n_rows`` - 1, each row running ``body`` (its
    statements, ``("r", i)`` the value of statement i of this row), folded
    in the row order of :func:`row_fold`."""

    n_rows: int
    op: str
    body: List[tuple]
    item: tuple


def row_fold(items: torch.Tensor, op, identity: float) -> torch.Tensor:
    """``op`` over the rows of ``items (B, n)`` in a data loop's order: row
    r on virtual lane r mod :data:`ROW_LANES`, each lane folding its rows in
    index order from ``identity`` (-0 for a sum, -inf for a max: exact, so
    a lane's value is its first row's op its next ...), then a butterfly of
    the 32 lanes, lane v taking op(its value, lane v ^ m's) at m = 16, 8, 4,
    2, 1 (``models/examples.py::coordinate_fold``'s lane order); the
    result is lane 0's.  The kernel's lanes of a chain run these virtual
    lanes whatever G (``csrc/fused_ops.cuh::FusedRowFold``), so the
    order, and the plain version, do not depend on G."""
    B, n = items.shape
    acc = torch.full((B, ROW_LANES), identity, dtype=items.dtype, device=items.device)
    for start in range(0, n, ROW_LANES):
        k = min(ROW_LANES, n - start)
        acc = torch.cat([op(acc[:, :k], items[:, start:start + k]), acc[:, k:]], dim=1)
    m = ROW_LANES // 2
    while m >= 1:
        acc = op(acc, acc.reshape(-1, ROW_LANES // (2 * m), 2, m).flip(2).reshape(-1, ROW_LANES))
        m //= 2
    return acc[:, 0]


#: the kinds of reference of each type (the rest are statements'): the
#: lowering's own type, float64 (a float64 body in a float32 lowering) and int
_DEFAULT_KINDS = frozenset(("x", "t", "o", "c", "cv", "k", "rc"))
_F64_KINDS = frozenset(("cd", "rcd", "kd"))


class _Tags:
    """The type of every statement of a :class:`Lowered` ("f32", "f64",
    "i32", "bool"), in one pass over the lists in the order their
    statements refer to each other: a statement's type is bool for a
    comparison or logical operation, the target's for a conversion, its
    item's for a data loop, else its first non-boolean operand's (a
    where's value operands)."""

    def __init__(self, low: "Lowered"):
        self.low, self.d = low, _TAGS[low.dtype]
        self.p: List[str] = []
        self.s: List[str] = []
        self.q: List[str] = []
        self.r: Dict[int, List[str]] = {}
        for op, args in low.term:
            self.p.append(self.stmt(op, args))
        for op, args in low.combine:
            if op in LANE_OPS:
                self.lanes_to(args[0])
            self.s.append(self.stmt(op, args))

    def lanes_to(self, ref):
        if ref[0] == "q":
            while len(self.q) <= ref[1]:
                op, args = self.low.lane[len(self.q)]
                self.q.append(self.stmt(op, args))

    def of(self, ref, loop=None) -> str:
        kind = ref[0]
        if kind in _DEFAULT_KINDS:
            return self.d
        if kind in _F64_KINDS:
            return "f64"
        if kind == "ki":
            return "i32"
        if kind == "r":
            return self.r[loop][ref[1]]
        if kind == "q":
            self.lanes_to(ref)
        return getattr(self, kind)[ref[1]]

    def stmt(self, op, args, loop=None) -> str:
        if op in BOOL_OPS:
            return "bool"
        if op == "f32":
            return self.d
        if op in ("to_f64", "to_f32"):
            return op[3:]
        if op == "loop":
            i = args[0][1]
            lp = self.low.loops[i]
            self.r[i] = []
            for bop, bargs in lp.body:
                self.r[i].append(self.stmt(bop, bargs, i))
            return self.of(lp.item, i)
        tags = [self.of(r, loop) for r in (args[1:] if op == "where" else args)]
        return next((t for t in tags if t != "bool"), "bool")


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
    #: the data loops (combine statements ``("loop", (("l", i),))``)
    loops: List[Loop] = field(default_factory=list)
    #: the float64 constant slots of a float32 lowering with a float64 body
    consts64: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float64))
    #: seconds each group size's library took to build (or load) in this
    #: process, by G (another engine's by "G/<engine>": "G/ring", "G/cuda5")
    build_seconds: Dict[object, float] = field(default_factory=dict)
    _device_consts: Dict[str, torch.Tensor] = field(default_factory=dict, repr=False)

    @property
    def n_terms(self) -> int:
        return len(self.exports)

    @property
    def data_rows(self) -> int:
        """The rows of the longest data loop (0 without one): what the
        chain's lanes split (``pallas_slice_v4.choose_group``)."""
        return max((lp.n_rows for lp in self.loops), default=0)

    def ops_per_probe(self) -> Dict[str, int]:
        """Operations of one probe by statement type ("f32", "f64", "i32",
        "bool"): the probe and the prior's affine map (4 per coordinate),
        the per-coordinate chain D times, the combine with each data loop's
        rows (and its fold), and the machine's ~7 (of :attr:`dtype`).  A
        library call counts :data:`OP_COST`."""
        tags = _Tags(self)
        d = _TAGS[self.dtype]
        out = {d: 4 * self.n_dims + 7}

        def add(tag, op, n=1):
            out[tag] = out.get(tag, 0) + n * OP_COST.get(op, 1)

        for (op, _), t in zip(self.term, tags.p):
            add(t, op, self.n_dims)
        for (op, args), t in zip(self.combine, tags.s):
            if op == "loop":
                lp = self.loops[args[0][1]]
                for (bop, _), bt in zip(lp.body, tags.r[args[0][1]]):
                    add(bt, bop, lp.n_rows)
                add(t, lp.op, lp.n_rows)
            elif op in LANE_OPS:
                add(t, op, self.n_dims + 1)
            else:
                add(t, op)
        for (op, _), t in zip(self.lane, tags.q):
            add(t, op, self.n_dims)
        return out

    def flops_per_probe(self) -> int:
        """Operations of one probe but its int ones (:meth:`ops_per_probe`):
        its float operations, and its comparisons counted as such."""
        return sum(n for t, n in self.ops_per_probe().items() if t != "i32")

    @property
    def nc64_at(self) -> int:
        """Where the float64 slots start in :meth:`device_consts`, in its
        words: after the slots and the prior's a and s (at an even word)."""
        n = len(self.consts) + 2 * self.n_dims
        return n + n % 2

    def device_consts(self, device) -> torch.Tensor:
        """The constant buffer on ``device``, made once: the slots, then the
        prior's a and s (which the plain version reads; the kernel takes the
        prior as its AffinePrior up to D = 128, and reads it there, through
        :meth:`device_prior`, in the stream bucket), then, in a float32
        lowering with a float64 body, the float64 slots, two words each
        from :attr:`nc64_at` (``csrc/fused_ops.cuh::fused_f64``)."""
        key = str(device)
        if key not in self._device_consts:
            np_dt = np.float32 if self.dtype == torch.float32 else np.float64
            words = np.concatenate([self.consts, *self.prior]).astype(np_dt)
            if len(self.consts64):
                words = np.concatenate([words, np.zeros(self.nc64_at - len(words), np_dt),
                                        self.consts64.astype(np.float64).view(np_dt)])
            self._device_consts[key] = torch.tensor(words, dtype=self.dtype, device=device)
        return self._device_consts[key]

    def device_consts64(self, device) -> torch.Tensor:
        """The float64 slots on ``device`` as a float64 tensor (the plain
        version's view of the buffer's tail)."""
        key = f"{device}/f64"
        if key not in self._device_consts:
            self._device_consts[key] = torch.tensor(self.consts64, dtype=torch.float64,
                                                    device=device)
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
        one at a time (each statement in its own type; a data loop's rows
        side by side, folded by :func:`row_fold`), a NaN as logzero, a probe
        outside [0, 1]^D as logzero."""
        dev, D, dt = cube.device, self.n_dims, self.dtype
        c = self.device_consts(dev)
        c64 = self.device_consts64(dev) if len(self.consts64) else None
        a, s = c[len(self.consts):len(self.consts) + D], c[len(self.consts) + D:
                                                            len(self.consts) + 2 * D]
        p = cube.to(dt)
        inside = ((p >= 0.0) & (p <= 1.0)).all(dim=1)
        x = torch.add(torch.mul(p, s), a)
        vals: List[torch.Tensor] = []

        def apply(op, args):
            return args[0].to(dt) if op == "f32" else PLAIN[op](*args)

        def const_arg(ref):
            kind = ref[0]
            if kind == "c":
                return c[ref[1]]
            if kind == "cd":
                return c64[ref[1]]
            if kind == "kd":
                return _lit(ref[1], dev, torch.float64)
            if kind == "ki":
                return _lit(ref[1], dev, torch.int32)
            return _lit(ref[1], dev, dt)

        def term_arg(ref):
            kind = ref[0]
            if kind == "x":
                return x
            if kind == "p":
                return vals[ref[1]]
            if kind == "cv":
                return c[ref[1]:ref[1] + D]
            return const_arg(ref)

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
            return const_arg(ref)

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

        def loop(lp: Loop) -> torch.Tensor:
            rows: List[torch.Tensor] = []

            def row_arg(ref):  # a (B, rows) value, or one that broadcasts to it
                kind = ref[0]
                if kind == "r":
                    return rows[ref[1]]
                if kind in ("rc", "rcd"):
                    col = c if kind == "rc" else c64
                    return col[ref[1]:ref[1] + lp.n_rows]
                v = comb_arg(ref)
                return v[:, None] if v.dim() == 1 else v

            for op, args in lp.body:
                rows.append(apply(op, [row_arg(r) for r in args]))
            items = row_arg(lp.item).expand(p.shape[0], lp.n_rows)
            return row_fold(items, PLAIN[lp.op], _FOLD_IDENTITY[lp.op])

        for op, args in self.combine:
            if op in LANE_OPS:
                items = lane_arg(args[0]).expand(p.shape[0], D)
                svals.append(coordinate_fold(items, PLAIN[LANE_OPS[op]], D))
            elif op == "loop":
                svals.append(loop(self.loops[args[0][1]]))
            else:
                svals.append(apply(op, [comb_arg(r) for r in args]))
        out = comb_arg(self.out).expand(p.shape[0])
        logzero = _lit(self.logzero, dev, dt)
        out = torch.where(torch.isnan(out), logzero, out)
        return torch.where(inside, out, logzero)

    # ---- the kernel
    def emit_functor(self) -> str:
        """The C++ functor ``FusedLike`` with B1's two-stage interface, in
        float or (at float64) double; a float64 statement of a float32
        lowering is double, an int statement int."""
        dt, real = self.dtype, _C_TYPE[self.dtype]
        tags = _Tags(self)

        def ref_c(ref, loop=None):
            kind = ref[0]
            if kind == "x":
                return "x"
            if kind == "o":
                return f"o[{ref[1]}]"
            if kind in ("p", "s", "q"):
                return f"{kind}{ref[1]}"
            if kind == "r":
                return f"l{loop}_{ref[1]}"
            if kind == "t":
                return f"T[{ref[1]}][{ref[2]}]"
            if kind == "c":
                return f"__ldg(c + {ref[1]})"
            if kind == "cd":
                return f"fused_f64(c, FUSED_NC64_AT + {2 * ref[1]})"
            if kind == "rc":
                return f"__ldg(c + {ref[1]} + r)"
            if kind == "rcd":
                return f"fused_f64(c, FUSED_NC64_AT + {2 * ref[1]} + 2 * r)"
            if kind == "cv":
                return f"__ldg(c + {ref[1]} + d)"
            if kind == "ki":
                return str(int(ref[1]))
            return _c_float(ref[1], torch.float64 if kind == "kd" else dt)

        def stmt(name, tag, op, args, indent="        ", loop=None):
            return (f"{indent}const {_C_TAG[tag]} {name} = "
                    f"{_c_stmt(op, [ref_c(r, loop) for r in args], dt, tag)};")

        def body(stmts, prefix, tag_list):
            return [stmt(f"{prefix}{i}", t, op, args)
                    for i, ((op, args), t) in enumerate(zip(stmts, tag_list))]

        def loop_stmt(i, lp_index, tag):
            """A data loop: this lane's virtual lanes' rows, each folded from
            the identity, joined by FusedRowFold (csrc/fused_ops.cuh).  Every
            lane runs the same trip count (a row past the end computes row 0
            and is not folded), so the warp reaches the fold's shuffles
            converged."""
            lp, ty, n = self.loops[lp_index], _C_TAG[tag], ROW_LANES
            ident = _c_float(_FOLD_IDENTITY[lp.op], _TORCH_TAG[tag]) if lp.op == "max" else (
                "-0.0f" if tag == "f32" else "-0.0")
            fold = _c_stmt(lp.op, ["u", "v"], dt, tag)
            return [
                f"        {ty} s{i};",
                "        {",
                "            const int lane = fused_row_lane<FUSED_ROW_LANES>();",
                f"            FusedRowFold<FUSED_ROW_LANES, {ty}> fold;",
                "#pragma unroll 1",
                f"            for (int i = 0; i < {n} / FUSED_ROW_LANES; ++i) {{",
                f"                {ty} a = {ident};",
                "                for (int r0 = fold.lane_of(i) * FUSED_ROW_LANES; "
                f"r0 < {lp.n_rows}; r0 += {n}) {{",
                f"                    const bool on = r0 + lane < {lp.n_rows};",
                "                    const int r = on ? r0 + lane : 0;",
                *[stmt(f"l{lp_index}_{k}", t, op, args, " " * 20, lp_index)
                  for k, ((op, args), t) in enumerate(zip(lp.body, tags.r[lp_index]))],
                "                    if (on) a = "
                f"{_c_stmt(lp.op, ['a', ref_c(lp.item, lp_index)], dt, tag)};",
                "                }",
                f"                fold.push(i, a, []({ty} u, {ty} v) {{ return {fold}; }});",
                "            }",
                f"            s{i} = fold.result([]({ty} u, {ty} v) {{ return {fold}; }});",
                "        }",
            ]

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
            ty = _C_TAG[tags.s[i]]
            fold = _c_stmt(LANE_OPS[op], ["u", "v"], dt, tags.s[i])
            return [f"        const {ty} s{i} = fold(",
                    f"            T, D, [&](const {real}* o, int d) {{",
                    "                (void)d;",
                    *[stmt(f"q{q}", tags.q[q], *self.lane[q], indent="                ")
                      for q in sorted(need)],
                    f"                return {ref_c(item)};",
                    f"            }}, []({ty} u, {ty} v) {{ return {fold}; }});"]

        def combine_stmts(lanes: bool):
            out = []
            for i, (op, args) in enumerate(self.combine):
                if op == "loop":
                    out += loop_stmt(i, args[0][1], tags.s[i])
                elif lanes and op in LANE_OPS:
                    out += fold_stmt(i, op, args[0])
                else:
                    out.append(stmt(f"s{i}", tags.s[i], op, args))
            return out + [f"        return {ref_c(self.out)};"]

        term = body(self.term, "p", tags.p) + [f"        out[{j}] = {ref_c(r)};"
                                               for j, r in enumerate(self.exports)]
        if self.n_dims > SLICE_MAXD:  # the lane order (csrc/likelihoods.cuh)
            combine = combine_stmts(True)
            staged = any(r[0] == "t" for _, args in self.combine for r in args) or any(
                r[0] == "t" for lp in self.loops for _, args in lp.body for r in args)
            lanes = [f"    static constexpr bool STAGED = {str(staged).lower()};"]
            signature = ["    template <class TT>",
                         f"    __device__ __forceinline__ {real} combine(const TT& T, int D) const {{",
                         "        (void)T;",
                         "        (void)D;"]
        else:
            combine = combine_stmts(False)
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

    def row_lanes(self, group: int, engine: str = "cuda") -> int:
        """FUSED_ROW_LANES of a library: the lanes that split each data
        loop's rows — the chain's G (B1, the ring, B4, B5; 32 above D = 32),
        1 for B3 (its packet slots' sub-groups evaluate other probes, so
        every lane runs every row)."""
        if engine == "cuda5":
            return 1
        return group if self.n_dims <= SLICE_MAXD else 32

    def source(self, group: int, engine: str = "cuda", ring: bool = False) -> str:
        """The generated header ``fused_like.cuh`` for ``group`` lanes per
        chain and ``engine``'s library (:data:`ENGINE_DEFINES`): ``"cuda"``,
        B1's; ``"ring"`` (or ``ring=True``), the ring engine's
        (``FUSED_RING``: its entry is ``slice_epoch_fused_ring_launch``);
        ``"cuda5"``, ``"cuda3"``, ``"cuda2"``, the forced engines' B3, B4
        and B5 (``slice_epoch_fused_v5_launch`` and so on).  A model with
        data loops also names FUSED_ROW_LANES (:meth:`row_lanes`), one with
        float64 slots FUSED_NC64_AT."""
        engine = _engine(engine, ring)
        define = ENGINE_DEFINES[engine]
        return "\n".join([
            "// Generated by polychordlite_tpu_torch/ops/fused_like.py from a model's",
            "// torch trace; built by slice_epoch_fused.cu.  Do not edit.",
            "#pragma once",
            f"#define FUSED_D {self.n_dims}",
            f"#define FUSED_MAXD {self.bucket_macro}",
            f"#define FUSED_G {group}",
            f"#define FUSED_NC {len(self.consts)}",
            *([f"#define FUSED_ROW_LANES {self.row_lanes(group, engine)}"] if self.loops else []),
            *([f"#define FUSED_NC64_AT {self.nc64_at}"] if len(self.consts64) else []),
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
    """A value of the trace: a constant (a tensor), a per-coordinate value
    (``pc``, a term reference, flat index d = coordinate d), an array of
    scalar references (``els``), or a value along data axes (``rows``: the
    positions in ``shape`` of its data axes, whose extents come from the
    model's constants; ``els`` then holds the references of one row over the
    other axes, valid in a data loop's body).  ``tag`` is its statement type
    (None: the lowering's float type, or bool)."""

    __slots__ = ("shape", "const", "pc", "els", "boolean", "scalar_slot", "vec_slot", "rows",
                 "tag")

    def __init__(self, shape, const=None, pc=None, els=None, boolean=False, rows=None, tag=None):
        self.shape = tuple(shape)
        self.const, self.pc, self.els, self.boolean = const, pc, els, boolean
        self.scalar_slot = self.vec_slot = None
        self.rows, self.tag = rows, tag

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
          "erfinv": "erfinv", "special_ndtri": "ndtri", "erf": "erf", "special_erf": "erf"}
_BINARY = {"add": "add", "sub": "sub", "mul": "mul", "div": "div", "maximum": "max",
           "minimum": "min", **_COMPARE}
#: logical operations on booleans (``mul`` and ``add`` of two booleans too)
_LOGICAL = {"logical_and": "and", "bitwise_and": "and", "logical_or": "or", "bitwise_or": "or",
            "logical_not": "not", "bitwise_not": "not"}
#: static index ops: remaps of references, no statement
_INDEXING = ("index_select", "index_copy", "flip")
#: the op table: the aten packets lowered on values that are not constants
TABLE = frozenset(_RESHAPES + _PERMUTES + tuple(_UNARY) + tuple(_BINARY) + tuple(_LOGICAL)
                  + _INDEXING + (
    "rsub", "rsqrt", "reciprocal", "where", "clamp", "clamp_min", "clamp_max", "pow",
    "expand", "select", "slice", "cat", "stack", "sum", "mean", "amax", "logsumexp",
    "mv", "mm", "dot", "cumsum", "searchsorted", "gather"))
ONE, ZERO, INF = ("k", 1.0), ("k", 0.0), ("k", float("inf"))


def _pow_int(em, x, n: int, one=ONE):
    """x ** n for an integer n != 0 by repeated squaring from the top bit."""
    if n < 0:
        return em("div", one, _pow_int(em, x, -n, one))
    r = x
    for bit in bin(n)[3:]:
        r = em("mul", r, r)
        if bit == "1":
            r = em("mul", r, x)
    return r


def _objects(refs, shape) -> np.ndarray:
    """An object array of ``shape`` holding the references ``refs`` (one by
    one: numpy would unpack the tuples)."""
    arr = np.empty(len(refs), object)
    for i, r in enumerate(refs):
        arr[i] = r
    return arr.reshape(shape)


class _Lowering:
    def __init__(self, gm, n_dims: int, device, dtype=torch.float32):
        self.gm, self.D, self.device, self.dtype = gm, n_dims, device, dtype
        self.tag = _TAGS[dtype]
        self.consts: List[float] = []
        self.consts64: List[float] = []
        self.term: List[tuple] = []
        self.combine: List[tuple] = []
        self.lane: List[tuple] = []
        self.exports: List[tuple] = []
        self.export_bool: List[bool] = []
        #: the row statements of every data loop, and the loops (rows, op, item)
        self.rows: List[tuple] = []
        self.loops: List[tuple] = []
        #: the length of each column slot (kind "rc"; "rcd" in col_len64)
        self.col_len: Dict[int, int] = {}
        self.col_len64: Dict[int, int] = {}
        self.columns: Dict[tuple, tuple] = {}
        self.held: List[object] = []  # the constants the column cache names by id

    # ---- slots and statements
    def slots(self, values) -> int:
        k = len(self.consts)
        np_dtype = np.float32 if self.dtype == torch.float32 else np.float64
        self.consts.extend(float(v) for v in np.asarray(values, np_dtype).ravel())
        return k

    def slots64(self, values) -> int:
        k = len(self.consts64)
        self.consts64.extend(float(v) for v in np.asarray(values, np.float64).ravel())
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

    def em_row(self, op, *args):
        self.rows.append((op, args))
        return ("r", len(self.rows) - 1)

    def loop(self, op, item, n_rows: int):
        """A data loop folding ``item`` (a row reference) over ``n_rows``
        rows with ``op``: one combine statement."""
        self.loops.append((n_rows, op, item))
        return self.em_comb("loop", ("l", len(self.loops) - 1))

    # ---- types
    def vtag(self, v) -> str:
        """The statement type of a value (module docstring)."""
        if v.const is not None:
            if v.const.dtype not in _TAGS:
                raise Refused(f"a constant of dtype {v.const.dtype}")
            return _TAGS[v.const.dtype]
        return v.tag or ("bool" if v.boolean else self.tag)

    def lit(self, v, tag: str):
        """A literal of the lowering's own definition in type ``tag``."""
        if tag == self.tag:
            return ("k", float(v))
        if tag == "f64":
            return ("kd", float(v))
        if tag == "i32":
            return ("ki", int(v))
        raise Refused(f"a {tag} value in a {self.tag} lowering")

    def number(self, v, tag: str):
        """A model's number as an operand of type ``tag``: a constant slot
        (an int as a literal)."""
        if tag == "i32":
            if not float(v).is_integer():
                raise Refused("a fractional number in an integer operation")
            return ("ki", int(v))
        if tag == self.tag:
            return ("c", self.slots([v]))
        if tag == "f64":
            return ("cd", self.slots64([v]))
        raise Refused(f"a {tag} number in a {self.tag} lowering")

    def convert(self, em, ref, frm: str, to):
        """``ref`` of type ``frm`` as type ``to``: a float conversion, a
        boolean constant's 0/1 slot compared with 0; a boolean or a value of
        the type already as it is."""
        if frm == "bool01":
            return em("ne", ref, self.lit(0.0, self.tag))
        if to is None or frm in (to, "bool"):
            return ref
        if {frm, to} == {"f32", "f64"}:
            return em("to_" + to, ref)
        raise Refused(f"a conversion from {frm} to {to}")

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
        if v.rows is not None:
            raise Refused("a value along a data axis used other than in an elementwise "
                          "operation or a reduction over its data axes")
        if v.els is not None:
            return v.els
        if v.const is not None:
            tag = self.vtag(v)
            values = v.const.detach().cpu().numpy()
            if tag == "bool":  # 0/1 slots compared back
                k = self.slots(values)
                refs = [self.em_comb("ne", ("c", k + i), self.lit(0.0, self.tag))
                        for i in range(v.numel)]
            elif tag == "i32":
                refs = [("ki", int(x)) for x in values.ravel()]
            elif tag == self.tag:
                k = self.slots(values)
                refs = [("c", k + i) for i in range(v.numel)]
            elif tag == "f64":
                k = self.slots64(values)
                refs = [("cd", k + i) for i in range(v.numel)]
            else:
                raise Refused(f"a {tag} constant in a {self.tag} lowering")
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
        v.els = _objects(refs, v.shape)
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
                if self.vtag(v) != self.tag:
                    raise Refused(f"the likelihood's logL is {self.vtag(v)}, not {self.tag}")
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
        if meta.dtype not in (self.dtype, torch.bool) and not (
                meta.dtype in (torch.int64, torch.int32)
                or (meta.dtype == torch.float64 and self.dtype == torch.float32)):
            raise Refused(f"dtype {meta.dtype} (aten.{name})")
        # a value along data axes counts the elements of one row (checked below)
        rowed = any(v.rows is not None or (v.const is not None and v.numel > 1) for v in flat)
        if meta.numel() > MAX_ELEMENTS and not rowed:
            raise Refused(f"shape {tuple(meta.shape)} of aten.{name} is outside the table "
                          f"(at most {MAX_ELEMENTS} elements)")
        res = self.lower_op(name, node, args, kwargs, meta)
        if isinstance(res, _Val) and res.const is None:
            res.tag = _TAGS[meta.dtype]
            n = res.els.size if res.rows is not None else res.numel
            if n > MAX_ELEMENTS and res.pc is None:
                raise Refused(f"shape {tuple(meta.shape)} of aten.{name} is outside the table "
                              f"(at most {MAX_ELEMENTS} elements a row)")
        return res

    def lower_op(self, name, node, args, kwargs, meta):
        shape = tuple(meta.shape)
        boolean = meta.dtype == torch.bool
        tag = _TAGS[meta.dtype]
        x = args[0] if args else None
        if name in _RESHAPES:
            if name == "_to_copy" and x.boolean != boolean:  # bool <-> float32
                if self.vtag(x) not in (self.tag, "bool") or tag not in (self.tag, "bool"):
                    raise Refused(f"a conversion from {self.vtag(x)} to {tag}")
                return self.elementwise(shape, boolean, (lambda em, a: em("f32", a)) if x.boolean
                                        else (lambda em, a: em("ne", a, ZERO)), [x])
            if name == "_to_copy" and self.vtag(x) != tag:  # float32 <-> float64
                if {self.vtag(x), tag} != {"f32", "f64"}:
                    raise Refused(f"a conversion from {self.vtag(x)} to {tag}")
                return self.elementwise(shape, False, lambda em, a: em("to_" + tag, a), [x],
                                        tag=tag)
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
            if x.rows is not None:
                return self.expand_rows(x, shape)
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
        if name in _INDEXING:
            return self.indexing(name, args, shape)
        if name == "cumsum":
            return self.cumsum(x, args[1], kwargs.get("dtype"), tag)
        if name == "searchsorted":
            return self.searchsorted(node, args, kwargs, shape)
        if name == "gather":
            return self.gather(args, shape, tag)
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
                return torch.zeros(a.shape, dtype=_TORCH_TAG[self.vtag(a)], device=self.device)
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

    def from_array(self, els: np.ndarray, boolean, tag=None) -> _Val:
        arr = np.empty(els.shape, object)
        arr[...] = els
        return _Val(arr.shape, els=arr, boolean=boolean, tag=tag)

    def reshape(self, x: _Val, shape, boolean) -> _Val:
        if x.pc is not None:
            return _Val(shape, pc=x.pc, boolean=boolean)
        if x.rows is not None:  # an unsqueeze or a squeeze: the data axes move
            old = [(a, n) for a, n in enumerate(x.shape) if n != 1]
            new = [(a, n) for a, n in enumerate(shape) if n != 1]
            if [n for _, n in old] != [n for _, n in new]:
                raise Refused("a reshape of a value along data axes (other than adding or "
                              "dropping axes of extent 1)")
            where = {a: b for (a, _), (b, _) in zip(old, new)}
            rows = tuple(where[a] for a in x.rows)
            static = tuple(n for b, n in enumerate(shape) if b not in rows)
            return _Val(shape, els=x.els.reshape(static), boolean=boolean, rows=rows)
        return _Val(shape, els=self.elements(x).reshape(shape), boolean=boolean)

    def expand_rows(self, x: _Val, shape) -> _Val:
        off = len(shape) - len(x.shape)
        rows = tuple(a + off for a in x.rows)
        static = tuple(n for b, n in enumerate(shape) if b not in rows)
        els = x.els.reshape((1,) * off + x.els.shape)
        return _Val(shape, els=np.broadcast_to(els, static), boolean=x.boolean, rows=rows)

    # ---- elementwise operations, per coordinate, scalarised or along data axes
    def data_axes(self, shape, tensors):
        """The data axes of an elementwise result: those of its operands
        along data axes, or else each axis whose extent only its constant
        operands give (the values of the point have extent 1 there); None
        when it has none."""
        nd = len(shape)

        def aligned(t):
            return (1,) * (nd - len(t.shape)) + tuple(t.shape)

        rowed = [t for t in tensors if t.rows is not None]
        if rowed:
            found = {tuple(a + nd - len(t.shape) for a in t.rows) for t in rowed}
            if len(found) != 1:
                raise Refused("values along different data axes in one operation")
            rows = found.pop()
            for t in tensors:
                if t.rows is None and t.const is None and any(aligned(t)[a] != 1 for a in rows):
                    raise Refused("a value of the point along a data axis")
            return rows
        rows = tuple(a for a in range(nd) if shape[a] > 1
                     and all(aligned(t)[a] == 1 for t in tensors if t.const is None)
                     and any(aligned(t)[a] > 1 for t in tensors if t.const is not None))
        return rows or None

    def column(self, o: _Val, index, extents, tag: str):
        """The reference of a constant's values along the data axes at one
        element of the other axes: ``index`` indexes the constant (aligned to
        the result; a slice at each data axis).  A scalar slot where it does
        not vary along them, else a column slot, one value a row in the rows'
        order (its type ``tag``, a boolean one 0/1 in the lowering's type)."""
        key = (id(o.const), tuple(i if isinstance(i, int) else None for i in index), tag)
        if key not in self.columns:
            self.held.append(o.const)
            aligned = (1,) * (len(index) - o.const.dim()) + tuple(o.const.shape)
            col = o.const.reshape(aligned)[tuple(index)]
            varies = col.numel() > 1
            values = col.broadcast_to(extents).reshape(-1).detach().cpu().numpy()
            kind_tag = self.tag if tag in ("bool", "bool01") else tag
            if kind_tag == "i32":
                if varies:
                    raise Refused("an integer constant along a data axis")
                ref = ("ki", int(values[0]))
            elif not varies:
                ref = self.number(values[0], kind_tag)
            elif kind_tag == self.tag:
                k = self.slots(values)
                self.col_len[k] = len(values)
                ref = ("rc", k)
            elif kind_tag == "f64":
                k = self.slots64(values)
                self.col_len64[k] = len(values)
                ref = ("rcd", k)
            else:
                raise Refused(f"a {kind_tag} constant in a {self.tag} lowering")
            self.columns[key] = ref
        return self.columns[key]

    def elementwise(self, shape, boolean, build, operands, tag=None, want=None) -> _Val:
        """A value from ``build(em, *refs)`` applied elementwise: one term
        chain when the result is per coordinate (numel D, every operand per
        coordinate or a constant of numel 1 or D or a number, every type the
        lowering's), one row statement chain per element of one row when it
        has data axes (:meth:`data_axes`), else one combine chain per
        element.  ``tag`` is the result's type (bool or the lowering's by
        default) and ``want`` the type each operand is converted to first
        (None: as it is; a number takes ``want``, else the result's type)."""
        tag = tag or ("bool" if boolean else self.tag)
        want = list(want) if want is not None else [None] * len(operands)
        tensors = [o for o in operands if isinstance(o, _Val)]
        numel = int(np.prod(shape, dtype=np.int64))
        own_types = (tag in (self.tag, "bool") and all(w in (None, self.tag) for w in want)
                     and all(self.vtag(t) in (self.tag, "bool") for t in tensors))
        per_coord = (own_types and numel == self.D and any(t.pc is not None for t in tensors)
                     and all(t.pc is not None or (t.const is not None and t.numel in (1, self.D)
                                                  and t.const.dtype != torch.bool)
                             for t in tensors))
        if per_coord:
            return _Val(shape, pc=build(self.em_term, *(self.term_arg(o) for o in operands)),
                        boolean=boolean)
        num_tag = [w or (self.tag if tag == "bool" else tag) for w in want]
        rows = self.data_axes(shape, tensors)
        if rows is not None:
            return self.row_elementwise(shape, boolean, tag, build, operands, want, num_tag,
                                        rows)
        refs = []
        for o, w, nt in zip(operands, want, num_tag):
            if isinstance(o, _Val):
                refs.append((np.broadcast_to(self.elements(o), shape), self.vtag(o), w))
            else:
                refs.append((self.number(o, nt), None, None))
        em = self.em_comb
        out = np.empty(shape, object)
        for idx in np.ndindex(*shape):
            out[idx] = build(em, *(self.convert(em, r[idx], f, w) if f is not None else r
                                   for r, f, w in refs))
        return _Val(shape, els=out, boolean=boolean, tag=tag)

    def row_elementwise(self, shape, boolean, tag, build, operands, want, num_tag, rows):
        """:meth:`elementwise` along the data axes ``rows``: the statements
        of one row, over the other axes."""
        nd = len(shape)
        static = tuple(n for a, n in enumerate(shape) if a not in rows)
        extents = tuple(shape[a] for a in rows)
        refs = []
        for o, w, nt in zip(operands, want, num_tag):
            if not isinstance(o, _Val):
                refs.append((self.number(o, nt), None, None))
                continue
            al = (1,) * (nd - len(o.shape)) + tuple(o.shape)
            if o.rows is not None:
                arr = np.broadcast_to(o.els.reshape(tuple(n for a, n in enumerate(al)
                                                          if a not in rows)), static)
                refs.append((arr, self.vtag(o), w))
            elif o.const is not None:
                ctag = self.vtag(o)
                col_tag = "bool01" if ctag == "bool" else (w or ctag)
                arr = np.empty(static, object)
                for idx in np.ndindex(*static):
                    it = iter(idx)
                    full = []
                    for a in range(nd):
                        if a in rows:
                            full.append(slice(None))
                        else:
                            i = next(it)
                            full.append(0 if al[a] == 1 else i)
                    arr[idx] = self.column(o, full, extents, col_tag)
                refs.append((arr, "bool01" if ctag == "bool" else (w or ctag), w))
            else:
                els = self.elements(o).reshape(al)
                els = els.reshape(tuple(n for a, n in enumerate(al) if a not in rows))
                refs.append((np.broadcast_to(els, static), self.vtag(o), w))
        em = self.em_row
        out = np.empty(static, object)
        for idx in np.ndindex(*static):
            out[idx] = build(em, *(self.convert(em, r[idx], f, w) if f is not None else r
                                   for r, f, w in refs))
        return _Val(shape, els=out, boolean=boolean, rows=tuple(rows), tag=tag)

    def elementwise_op(self, name, node, args, kwargs, shape, boolean) -> _Val:
        overload = node.target._overloadname
        tag = _TAGS[node.meta["val"].dtype]
        if name in ("add", "sub", "rsub") and kwargs.get("alpha", 1) != 1:
            raise Refused(f"aten.{name} with alpha")
        if name == "div" and kwargs.get("rounding_mode") is not None:
            raise Refused("aten.div with a rounding mode")
        if boolean and (name in _LOGICAL or name in ("mul", "add")):
            op = _LOGICAL.get(name, {"mul": "and", "add": "or"}.get(name))
            n = 1 if op == "not" else 2
            if any(isinstance(a, _Val) and not a.boolean for a in args[:n]):
                raise Refused(f"aten.{name} of a value that is not boolean")
            return self.elementwise(shape, boolean, lambda em, *a: em(op, *a), list(args[:n]))
        same = [tag, tag]
        if name in _COMPARE:  # compared in the operands' common type
            tags = {self.vtag(a) for a in args[:2] if isinstance(a, _Val)} - {"bool"}
            common = "f64" if "f64" in tags else (self.tag if self.tag in tags else
                                                  next(iter(tags), self.tag))
            if common == "i32" and any(isinstance(a, float) for a in args[:2]):
                raise Refused(f"aten.{name} of an integer and a fractional number")
            same = [common, common]
        elif tag == "i32" and name not in ("add", "sub", "rsub", "clamp", "clamp_min",
                                           "clamp_max", "maximum", "minimum", "where"):
            raise Refused(f"aten.{name} on integers")
        plain = tag in (self.tag, "bool") and all(
            self.vtag(a) in (self.tag, "bool") for a in args if isinstance(a, _Val))
        want = None if plain else same  # the lowering's own statements as they were
        one = self.lit(1.0, tag) if tag != "bool" else None
        if name in _BINARY:
            op = _BINARY[name]
            return self.elementwise(shape, boolean, lambda em, a, b: em(op, a, b), list(args[:2]),
                                    tag=tag, want=want)
        if name == "rsub":
            return self.elementwise(shape, boolean, lambda em, a, b: em("sub", b, a),
                                    list(args[:2]), tag=tag, want=want)
        if name in ("erfinv", "special_ndtri") and (self.dtype != torch.float32 or tag != "f32"):
            raise Refused(f"aten.{name} has no float64 sequence in the fused route "
                          "(csrc/fused_ops.cuh holds float32 ones only)")
        want1 = None if want is None else want[:1]
        if name in _UNARY:
            op = _UNARY[name]
            return self.elementwise(shape, boolean, lambda em, a: em(op, a), [args[0]], tag=tag,
                                    want=want1)
        if name == "rsqrt":
            return self.elementwise(shape, boolean, lambda em, a: em("div", one, em("sqrt", a)),
                                    [args[0]], tag=tag, want=want1)
        if name == "reciprocal":
            return self.elementwise(shape, boolean, lambda em, a: em("div", one, a), [args[0]],
                                    tag=tag, want=want1)
        if name == "where" and overload == "self":
            return self.elementwise(shape, boolean, lambda em, c, a, b: em("where", c, a, b),
                                    list(args[:3]), tag=tag,
                                    want=None if want is None else [None, tag, tag])
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

            operands = [args[0]] + [v for _, v in ops]
            return self.elementwise(shape, boolean, clamp, operands, tag=tag,
                                    want=None if want is None else [tag] * len(operands))
        if name == "pow" and overload == "Tensor_Scalar":
            e = args[1]
            if float(e).is_integer() and e != 0 and abs(e) <= 64:
                n = int(e)
                return self.elementwise(shape, boolean, lambda em, a: _pow_int(em, a, n, one),
                                        [args[0]], tag=tag, want=want1)
            if e == 0:
                raise Refused("aten.pow by 0")
            return self.elementwise(shape, boolean, lambda em, a, b: em("pow", a, b),
                                    [args[0], float(e)], tag=tag, want=want)
        if name == "pow":  # a number or a tensor to a tensor's power (a log-uniform prior)
            return self.elementwise(shape, boolean, lambda em, a, b: em("pow", a, b),
                                    list(args[:2]), tag=tag, want=want)
        raise Refused(f"aten.{name}.{overload} is outside the lowering's op table")

    # ---- static index ops, cumsum, searchsorted and gather
    def indexing(self, name, args, shape) -> _Val:
        """``index_select``, ``index_copy`` and ``flip``: the references
        moved, no statement (the indices are the model's constants)."""
        x = args[0]
        dim = int(args[1]) % len(x.shape) if name != "flip" else None
        if name == "flip":
            dims = [int(d) % len(x.shape) for d in args[1]]
            return self.from_array(np.flip(self.elements(x), dims), x.boolean, x.tag)
        index = args[2]
        if not isinstance(index, _Val) or index.const is None:
            raise Refused(f"aten.{name} with an index computed from the point")
        idx = index.const.detach().cpu().numpy().astype(np.int64).ravel()
        if name == "index_select":
            return self.from_array(np.take(self.elements(x), idx, axis=dim), x.boolean, x.tag)
        src = self.elements(args[3])
        out = self.elements(x).copy()
        for i, j in enumerate(idx):
            out[(slice(None),) * dim + (j,)] = src[(slice(None),) * dim + (i,)]
        return self.from_array(out, x.boolean, x.tag)

    def cumsum(self, x: _Val, dim, dtype, tag) -> _Val:
        """A chain along ``dim`` in index order."""
        if dtype is not None and _TAGS.get(dtype) != self.vtag(x) or tag not in ("f32", "f64"):
            raise Refused(f"aten.cumsum of a {tag} value")
        rowed = x.rows is not None
        if rowed:
            dim = int(dim) % len(x.shape)
            if dim in x.rows:
                raise Refused("aten.cumsum along a data axis")
            dim -= sum(a < dim for a in x.rows)
        els = x.els if rowed else self.elements(x)
        dim = int(dim) % els.ndim
        em = self.em_row if rowed else self.em_comb
        out = np.moveaxis(els.copy(), dim, 0)
        for k in range(1, out.shape[0]):
            for idx in np.ndindex(*out.shape[1:]):
                out[(k,) + idx] = em("add", out[(k - 1,) + idx], out[(k,) + idx])
        out = np.moveaxis(out, 0, dim)
        return _Val(x.shape, els=out, rows=x.rows, tag=tag)

    @staticmethod
    def _select_chain(em, index, cands):
        """cands[index] for an int ``index`` in range: where(index == k, ...)
        from the first candidate on (no arithmetic: exact)."""
        v = cands[0]
        for k in range(1, len(cands)):
            v = em("where", em("eq", index, ("ki", k)), cands[k], v)
        return v

    def _slices(self, x: _Val, dim: int, n: int, lead):
        """``x``'s slices k = 0 .. n - 1 along ``dim`` (kept as extent 1),
        cut to the extents ``lead`` of the other axes: constants stay
        constants."""
        out = []
        for k in range(n):
            index = [slice(0, m) for m in lead]
            index[dim] = slice(k, k + 1)
            if x.const is not None:
                part = x.const[tuple(index)]
                out.append(_Val(part.shape, const=part))
            else:
                out.append(self.from_array(self.elements(x)[tuple(index)], x.boolean, x.tag))
        return out

    def searchsorted(self, node, args, kwargs, shape) -> _Val:
        """torch's search for each value (``aten/src/ATen/native/
        BucketizationUtils``: ``cus_upper_bound``, or ``cus_lower_bound`` for
        ``right=False``): start = 0, end = n; while start < end, mid = start +
        (end - start) / 2 and start = mid + 1 unless the knot at mid is above
        the value (at or above it for the lower bound), else end = mid.  The
        halvings of a row of static length n take at most n.bit_length()
        steps: each is a guarded step (a finished search keeps its start), the
        knot at mid a chain of selects.  So it equals torch.searchsorted on
        any row, sorted or not, NaN included."""
        seq, vals = args[0], args[1]
        if not isinstance(vals, _Val) or kwargs.get("sorter") is not None:
            raise Refused("aten.searchsorted of a number or with a sorter")
        right = bool(kwargs.get("right", False)) or kwargs.get("side") == "right"
        n = seq.shape[-1]
        tags = {self.vtag(seq), self.vtag(vals)}
        if len(tags) != 1 or tags & {"bool", "i32"}:
            raise Refused("aten.searchsorted over values of two types, or not floats")
        ctag = tags.pop()
        knots = self._slices(seq, len(seq.shape) - 1, n, seq.shape)
        cmp = "gt" if right else "ge"

        def search(em, v, *ks):
            lo, hi = 0, n
            for _ in range(n.bit_length()):
                if isinstance(lo, int) and isinstance(hi, int):  # the first step: static
                    if lo >= hi:
                        break
                    mid = lo + ((hi - lo) >> 1)
                    above = em(cmp, ks[mid], v)
                    lo, hi = (em("where", above, ("ki", lo), ("ki", mid + 1)),
                              em("where", above, ("ki", mid), ("ki", hi)))
                    continue
                on = em("lt", lo, hi)
                mid = em("add", lo, em("half", em("sub", hi, lo)))
                above = em(cmp, self._select_chain(em, mid, ks), v)
                lo = em("where", em("and", on, em("not", above)), em("add", mid, ("ki", 1)), lo)
                hi = em("where", em("and", on, above), mid, hi)
            return lo if not isinstance(lo, int) else ("ki", lo)

        return self.elementwise(shape, False, search, [vals, *knots], tag="i32",
                                want=[ctag] * (1 + n))

    def gather(self, args, shape, tag) -> _Val:
        """``gather(input, dim, index)``: a static remap for a constant
        index, else for each element the chain of selects over the input's
        slices along ``dim``."""
        x, dim, index = args[0], int(args[1]) % len(args[0].shape), args[2]
        if not isinstance(index, _Val):
            raise Refused("aten.gather with a number as its index")
        lead = list(index.shape)
        if index.const is not None:
            idx = index.const.detach().cpu().numpy().astype(np.int64)
            cut = self.elements(x)[tuple(slice(0, m) if a != dim else slice(None)
                                         for a, m in enumerate(lead))]
            return self.from_array(np.take_along_axis(cut, idx, axis=dim), x.boolean, x.tag)
        n = x.shape[dim]
        lead[dim] = n
        cands = self._slices(x, dim, n, lead)
        return self.elementwise(shape, x.boolean,
                                lambda em, i, *cs: self._select_chain(em, i, cs),
                                [index, *cands], tag=tag, want=[None] + [tag] * n)

    # ---- reductions
    def chain_reduce(self, name, em, items, tag):
        """``name`` over ``items`` as a chain in index order: a sum (mean)
        from the first item, amax, and logsumexp by torch's own steps (the
        max shifted to 0 when infinite)."""
        zero = self.lit(0.0, tag)
        if name in ("sum", "mean"):
            acc = _chain(em, "add", items, zero)
            if name == "mean":
                acc = em("div", acc, self.lit(float(len(items)), tag))
            return acc
        if name == "amax":
            return _chain(em, "max", items, None)
        m = _chain(em, "max", items, None)
        m = em("where", em("eq", em("abs", m), self.lit(float("inf"), tag)), zero, m)
        s = _chain(em, "add", [em("exp", em("sub", v, m)) for v in items], zero)
        return em("add", em("log", s), m)

    def loop_reduce(self, name, items, tag, n_rows: int, count: int):
        """``name`` over the data axes and the items of each row: each row's
        items reduced in a chain (row statements), then folded over the
        rows by a data loop (two loops for logsumexp: the max, then the
        shifted sum)."""
        er = self.em_row
        zero = self.lit(0.0, tag)
        if name in ("sum", "mean"):
            acc = self.loop("add", _chain(er, "add", items, zero), n_rows)
            if name == "mean":
                acc = self.em_comb("div", acc, self.lit(float(count), tag))
            return acc
        m = self.loop("max", _chain(er, "max", items, None), n_rows)
        if name == "amax":
            return m
        ec = self.em_comb
        m = ec("where", ec("eq", ec("abs", m), self.lit(float("inf"), tag)), zero, m)
        s = self.loop("add", _chain(er, "add", [er("exp", er("sub", v, m)) for v in items], zero),
                      n_rows)
        return ec("add", ec("log", s), m)

    def reduction(self, name, node, args, kwargs, shape) -> _Val:
        x = args[0]
        tag = self.vtag(x)
        if (kwargs.get("dtype") not in (None, _TORCH_TAG.get(tag), self.dtype) or x.boolean
                or tag == "i32"):
            raise Refused(f"aten.{name} of a {'boolean' if x.boolean else kwargs.get('dtype', tag)}"
                          " value")
        if x.rows is not None:
            return self.row_reduction(name, args, kwargs, shape, tag)
        els = self.elements(x)
        nd = els.ndim
        dims = self._dims(args, kwargs, nd)
        moved = np.moveaxis(els, dims, list(range(nd - len(dims), nd))) if nd else els
        kept = moved.shape[:nd - len(dims)]
        flat = moved.reshape(kept + (-1,))
        out = np.empty(kept, object)
        for idx in np.ndindex(*kept):
            items = list(flat[idx])
            j = self.lane_export(items)
            if j is not None:
                out[idx] = self.lane_reduction(name, ("o", j))
                continue
            out[idx] = self.chain_reduce(name, self.em_comb, items, tag)
        return _Val(shape, els=out.reshape(shape), tag=tag)

    @staticmethod
    def _dims(args, kwargs, nd):
        dims = args[1] if len(args) > 1 else kwargs.get("dim")
        if dims is None or (isinstance(dims, (list, tuple)) and not dims):
            dims = range(nd)
        elif not isinstance(dims, (list, tuple)):
            dims = [dims]
        return sorted({int(d) % nd for d in dims}) if nd else []

    def row_reduction(self, name, args, kwargs, shape, tag) -> _Val:
        """A reduction of a value along data axes: over other axes only, a
        chain in each row (a value along the same data axes); over all its
        data axes (and any others), data loops; over some of them, refused."""
        x = args[0]
        nd = len(x.shape)
        dims = set(self._dims(args, kwargs, nd))
        over_rows = dims & set(x.rows)
        if over_rows and over_rows != set(x.rows):
            raise Refused(f"aten.{name} over some but not all data axes")
        static_axes = [a for a in range(nd) if a not in x.rows]
        pos = [static_axes.index(a) for a in sorted(dims - set(x.rows))]
        els = x.els
        sd = els.ndim
        moved = np.moveaxis(els, pos, list(range(sd - len(pos), sd))) if pos else els
        kept = moved.shape[:sd - len(pos)]
        flat = moved.reshape(kept + (-1,))
        n_rows = int(np.prod([x.shape[a] for a in x.rows]))
        out = np.empty(kept, object)
        for idx in np.ndindex(*kept):
            items = list(flat[idx])
            if over_rows:
                out[idx] = self.loop_reduce(name, items, tag, n_rows, len(items) * n_rows)
            else:
                out[idx] = self.chain_reduce(name, self.em_row, items, tag)
        if over_rows:
            return _Val(shape, els=out.reshape(shape), tag=tag)
        keepdim = len(shape) == nd
        rows = x.rows if keepdim else tuple(a - sum(d < a for d in dims) for a in x.rows)
        static = tuple(n for b, n in enumerate(shape) if b not in rows)
        return _Val(shape, els=out.reshape(static), rows=rows, tag=tag)

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
        zero = self.lit(0.0, self.vtag(args[0]))

        def dot(u, v):
            return _chain(em, "add", [em("mul", p, q) for p, q in zip(u, v)], zero)

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
    """Drop the statements, exports, loops and constant slots the result
    does not reach, and number what is left in order (a statement refers
    only to earlier ones, a row statement to earlier row statements and to
    combine statements before its loop, so one sweep backwards marks what is
    live).  Each live loop's body is the row statements its item reaches,
    numbered from 0."""
    live_s, live_t, live_p, live_c, live_q, live_c64 = set(), set(), set(), set(), set(), set()
    bodies: Dict[int, List[int]] = {}

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
        elif kind == "rc":
            live_c.add((ref[1], low.col_len[ref[1]]))
        elif kind == "cd":
            live_c64.add((ref[1], 1))
        elif kind == "rcd":
            live_c64.add((ref[1], low.col_len64[ref[1]]))

    def mark_loop(i):
        n_rows, op, item = low.loops[i]
        need = set()
        if item[0] == "r":
            need.add(item[1])
        else:
            mark(item, low.D)
        for j in reversed(range(len(low.rows))):
            if j in need:
                for r in low.rows[j][1]:
                    if r[0] == "r":
                        need.add(r[1])
                    else:
                        mark(r, low.D)
        bodies[i] = sorted(need)

    mark(out, low.D)
    for i in reversed(range(len(low.combine))):
        if i in live_s:
            op, args = low.combine[i]
            if op == "loop":
                mark_loop(args[0][1])
            else:
                for r in args:
                    mark(r, low.D)
    for j in live_t:
        mark(low.exports[j], low.D)
    for i in reversed(range(len(low.term))):
        if i in live_p:
            for r in low.term[i][1]:
                mark(r, low.D)

    def packed(live, values):
        new, kept = {}, []
        for k, n in sorted(live):
            new[k] = len(kept)
            kept.extend(values[k:k + n])
        return new, kept

    new_c, consts = packed(live_c, low.consts)
    new_c64, consts64 = packed(live_c64, low.consts64)
    new_p = {i: n for n, i in enumerate(sorted(live_p))}
    new_t = {j: n for n, j in enumerate(sorted(live_t))}
    new_s = {i: n for n, i in enumerate(sorted(live_s))}
    new_q = {i: n for n, i in enumerate(sorted(live_q))}
    new_l = {i: n for n, i in enumerate(sorted(bodies))}

    def remap(ref, rows=None):
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
        if kind in ("c", "cv", "rc"):
            return (kind, new_c[ref[1]])
        if kind in ("cd", "rcd"):
            return (kind, new_c64[ref[1]])
        if kind == "r":
            return ("r", rows[ref[1]])
        if kind == "l":
            return ("l", new_l[ref[1]])
        return ref

    term = [(op, tuple(map(remap, args))) for i, (op, args) in enumerate(low.term) if i in new_p]
    comb = [(op, tuple(map(remap, args))) for i, (op, args) in enumerate(low.combine)
            if i in new_s]
    lane = [(op, tuple(map(remap, args))) for i, (op, args) in enumerate(low.lane)
            if i in new_q]
    loops = []
    for i in sorted(bodies):
        n_rows, op, item = low.loops[i]
        rows = {j: n for n, j in enumerate(bodies[i])}
        body = [(low.rows[j][0], tuple(remap(r, rows) for r in low.rows[j][1]))
                for j in bodies[i]]
        loops.append(Loop(n_rows, op, body, remap(item, rows)))
    exports = [remap(low.exports[j]) for j in sorted(live_t)] or [("x",)]
    return (term, exports, comb, lane, remap(out), np.asarray(consts, np.float64), loops,
            np.asarray(consts64, np.float64))


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
    term, exports, comb, lane, out, consts, loops, consts64 = _prune(low, low.run())
    if D > SLICE_MAXD_WIDE and D > stream_max_d(len(exports), dt):
        raise Refused(_too_wide(D, len(exports), dt, stream_max_d(len(exports), dt)))
    np_dt = np.float32 if dt == torch.float32 else np.float64
    if affine is not None:
        prior = tuple(np.broadcast_to(np.asarray(v, np.float32), (D,)).copy() for v in affine)
    else:
        prior = (np.zeros(D, np_dt), np.ones(D, np_dt))
    lowered = Lowered(D, prior, consts.astype(np_dt), term, exports, comb, out,
                      float(np_dt(calc.logzero)), affine is None, dt, lane=lane, loops=loops,
                      consts64=consts64)
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
