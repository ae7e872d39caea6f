"""The fused route's lowering of the data-driven inis (``ops/fused_like.py``
on ``ini/fitting.ini`` and ``ini/object_detection.ini``): their block and
sorted priors as static remaps and chains, ``searchsorted`` as torch's own
halving search, gathers as chains of selects, ``erf``, a float64 body in a
float32 calc, and the sums over data rows as data loops.

Each model, built as its ini builds it, lowers; its plain version agrees
with the calc at the model-form tolerance and with the JAX package's model
through the JAX block prior; the fused route's plain epoch is
decision-exact with the JAX v4 kernel in interpret mode; each new op's
plain version agrees with torch; the data loop's fold order does not depend
on the lanes that split it; the emitted functor keeps its size when the
data grow, and, built by g++ as host C++, is bitwise its plain version.
``tests/test_torch_cuda.py`` holds the kernel to the same plain version on
the card.
"""

import os
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polychordlite_tpu import priors as jpr
from polychordlite_tpu.models import data_driven as jdd
from polychordlite_tpu.ops.directions import make_directions as jax_make_directions
from polychordlite_tpu.ops.evaluate import make_batched_calculator as jax_calculator
from polychordlite_tpu.ops.slice_kernel import EpochConfig as JaxEpochConfig
from polychordlite_tpu.ops.slice_kernel import _lane_keys
from polychordlite_tpu.utils.inifile import read_ini as jax_read_ini
from polychordlite_tpu_torch.models import get_likelihood
from polychordlite_tpu_torch.models import data_driven as tdd
from polychordlite_tpu_torch.ops import fused_like
from polychordlite_tpu_torch.ops import pallas_slice as pps
from polychordlite_tpu_torch.ops import pallas_slice_v4 as v4
from polychordlite_tpu_torch.ops.evaluate import make_batched_calculator
from polychordlite_tpu_torch.ops.slice_kernel import EpochConfig, epoch_route, route_reason
from polychordlite_tpu_torch.priors import BlockPrior, identity_prior
from polychordlite_tpu_torch.utils import nvcc
from polychordlite_tpu_torch.utils.inifile import read_ini
from test_torch_traced import _jax_v4_records

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "data")
MODELS = {"fitting": 20, "object_detection": 12}
RTOL, ATOL = 1e-5, 1e-6  # the model-form tolerance of ops/evaluate.py


def ini_calc(name: str, data_dir=DATA):
    """The calc of ``ini/<name>.ini`` as ``inidriver.run_ini`` builds it: its
    BlockPrior and the likelihood on the repository's data."""
    D = MODELS[name]
    blocks = read_ini(os.path.join(REPO, "ini", f"{name}.ini"))[1]
    return make_batched_calculator(BlockPrior(blocks, D),
                                   get_likelihood(name, D, data_dir=data_dir), D, 0)


def _cubes(D, n=512, seed=11):
    """Seeded cubes, some outside [0, 1]^D and some on its walls."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-0.05, 1.05, (n, D))
    c[: n // 2] = c[: n // 2].clip(0.0, 1.0)
    return torch.as_tensor(c, dtype=torch.float32)


# ------------------------------------------------------------- the two models
@pytest.mark.parametrize("name", list(MODELS))
def test_data_models_lower_and_agree_with_their_calc(name):
    """Both inis' models lower (their block priors, fitting's searchsorted,
    gathers, erf and float64 body, object_detection's image): one data loop
    each, and the plain version gives the calc's logL within rtol 1e-5 /
    atol 1e-6; the "cuda" engine then takes the fused route."""
    calc = ini_calc(name)
    low = fused_like.lowering(calc)
    assert isinstance(low, fused_like.Lowered), low
    assert low.prior_lowered and [lp.n_rows for lp in low.loops] == {
        "fitting": [50], "object_detection": [400]}[name]
    assert bool(len(low.consts64)) == (name == "fitting")
    cube = _cubes(calc.n_dims)
    got, want = low.plain_logL(cube), calc(cube)[2]
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL, atol=ATOL)
    assert (got[~((cube >= 0) & (cube <= 1)).all(1)] == calc.logzero).all()
    assert epoch_route("cuda", calc) == "slice_epoch_fused"
    assert route_reason("cuda", calc).startswith("lowered")


@pytest.mark.parametrize("name", list(MODELS))
def test_plain_version_against_the_jax_model(name):
    """The plain version on 256 seeded cubes against the JAX package's model
    through the JAX block prior of the same ini (the prior in float32 in
    both).  object_detection: against the JAX float32 model within 4e-6
    relative (the 20 x 20 residual sum in another order; 1.3e-6 at most
    here).  fitting: against the JAX model evaluated in float64 under
    ``jax.enable_x64`` (C20: its float32 evaluation is not the reference),
    within 5e-7 relative, a few float32 ulps: the prior's float32 roundings
    in XLA and in torch, and the float32 result (1.2e-7 at most here)."""
    D = MODELS[name]
    cube = np.random.default_rng(5).uniform(size=(256, D)).astype(np.float32)
    got = fused_like.lowering(ini_calc(name)).plain_logL(torch.as_tensor(cube))
    blocks = jax_read_ini(os.path.join(REPO, "ini", f"{name}.ini"))[1]
    x64 = name == "fitting"
    with jax.enable_x64(x64):
        theta = jpr.hypercube_to_physical(jnp.asarray(cube), blocks)
        like = getattr(jdd, name)(D, DATA)
        want = np.asarray(jax.vmap(like)(theta.astype(jnp.float64) if x64 else theta),
                          np.float64)
    rtol = 5e-7 if x64 else 4e-6
    np.testing.assert_allclose(got.numpy().astype(np.float64), want, rtol=rtol, atol=0)


def _literal_array(values: np.ndarray):
    """``values`` as a float32 jnp array made inside the trace from Python
    numbers (zeros plus each value: literals, no captured array)."""
    zero = jnp.zeros((), jnp.float32)
    flat = [zero + float(v) for v in np.asarray(values, np.float32).ravel()]
    return jnp.stack(flat).reshape(np.shape(values))


def jax_object_detection_literal(D=12):
    """The object_detection ini's prior and likelihood in jnp, every array
    made inside the trace from Python numbers: the JAX package's own
    model and block prior capture their arrays (the data, the blocks'
    indices), which a Pallas kernel refuses ("captures constants ... pass
    them as inputs"; ``polychordlite_tpu/priors.py::_coord_params``), so the
    JAX package runs them on its scan engine.  The operations are the JAX
    package's: ``hypercube_to_physical``'s uniform and sorted blocks and
    ``object_detection``'s residual."""
    img, xg, yg, sigma = jdd.load_object_data(DATA)
    X, Y = np.meshgrid(xg, yg, indexing="ij")
    blocks = jax_read_ini(os.path.join(REPO, "ini", "object_detection.ini"))[1]
    n_obj = D // 4
    norm = -0.5 * img.size * np.log(2 * np.pi * sigma * sigma)

    def prior(cube):
        theta = [None] * D
        for blk in blocks:
            sub = jnp.stack([cube[i] for i in blk.hypercube_indices])
            if blk.prior_type == "sorted_uniform":
                n = sub.shape[-1]
                logx = jnp.log(jnp.clip(sub, 1e-300, None)) / (
                    jax.lax.iota(jnp.float32, n) + 1.0)
                sub = jnp.exp(jnp.cumsum(logx[::-1])[::-1])
            p = np.asarray(blk.parameters, np.float64)
            a, b = (p[0::2], p[1::2]) if p.size > 2 else ([p[0]] * sub.shape[0],
                                                          [p[1]] * sub.shape[0])
            for k, i in enumerate(blk.physical_indices):
                theta[i] = float(np.float32(a[k])) + (float(np.float32(b[k]))
                                                      - float(np.float32(a[k]))) * sub[k]
        return jnp.stack(theta)

    def like(theta):
        img_j, Xj, Yj = (_literal_array(v) for v in (img, X, Y))
        pars = theta.reshape(n_obj, 4)
        A = pars[:, 0][:, None, None]
        x = pars[:, 1][:, None, None]
        y = pars[:, 2][:, None, None]
        R = jnp.abs(pars[:, 3])[:, None, None] + 1e-30
        signal = jnp.sum(A * jnp.exp(-((Xj[None] - x) ** 2 + (Yj[None] - y) ** 2)
                                     / (2 * R * R)), axis=0)
        return (-jnp.sum((img_j - signal) ** 2) / (2 * sigma * sigma) + norm, jnp.zeros(1))

    return prior, like


def test_object_detection_fused_route_decision_exact_with_jax_v4(monkeypatch):
    """The JAX v4 kernel evaluates the object_detection ini's prior and
    likelihood inside its body (interpret mode; their jnp form made of
    literals, :func:`jax_object_detection_literal`); the port's fused route
    (its plain version on the CPU) on the ini's torch model, fed the same
    directions and key words, makes the same decisions: nlike identical on
    every lane, the accepted t within 1e-6 and logL within 1e-5 |logL| +
    1e-6 (as the quickstart's parity test: XLA rounds the chord, the prior
    and the pixel sum in its own order)."""
    D, B, R = 12, 1024, 2  # the JAX kernel takes whole (8, 128) tiles
    calc = ini_calc("object_detection")
    low = fused_like.lowering(calc)
    rng = np.random.default_rng(3)
    seeds = rng.uniform(0.05, 0.95, (B, D)).astype(np.float32)
    bound = (low.plain_logL(torch.as_tensor(seeds)).numpy() - 4.0).astype(np.float32)
    chol = np.broadcast_to(np.float32(0.05) * np.eye(D, dtype=np.float32), (B, D, D)).copy()
    valid = np.arange(B) >= 64
    jprior, jlike = jax_object_detection_literal(D)
    jcalc = jax_calculator(jprior, jlike, D, 1)  # one dummy derived (as test_torch_forced)
    jcfg = JaxEpochConfig(n_dims=D, n_phi=1, grade_dims=(D,), num_repeats=(R,))
    key = jax.random.PRNGKey(7)
    t_j, l_j, n_j = _jax_v4_records(monkeypatch, jcalc, jcfg, key, seeds, bound, chol, valid)
    dir_keys, _ = _lane_keys(key, B, None)
    nh, w, _ = jax_make_directions(
        dir_keys, jnp.asarray(chol), grade_dims=(D,), num_repeats=(R,), n_dims=D,
        shared_perm_key=jax.random.fold_in(key, 0x5EED))
    cfg = EpochConfig(n_dims=D, n_phi=0, grade_dims=(D,), num_repeats=(R,))
    t, l, n = (a.numpy() for a in v4.slice_epoch_fused(
        calc, cfg, pps.key_words(np.asarray(key)), torch.as_tensor(seeds),
        torch.as_tensor(bound), torch.as_tensor(valid), torch.as_tensor(np.array(nh)),
        torch.as_tensor(np.array(w))))
    assert np.array_equal(n.astype(np.int64), n_j)
    assert (np.abs(t - t_j) <= 1e-6).all()
    assert (np.abs(l - l_j) <= 1e-5 * np.abs(l_j) + 1e-6).all()
    assert n[64:].sum() > 0 and (n[:64] == 0).all()


def test_fitting_source_does_not_grow_with_the_data():
    """fitting on 40 synthetic rows and on the repository's 50: the same
    number of source lines (the rows are a loop, not statements), the data
    in the constant buffer."""
    synthetic, repo = (fused_like.lowering(ini_calc("fitting", d)) for d in (None, DATA))
    assert [lp.n_rows for lp in synthetic.loops] == [40]
    assert [lp.n_rows for lp in repo.loops] == [50]
    a, b = synthetic.source(16), repo.source(16)
    assert len(a.splitlines()) == len(b.splitlines()) and a != b
    assert "r0 < 40;" in a and "r0 < 50;" in b


# ------------------------------------------------------------- the new ops
def _lowered(like, D, cube=None):
    calc = make_batched_calculator(identity_prior, like, D, 0)
    low = fused_like.lowering(calc)
    assert isinstance(low, fused_like.Lowered), low
    return calc, low


def _digits(total: np.ndarray, n: int, base: int) -> np.ndarray:
    """The base-``base`` digits (n of them, least significant first) of
    exact integers held as floats."""
    t = total.astype(np.int64)
    return np.stack([(t // base ** k) % base for k in range(n)], axis=-1)


@pytest.mark.parametrize("right", [True, False], ids=["right", "left"])
def test_searchsorted_is_torchs_search_on_any_row(right):
    """searchsorted of 8 data values in the point's 6 coordinates, unsorted
    rows and ties (knots equal to each other and to data values) included:
    each row's 8 indices, read back exactly as base-7 digits of the logL
    (a gather of a constant table), equal torch.searchsorted's for
    ``right=True`` and ``right=False`` (not a count of the knots below,
    which matches torch on sorted rows only)."""
    vals = torch.tensor([0.1, 0.25, 0.5, 0.5, 0.7, 0.9, 0.0, 1.0])
    weights = torch.tensor([7.0 ** k for k in range(8)])
    table = torch.arange(7.0)

    def like(theta):
        idx = torch.searchsorted(theta, vals.expand(theta.shape[0], 8).contiguous(), right=right)
        return (table.expand(theta.shape[0], 7).gather(1, idx) * weights).sum(-1)

    calc, low = _lowered(like, 6)
    assert low.loops and any(op == "half" for lp in low.loops for op, _ in lp.body)
    rng = np.random.default_rng(2)
    cube = rng.uniform(0.0, 1.0, (400, 6)).astype(np.float32)
    cube[::4] = np.sort(cube[::4], axis=1)  # sorted rows beside unsorted ones
    cube[1::4, 2] = cube[1::4, 1]  # tied knots
    cube[2::4, 3] = 0.5  # knots equal to a data value
    cube[3::4, :3] = 0.25
    got = low.plain_logL(torch.as_tensor(cube)).numpy()
    want = torch.searchsorted(torch.as_tensor(cube), vals.expand(400, 8).contiguous(),
                              right=right).numpy()
    np.testing.assert_array_equal(_digits(got, 8, 7), want)
    np.testing.assert_array_equal(got, calc(torch.as_tensor(cube))[2].numpy())
    counted = (cube[:, :, None] <= vals.numpy()[None, None] if right
               else cube[:, :, None] < vals.numpy()[None, None]).sum(1)
    assert (counted != want).any()  # the unsorted rows tell the two apart


def test_gather_of_the_point_by_a_computed_index():
    """A gather of the point's own coordinates by an index computed from
    the point (a searchsorted, clamped): a chain of selects, exact; the
    chosen coordinates against torch's gather."""
    vals = torch.tensor([0.2, 0.4, 0.6, 0.8])

    def like(theta):
        idx = torch.searchsorted(theta[:, :5].contiguous(), vals.expand(theta.shape[0], 4)
                                 .contiguous(), right=True).clamp(0, 4)
        return (theta[:, 5:].gather(1, idx) * torch.tensor([1.0, 2.0, 4.0, 8.0])).sum(-1)

    calc, low = _lowered(like, 10)
    cube = torch.as_tensor(np.random.default_rng(4).uniform(size=(300, 10)), dtype=torch.float32)
    got = low.plain_logL(cube)
    idx = torch.searchsorted(cube[:, :5].contiguous(), vals.expand(300, 4).contiguous(),
                             right=True).clamp(0, 4)
    picked = cube[:, 5:].gather(1, idx)
    want = (((picked[:, 0] + 2 * picked[:, 1]) + 4 * picked[:, 2]) + 8 * picked[:, 3])
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6)


def test_cumsum_flip_and_index_ops_against_torch():
    """The sorted prior's reverse cumulative sum (flip, cumsum, flip), an
    index_select and an index_copy (the block prior's): the plain version
    against the calc within 1e-6 relative."""
    def like(theta):
        rev = torch.flip(torch.cumsum(torch.flip(theta * torch.tensor([1.0, 0.5, 0.25, 2.0, 3.0]),
                                                 (-1,)), dim=-1), (-1,))
        picked = theta.index_select(-1, torch.tensor([4, 0, 2]))
        out = torch.zeros_like(theta).index_copy(-1, torch.tensor([1, 3, 0]), picked * 2.0)
        return (rev * rev).sum(-1) + (out * torch.tensor([1.0, 3.0, 5.0, 7.0, 11.0])).sum(-1)

    calc, low = _lowered(like, 5)
    cube = torch.as_tensor(np.random.default_rng(6).uniform(size=(300, 5)), dtype=torch.float32)
    np.testing.assert_allclose(low.plain_logL(cube).numpy(), calc(cube)[2].numpy(), rtol=1e-6)


def test_float64_body_in_a_float32_calc_round_trip():
    """A float32 calc whose likelihood computes in float64 and returns
    float32: the statements between the two conversions are float64 (its
    constants in the float64 slots), and the plain version is the calc's
    value within one float32 ulp."""
    data = torch.tensor(np.random.default_rng(8).normal(size=7), dtype=torch.float64)

    def like(theta):
        t = theta.to(torch.float64)
        return -(((t[:, :, None] - data) ** 2).sum((1, 2)) * 1e-3).to(theta.dtype)

    calc, low = _lowered(like, 4)
    assert len(low.consts64) and low.loops
    ops = [op for op, _ in low.combine]
    assert ops.count("to_f64") == 4 and ops.count("to_f32") == 1
    cube = torch.as_tensor(np.random.default_rng(9).uniform(size=(300, 4)), dtype=torch.float32)
    got, want = low.plain_logL(cube).numpy(), calc(cube)[2].numpy()
    assert got.dtype == np.float32
    assert (np.abs(got - want) <= np.spacing(np.abs(want))).all()


REFUSED = {  # likelihood, D, the reason's words
    "vector_norm": (lambda th: -torch.linalg.vector_norm(th - 0.5, dim=-1) ** 2, 4,
                    "aten.linalg_vector_norm"),
    "lgamma": (lambda th: torch.lgamma(th + 1.0).sum(-1), 3, "aten.lgamma"),
    "part_of_the_rows": (lambda th: -((th[:, :, None, None] - torch.ones(5, 6)) ** 2)
                         .sum(2).amax(-1).sum(-1), 3, "some but not all data axes"),
    "index_as_a_float": (lambda th: torch.searchsorted(
        th[:, :3].contiguous(), torch.full((th.shape[0], 2), 0.5)).to(th.dtype).sum(-1), 4,
        "a conversion from i32 to f32"),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_what_stays_refused(case):
    """vector_norm and lgamma stay outside the table (the traced route takes
    such models), as do a reduction over some of a value's data axes and an
    index used as a float; the reason names each."""
    like, D, words = REFUSED[case]
    low = fused_like.lowering(make_batched_calculator(identity_prior, like, D, 0))
    assert isinstance(low, fused_like.Refused) and words in low.reason, low
    calc = make_batched_calculator(identity_prior, like, D, 0)
    assert epoch_route("cuda", calc) == "slice_step"


# ------------------------------------------------------- the data loop's order
def _lane_fold_np(items: np.ndarray, lanes: int, op) -> np.ndarray:
    """csrc/fused_ops.cuh's data loop on ``lanes`` lanes, in numpy: lane g
    visits its virtual lanes g + j lanes in the order i = 0, 1, ... with j
    the bit reversal of i (FusedRowFold::lane_of), folds each one's rows
    from the identity and pushes the partial into a binary counter
    (FusedRowFold::push); then the butterfly across the lanes (result);
    lane 0's value."""
    B, n = items.shape
    V = fused_like.ROW_LANES // lanes
    bits = V.bit_length() - 1
    ident = items.dtype.type(-0.0)
    v = np.empty((B, lanes), items.dtype)
    for g in range(lanes):
        levels = [None] * 6
        for i in range(V):
            j = int(format(i, f"0{bits}b")[::-1], 2) if bits else 0
            c = np.full(B, ident, items.dtype)
            for r in range(g + j * lanes, n, fused_like.ROW_LANES):
                c = op(c, items[:, r])
            k = 0
            while (i >> k) & 1:
                c = op(levels[k], c)
                k += 1
            levels[k] = c
        v[:, g] = levels[bits]
    m = lanes // 2
    while m >= 1:
        v = op(v, v[:, np.arange(lanes) ^ m])
        m //= 2
    return v[:, 0]


@pytest.mark.parametrize("n_rows", [1, 7, 32, 50, 400])
def test_row_fold_does_not_depend_on_the_lanes(n_rows):
    """The plain version's row_fold is bitwise the kernel's order on 1, 2,
    4, 8, 16 and 32 lanes (every G of a chain), for sums in float32 and
    float64, with fewer rows than lanes too."""
    rng = np.random.default_rng(n_rows)
    for dt in (np.float32, np.float64):
        items = (rng.standard_normal((64, n_rows)) * 10 ** rng.uniform(-3, 3, (64, n_rows))
                 ).astype(dt)
        want = fused_like.row_fold(torch.as_tensor(items), torch.add, -0.0).numpy()
        for lanes in (1, 2, 4, 8, 16, 32):
            got = _lane_fold_np(items, lanes, np.add)
            assert np.ascontiguousarray(got).tobytes() == np.ascontiguousarray(
                want).tobytes(), (dt, lanes)


# ------------------------------------------------- the functor as host C++
_HOST_MAIN = r"""
#include <math.h>
#include <stdio.h>
#include <stdlib.h>
#define __device__
#define __forceinline__ inline
#define __noinline__
#define __fadd_rn(a, b) ((a) + (b))
#define __fsub_rn(a, b) ((a) - (b))
#define __fmul_rn(a, b) ((a) * (b))
#define __fdiv_rn(a, b) ((a) / (b))
#define __ldg(p) (*(p))
template <int M> struct AffinePriorT { float a[M]; float s[M]; };
#include "fused_ops.cuh"
#include "fused_like.cuh"

// stdin: B, logzero, the buffer's length and the buffer (float32 words),
// the B x D thetas; stdout: the B logL as float32 (no prior: the identity).
int main() {
    int B, n;
    if (fread(&B, sizeof B, 1, stdin) != 1) return 1;
    FusedLike like;
    if (fread(&like.logzero, sizeof(float), 1, stdin) != 1) return 1;
    if (fread(&n, sizeof n, 1, stdin) != 1) return 1;
    float* c = (float*)malloc(sizeof(float) * (n + 1));
    if (fread(c, sizeof(float), n, stdin) != (size_t)n) return 1;
    like.c = c;
    float* p = (float*)malloc(sizeof(float) * FUSED_D * B);
    if (fread(p, sizeof(float), (size_t)FUSED_D * B, stdin) != (size_t)FUSED_D * B) return 1;
    for (int b = 0; b < B; ++b) {
        float T[FusedLike::NT][FusedLike::MAXD];
        for (int d = 0; d < FUSED_D; ++d) {
            float o[FusedLike::NT];
            like.term(p[b * FUSED_D + d], d, o);
            for (int j = 0; j < FusedLike::NT; ++j) T[j][d] = o[j];
        }
        float l = like.combine(T, FUSED_D);
        if (l != l) l = like.logzero;
        fwrite(&l, sizeof l, 1, stdout);
    }
    return 0;
}
"""


def host_model(theta):
    """A data loop over 37 rows with a searchsorted of the point's sorted
    knots, gathers of the knots by the index, a cumulative sum and a
    division: fitting's interpolation without its erf."""
    xs = torch.cumsum(theta[:, :4] * 0.25, dim=-1)
    ys = theta[:, 4:]
    x0 = torch.linspace(0.0, 1.1, 37)
    y0 = torch.cos(x0 * 3.0)
    idx = (torch.searchsorted(xs.contiguous(), x0.expand(theta.shape[0], 37).contiguous(),
                              right=True) - 1).clamp(0, 2)
    x1, x2 = xs.gather(1, idx), xs.gather(1, idx + 1)
    y1, y2 = ys.gather(1, idx), ys.gather(1, idx + 1)
    frac = torch.where(x2 > x1, (x0 - x1) / torch.where(x2 > x1, x2 - x1, 1.0), 0.0)
    y = y1 + frac.clamp(0.0, 1.0) * (y2 - y1)
    return -(((y - y0) / 0.3) ** 2).sum(-1)


def test_emitted_data_loop_is_bitwise_its_plain_version_as_host_cpp(tmp_path):
    """The emitted functor of :func:`host_model` (a data loop, searchsorted,
    gathers, cumsum), compiled by g++ with -ffp-contract=off at one lane a
    chain: every logL is the plain version's bit for bit."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ on the PATH")
    calc, low = _lowered(host_model, 8)
    assert [lp.n_rows for lp in low.loops] == [37]
    ops = {op for op, _ in low.term + low.combine} | {op for lp in low.loops for op, _ in lp.body}
    assert {"half", "where", "eq"} <= ops and not ops & {"erf", "exp", "log", "pow"}
    (tmp_path / "fused_like.cuh").write_text(low.source(1))
    (tmp_path / "main.cpp").write_text(_HOST_MAIN)
    exe = tmp_path / "fused"
    subprocess.run([gxx, "-std=c++17", "-O2", "-ffp-contract=off", "-I", str(tmp_path),
                    "-I", str(nvcc.CSRC), str(tmp_path / "main.cpp"), "-o", str(exe)],
                   check=True, capture_output=True, timeout=300)
    cube = torch.as_tensor(np.random.default_rng(12).uniform(size=(1024, 8)), dtype=torch.float32)
    buf = low.device_consts("cpu").numpy()
    stdin = (np.int32(cube.shape[0]).tobytes() + np.float32(low.logzero).tobytes()
             + np.int32(len(buf)).tobytes() + buf.tobytes() + cube.numpy().tobytes())
    res = subprocess.run([str(exe)], input=stdin, capture_output=True, check=True, timeout=300)
    got = np.frombuffer(res.stdout, np.float32)
    want = low.plain_logL(cube).numpy()
    assert got.shape == want.shape and np.array_equal(got.view(np.uint32), want.view(np.uint32))
    np.testing.assert_allclose(want, calc(cube)[2].numpy(), rtol=RTOL, atol=ATOL)


# -------------------------------------------- the lanes a chain's rows take
@pytest.mark.parametrize("B,D,rows,G", [
    (512, 20, 50, 32), (128, 12, 400, 32),  # the data inis' batches
    (512, 20, 0, 16), (128, 12, 0, 8),      # the same without data rows: the rule
    (8192, 20, 3, 8), (8192, 20, 12, 16),   # few rows: to the rows, not past them
    (512, 64, 50, 32), (512, 1, 50, 32),    # the wide bucket; past D
])
def test_choose_group_splits_data_rows_over_more_lanes(B, D, rows, G):
    """``choose_group`` with a functor's data rows doubles G past the rule's
    (and past D) while G is below the rows, to 32; without rows it is the
    rule (an H100's 132 SMs)."""
    assert v4.choose_group(B, D, 132, rows) == G
    assert v4.choose_group(B, D, 132, 0) == v4.choose_group(B, D, 132)


@pytest.mark.parametrize("name", [*MODELS, "zoo"])
def test_route_group_is_the_rule_given_the_lowerings_rows(monkeypatch, name):
    """``route_group`` (the runner's and ``data_driven_step``'s G) is
    ``choose_group`` given the lowering's data rows where the fused route
    runs the model: 32 for both inis at their batches; B1's functor route
    (the zoo Gaussian, no lowering asked for) the rule's; the runner on the
    CPU picks none."""
    from polychordlite_tpu_torch.models.examples import gaussian
    from polychordlite_tpu_torch.parallel import mesh

    monkeypatch.setattr(v4, "_sm_count", lambda dev: 132)
    cpu = torch.device("cpu")
    if name == "zoo":
        calc = make_batched_calculator(identity_prior, gaussian(20), 20, 0)
        assert v4.route_group(calc, 512, 20, cpu) == 16 and "fused" not in calc.__dict__
    else:
        calc = ini_calc(name)
        B = {"fitting": 512, "object_detection": 128}[name]
        assert fused_like.lowering(calc).data_rows == {"fitting": 50, "object_detection": 400}[name]
        assert v4.route_group(calc, B, MODELS[name], cpu) == 32
    assert mesh.run_group("cuda", calc, 512, calc.n_dims, cpu) is None


@pytest.fixture(scope="module")
def fitting_low():
    return fused_like.lowering(ini_calc("fitting"))


@pytest.mark.parametrize("form", ["route", "redundant", "lane_trips", "loads64", "loads32",
                                  "syncwarp", "checked", "lane_trips+loads64",
                                  "lane_trips+checked+loads32"])
def test_study_forms_patch_the_generated_header(fitting_low, form):
    """``experiments/fused_data_times.py``'s forms of fitting's functor:
    each a patch of the generated header that changes what it says and
    nothing else — the route's form is the header itself, every other
    form's library has its own name."""
    from polychordlite_tpu_torch.experiments import fused_data_times as fdt

    low = fitting_low
    src, patched = low.source(32), fdt.Patched(low, form).source(32)
    assert (patched == src) == (form == "route")
    assert (fdt.Patched(low, form).library_name(32) == low.library_name(32)) == (form == "route")
    n = low.data_rows
    want = {
        "redundant": lambda t: "#define FUSED_ROW_LANES 1\n" in t,
        "lane_trips": lambda t: f"r0 + lane < {n}; r0 += 32)" in t,
        "loads64": lambda t: "reinterpret_cast<const double*>(c + at)" in t
        and "fused_f64(c, " not in t,
        "loads32": lambda t: "__hiloint2double" in t and "fused_f64(c, " not in t,
        "syncwarp": lambda t: t.count("__syncwarp();") == len(low.loops),
        "checked": lambda t: "fused_f64_checked(c, FUSED_NC64_AT" in t
        and t.count("fused_f64(c, ") == ("loads" not in form) and f"r >= {n}" in t,
    }
    for part in form.split("+"):
        assert want.get(part, lambda t: t == src)(patched), part
    assert len(patched.splitlines()) - len(src.splitlines()) < 12


def test_loader_rows_reach_the_buffer():
    """fitting's data x column (searchsorted's values) sits in the float64
    slots as the loader read it, and the buffer's tail from
    ``nc64_at`` holds the float64 slots bit for bit, two words each, low
    word first (``csrc/fused_ops.cuh::fused_f64`` reads them so)."""
    low = fused_like.lowering(ini_calc("fitting"))
    x = tdd.load_fitting_data(DATA)[0][:, 0]
    assert any(np.array_equal(low.consts64[k:k + len(x)], x)
               for k in range(len(low.consts64) - len(x) + 1))
    buf = low.device_consts("cpu").numpy()
    assert low.nc64_at % 2 == 0 and len(buf) == low.nc64_at + 2 * len(low.consts64)
    assert np.array_equal(buf[low.nc64_at:].view(np.float64), low.consts64)
