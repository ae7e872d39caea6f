"""What the redesigned slice epochs decide on the host, on the CPU: the lanes
per chain (``choose_group`` for B1, B4, B5 and E2, ``choose_packet_group``
for B3)
and what the wrappers pass to their entries, and the plain versions of E7's
bodies ``body20_div`` and ``body20_hash`` — the measurements that chose the
design — against a numpy loop of the same rounded float32 operations."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from polychordlite_tpu_torch.experiments import prof_pallas_while, v3_instr
from polychordlite_tpu_torch.ops import (
    pallas_slice,
    pallas_slice_v3,
    pallas_slice_v4,
    pallas_slice_v5,
)
from polychordlite_tpu_torch.ops.pallas_slice_v4 import GROUPS, choose_group
from polychordlite_tpu_torch.ops.pallas_slice_v5 import PACKET_GROUPS, choose_packet_group

H100_SMS = 132


@pytest.mark.parametrize("D", [1, 2, 3, 20, 32])
@pytest.mark.parametrize("B", [1, 32, 504, 512, 2048, 8192, 32768])
def test_group_rule(B, D):
    """G divides the warp, its slots cover D, every lane owns a coordinate,
    and G is the smallest that reaches the target warps (or the largest D
    allows)."""
    G = choose_group(B, D, H100_SMS)
    target = pallas_slice_v4.TARGET_WARPS_PER_SM * H100_SMS * 32
    assert G in GROUPS and 32 % G == 0
    assert G * -(-D // G) >= D and G <= D
    assert G == 1 or B * (G // 2) < target
    assert B * G >= target or 2 * G > D or G == 32


def test_group_at_the_recorded_geometries():
    """The values PERF.md records: gaussian.ini's 512 lanes of 20-D chains
    and the bench's 8,192 on an H100's 132 SMs; 2-, 4- and 8-D chains (the
    shells and the zoo's 4-D and 8-D inis)."""
    assert choose_group(512, 20, H100_SMS) == 16
    assert choose_group(8192, 20, H100_SMS) == 8
    assert choose_group(512, 2, H100_SMS) == 2
    assert choose_group(512, 4, H100_SMS) == 4
    assert choose_group(512, 8, H100_SMS) == 8
    assert choose_group(32768, 20, H100_SMS) == 2


def test_launches_pass_the_group(monkeypatch):
    """On the card, slice_epoch launches at choose_group's G (or the one
    asked for) and the counted form (E1) at G = 1: its entry takes no
    group.  The launch is recorded instead of made."""
    class OnCard:  # what the wrappers read of a CUDA tensor before launching
        def __init__(self, *shape):
            self.shape, self.device = shape, torch.device("cuda")

    launched = []
    monkeypatch.setattr(pallas_slice_v4, "_lib", lambda: None)
    monkeypatch.setattr(pallas_slice_v4, "_sm_count", lambda dev: H100_SMS)
    monkeypatch.setattr(pallas_slice_v4, "launch_slice_kernel",
                        lambda lib, entry, *a, ints=(), **k:
                        launched.append((entry, ints)) or (None, None, None))
    args = (OnCard(512, 20), OnCard(512), OnCard(512), OnCard(512, 40, 20), OnCard(512, 40))
    pallas_slice_v4.slice_epoch(None, None, (0, 0), *args)
    pallas_slice_v4.slice_epoch(None, None, (0, 0), *args, group=32)
    empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, device=None, **k: empty(*a, **k))
    pallas_slice_v4.slice_epoch_counted(None, None, (0, 0), *args)
    assert launched == [("slice_epoch_launch", (16,)), ("slice_epoch_launch", (32,)),
                        ("slice_epoch_counted_launch", ())]


def test_group_argument_is_checked():
    x0 = torch.zeros((4, 2))
    with pytest.raises(ValueError, match="group 3"):
        pallas_slice_v4.slice_epoch(None, None, (0, 0), x0, torch.zeros(4),
                                    torch.ones(4, dtype=torch.bool), torch.zeros((4, 1, 2)),
                                    torch.zeros((4, 1)), group=3)


# ---- B3 (speculative packets), B4 (v3), B5 (v2) and E2 ------------------


#: the warps per SM that an H100 keeps of B3's Gaussian kernels by G, as
#: CUDA's occupancy query reads them (PERF.md, section 6; 173, 129, 127, 104
#: registers at G = 4 ... 32)
GAUSSIAN_RESIDENT = {4: 8, 8: 12, 16: 16, 32: 16}
RESIDENT_FORMS = {
    "unbounded": lambda G: 64,  # registers never bind: the target alone decides
    "gaussian": GAUSSIAN_RESIDENT.get,
    "heavy": lambda G: 8,  # a functor whose kernels hold 8 warps an SM at every G
}


@pytest.mark.parametrize("resident", sorted(RESIDENT_FORMS))
@pytest.mark.parametrize("D", [1, 2, 3, 20, 32])
@pytest.mark.parametrize("B", [1, 32, 504, 512, 2048, 8192, 32768])
def test_packet_group_rule(B, D, resident):
    """G = 4 Gs divides the warp, every lane of a sub-group owns a
    coordinate (Gs <= D), and Gs is the smallest that reaches the target
    warps (or the largest that D, the warp and one wave of the doubled G
    kernel's resident warps allow)."""
    warps = RESIDENT_FORMS[resident]
    G = choose_packet_group(B, D, H100_SMS, warps)
    target = pallas_slice_v4.TARGET_WARPS_PER_SM * H100_SMS * 32

    def one_wave(g):
        return B * g <= warps(g) * H100_SMS * 32

    assert G in PACKET_GROUPS and G >= 4 and 32 % G == 0
    Gs = G // 4
    assert Gs <= D
    assert Gs == 1 or (B * 4 * (Gs // 2) < target and one_wave(G))
    assert B * G >= target or 2 * Gs > D or G == 32 or not one_wave(2 * G)


def test_packet_group_at_the_recorded_geometries():
    """The values PERF.md records, with the Gaussian kernels' resident warps:
    the bench's 8,192 20-D chains (G = 4: G = 8 would reach the target but
    its 15.5 warps per SM need a second wave of its 12; without that bound
    the rule gives 8), gaussian.ini's 512 and the shells' 512 2-D chains on
    an H100's 132 SMs."""
    def rule(B, D):
        return choose_packet_group(B, D, H100_SMS, GAUSSIAN_RESIDENT.get)

    assert rule(8192, 20) == 4
    assert choose_packet_group(8192, 20, H100_SMS, RESIDENT_FORMS["unbounded"]) == 8
    assert rule(1024, 20) == 32
    assert rule(512, 20) == 32
    assert rule(512, 2) == 8
    assert rule(512, 1) == 4


class _OnCard:  # what the wrappers read of a CUDA tensor before launching
    def __init__(self, *shape):
        self.shape, self.device = shape, torch.device("cuda")


def test_packet_and_v2_launches_pass_the_group(monkeypatch):
    """On the card, B3 launches at choose_packet_group's G (or the one asked
    for) and B4 and B5 at choose_group's, each entry given G; each counts
    its launch by the dimension bucket and G in its own GROUP_LAUNCHES,
    none in B1's.  The model has a device functor (the wrappers take the
    functor kernels, not the fused routes).  The launch is
    recorded instead of made, and B3's kernels keep the Gaussian's resident
    warps."""
    launched = []

    def record(lib, entry, *a, ints=(), **k):
        launched.append((entry, ints))
        return None, None, None

    # B5 imports v4's names at the call, B4 at its own import; both pick G
    # through v4's launch_group
    for mod in (pallas_slice_v5, pallas_slice_v4):
        monkeypatch.setattr(mod, "_sm_count", lambda dev: H100_SMS)
    for mod in (pallas_slice_v5, pallas_slice_v4, pallas_slice_v3):
        monkeypatch.setattr(mod, "launch_slice_kernel", record)
    monkeypatch.setattr(pallas_slice_v3.nvcc, "load", lambda *a: None)
    monkeypatch.setattr(pallas_slice_v5, "_lib", lambda: None)
    monkeypatch.setattr(pallas_slice_v5, "resident_warps",
                        lambda calc, D, dev, G: GAUSSIAN_RESIDENT[G])
    monkeypatch.setattr(pallas_slice, "_lib", lambda: None)
    empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, device=None, **k: empty(*a, **k))
    counters = (pallas_slice_v5.GROUP_LAUNCHES, pallas_slice.GROUP_LAUNCHES,
                pallas_slice_v3.GROUP_LAUNCHES, pallas_slice_v4.GROUP_LAUNCHES)
    saved = [dict(c) for c in counters]
    for c in counters:
        c.update({g: 0 for g in c})
    try:
        args = (_OnCard(512, 20), _OnCard(512), _OnCard(512), _OnCard(512, 40, 20),
                _OnCard(512, 40))
        calc = SimpleNamespace(device_spec={"likelihood": {"name": "gaussian"}})
        pallas_slice_v5.slice_epoch_v5(calc, None, (0, 0), *args)
        pallas_slice_v5.slice_epoch_v5(calc, None, (0, 0), *args, group=1)
        pallas_slice_v5.slice_epoch_v5(calc, None, (0, 0), *args, group=8)
        monkeypatch.setattr(pallas_slice, "v2_repeat_budget", lambda cfg: 48)
        pallas_slice.slice_epoch_v2(calc, None, (0, 0), *args)
        pallas_slice.slice_epoch_v2(calc, None, (0, 0), *args, group=2)
        monkeypatch.setattr(pallas_slice_v3, "cap_body", lambda cfg: 12)
        pallas_slice_v3.slice_epoch_v3(calc, None, (0, 0), *args)
        pallas_slice_v3.slice_epoch_v3(calc, None, (0, 0), *args, group=4)
        bench = (_OnCard(8192, 20), _OnCard(8192), _OnCard(8192), _OnCard(8192, 100, 20),
                 _OnCard(8192, 100))
        pallas_slice_v3.slice_epoch_v3(calc, None, (0, 0), *bench)
        assert launched == [("slice_epoch_v5_launch", (32,)), ("slice_epoch_v5_launch", (1,)),
                            ("slice_epoch_v5_launch", (8,)), ("slice_epoch_v2_launch", (16,)),
                            ("slice_epoch_v2_launch", (2,)), ("slice_epoch_v3_launch", (16,)),
                            ("slice_epoch_v3_launch", (4,)), ("slice_epoch_v3_launch", (8,))]
        assert {k: c for k, c in pallas_slice_v5.GROUP_LAUNCHES.items() if c} == {
            (32, 32): 1, (32, 1): 1, (32, 8): 1}
        assert {k: c for k, c in pallas_slice.GROUP_LAUNCHES.items() if c} == {(32, 16): 1,
                                                                               (32, 2): 1}
        assert {k: c for k, c in pallas_slice_v3.GROUP_LAUNCHES.items() if c} == {
            (32, 16): 1, (32, 4): 1, (32, 8): 1}
        assert not any(pallas_slice_v4.GROUP_LAUNCHES.values())
        # B4 and B5 count by B1's (bucket, G)
        assert tuple(pallas_slice.GROUP_LAUNCHES) == tuple(pallas_slice_v4.GROUP_LAUNCHES)
        assert tuple(pallas_slice_v3.GROUP_LAUNCHES) == tuple(pallas_slice_v4.GROUP_LAUNCHES)
        assert tuple(g for b, g in pallas_slice_v4.GROUP_LAUNCHES if b == 32) == GROUPS
    finally:
        for c, old in zip(counters, saved):
            c.update(old)


@pytest.mark.parametrize("wrapper,group", [(pallas_slice_v5.slice_epoch_v5, 2),
                                           (pallas_slice_v5.slice_epoch_v5, 64),
                                           (pallas_slice.slice_epoch_v2, 3),
                                           (pallas_slice.slice_epoch_v2, 64),
                                           (pallas_slice_v3.slice_epoch_v3, 3),
                                           (pallas_slice_v3.slice_epoch_v3, 64)])
def test_packet_and_v2_group_argument_is_checked(wrapper, group):
    """B3 takes G in {1, 4, 8, 16, 32} (G = 2 has no packet slot per lane
    group), B4 and B5 B1's G; anything else raises before any launch."""
    x0 = torch.zeros((4, 2))
    with pytest.raises(ValueError, match=f"group {group} "):
        wrapper(None, None, (0, 0), x0, torch.zeros(4), torch.ones(4, dtype=torch.bool),
                torch.zeros((4, 1, 2)), torch.zeros((4, 1)), group=group)


def test_v3_instr_launches_pass_the_group(monkeypatch):
    """On the card, E2 launches at the G that B4 takes at the same B and D
    (choose_group's: 16 at gaussian.ini's 512 20-D chains, 8 at the bench's
    8,192), or at the one asked for, and its skeleton at G = 1; its entries
    take G last.  The launch is recorded instead of made."""
    launched = []

    def record(lib, entry, *a, ints=(), **k):
        launched.append((entry, ints))
        return None, None, None

    monkeypatch.setattr(v3_instr, "_sm_count", lambda dev: H100_SMS)
    monkeypatch.setattr(v3_instr, "launch_slice_kernel", record)
    monkeypatch.setattr(v3_instr.nvcc, "load", lambda *a: None)
    monkeypatch.setattr(v3_instr, "cap_body", lambda cfg: 12)
    empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, device=None, **k: empty(*a, **k))
    zeros = torch.zeros
    monkeypatch.setattr(torch, "zeros", lambda *a, device=None, **k: zeros(*a, **k))
    run = (_OnCard(512, 20), _OnCard(512), _OnCard(512), _OnCard(512, 40, 20), _OnCard(512, 40))
    bench = (_OnCard(8192, 20), _OnCard(8192), _OnCard(8192), _OnCard(8192, 100, 20),
             _OnCard(8192, 100))
    for args in (run, bench):
        v3_instr.slice_epoch_v3_instr(None, None, (0, 0), *args, check=False)
    v3_instr.slice_epoch_v3_instr(None, None, (0, 0), *bench, check=False, group=2)
    v3_instr.slice_epoch_v3_instr(None, None, (0, 0), *bench, check=False, cheap=True)
    assert launched == [("slice_epoch_v3_instr_launch", (16,)),
                        ("slice_epoch_v3_instr_launch", (8,)),
                        ("slice_epoch_v3_instr_launch", (2,)),
                        ("slice_epoch_v3_cheap_launch", (1,))]
    assert [G for _, (G,) in launched[:2]] == [choose_group(512, 20, H100_SMS),
                                               choose_group(8192, 20, H100_SMS)]


@pytest.mark.parametrize("cheap,group", [(False, 3), (False, 64), (True, 2), (True, 8)])
def test_v3_instr_group_argument_is_checked(cheap, group):
    """E2 takes B1's G, its skeleton G = 1 only; anything else raises before
    any launch."""
    x0 = torch.zeros((4, 2))
    with pytest.raises(ValueError, match=f"group {group} "):
        v3_instr.slice_epoch_v3_instr(None, None, (0, 0), x0, torch.zeros(4),
                                      torch.ones(4, dtype=torch.bool), torch.zeros((4, 1, 2)),
                                      torch.zeros((4, 1)), cheap=cheap, group=group)


# ---- E7's new bodies, against numpy -------------------------------------

MASK = 0xFFFFFFFF


def _rotl(x, n):
    return ((x << n) | (x >> (32 - n))) & MASK


def _mix(h, k):
    k = (k * 0xCC9E2D51) & MASK
    k = _rotl(k, 15)
    k = (k * 0x1B873593) & MASK
    h = _rotl(h ^ k, 13)
    return (h * 5 + 0xE6546B64) & MASK


def _fmix(h):
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & MASK
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & MASK
    return h ^ (h >> 16)


def _numpy_body20(variant, x, n):
    """body20's loop in numpy float32, one rounded operation at a time; the
    murmur3 uniform in uint64 arithmetic masked to 32 bits."""
    f = np.float32
    acc = x.astype(f).copy()
    b = np.broadcast_to(x.astype(f), (20,) + x.shape)
    h = _mix(np.full(x.size, 7, np.uint64), np.arange(x.size, dtype=np.uint64))
    for i in range(n):
        if variant == "body20_hash":
            u = (_fmix(_mix(h, np.uint64(i))) >> 8).astype(f) * f(2.0 ** -24)
            acc = acc + u.reshape(x.shape)
        xd = (b + f(0.001) * acc) - f(0.5)
        dd = xd / f(0.1) if variant == "body20_div" else xd * f(10.0)
        sq = dd * dd
        total = sq[0]
        for d in range(1, 20):
            total = total + sq[d]
        acc = np.where(total * f(-0.5) > f(-40.0), acc + f(1.0), acc * f(0.5))
    return acc


@pytest.mark.parametrize("variant", ["body20", "body20_div", "body20_hash"])
def test_e7_bodies_match_numpy(variant):
    rng = np.random.default_rng(len(variant))
    x = rng.uniform(0.2, 0.8, (2, 128)).astype(np.float32)
    x[0, :8] = 0.5 - 0.35 / 1000 * np.arange(8)  # lanes that cross the contour
    want = _numpy_body20(variant, x, 60)
    got = prof_pallas_while.while_loop(variant, torch.as_tensor(x), 60)
    np.testing.assert_array_equal(got.numpy(), want)


def test_e7_division_and_hash_change_the_body():
    """The division rounds otherwise than the multiply by 10 on some lanes,
    and the hash moves every lane: each body is a body of its own."""
    x = torch.as_tensor(np.random.default_rng(1).uniform(0.2, 0.8, (4, 128)).astype(np.float32))
    plain = prof_pallas_while.while_loop("body20", x, 30)
    assert not torch.equal(prof_pallas_while.while_loop("body20_hash", x, 30), plain)
    xd = (x + torch.tensor(0.001) * x) - 0.5
    assert not torch.equal(xd / x.new_full((1,), 0.1), xd * 10.0)
    assert {"body20_div", "body20_hash"} <= set(prof_pallas_while.VARIANTS)
