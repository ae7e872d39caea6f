"""What the redesigned slice epoch decides on the host, on the CPU: the lanes
per chain (``choose_group``), and the plain versions of E7's bodies
``body20_div`` and ``body20_hash`` — the measurements that chose the design —
against a numpy loop of the same rounded float32 operations."""

import numpy as np
import pytest
import torch

from polychordlite_tpu_torch.experiments import prof_pallas_while
from polychordlite_tpu_torch.ops import pallas_slice_v4
from polychordlite_tpu_torch.ops.pallas_slice_v4 import GROUPS, choose_group

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
