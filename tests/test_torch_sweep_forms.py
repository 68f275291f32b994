"""The Python side of kernels K-A and K-C around their instances and forms:
the load width, stations a thread and instance K-A picks, the rule that
picks K-C's shared-memory form and its chunks, the scratch accumulator's
epochs, and the strided cotangent that autograd hands K-C. The kernels themselves run only on the card (``chip_smoke.py``
holds every instance and form against its plain version there); here the
wrappers take their plain versions, on CPU tensors.
"""

import numpy as np
import pytest
import torch

from directvoxgo_tpu_torch.ops import sweep as torch_sweep
from directvoxgo_tpu_torch.ops import sweep_bwd as kc
from directvoxgo_tpu_torch.ops import sweep_fwd as ka

# An H100's limits as the card reports them: opt-in shared memory per
# block, shared memory per SM, SMs.
H100 = (232448, 233472, 132)


@pytest.mark.parametrize("c,elem,address,width", [
    (14, 2, 0, 4), (12, 2, 0, 8), (8, 2, 0, 16), (11, 2, 0, 2),
    (5, 2, 0, 2), (1, 4, 0, 4), (4, 4, 0, 16), (14, 4, 0, 8),
    (8, 2, 8, 8), (8, 2, 2, 2)])
def test_load_width(c, elem, address, width):
    """The widest load that divides a voxel's bytes and the address."""
    assert ka.load_width(c, elem, address) == width


@pytest.mark.parametrize("n,s_total,spt", [
    (160000, 207, 8),     # a counted view: 33 M (ray, station) pairs
    (8192, 319, 1),       # the fine step
    (4096, 255, 1),       # the MPI step
    (8192, 127, 1),       # a render chunk
    (1 << 16, 1 << 8, 8), # 2^24 pairs: the first batch that takes eight
    ((1 << 16) - 1, 1 << 8, 1),
])
def test_stations_per_thread(n, s_total, spt):
    """One station a thread until rays x stations reach 2^24."""
    assert ka.stations_per_thread(n, s_total) == spt
    assert spt in ka.STATIONS_PER_THREAD_CHOICES


def test_kernel_instances_and_form_names():
    """C = 1, 5, 11, 14 have instances of their own, any other C runs the
    generic one; the form names say instance, load width and window."""
    slabs = torch.zeros(4, 5, 6, 14, dtype=torch.bfloat16)
    assert ka.instance(slabs, 100)[:2] == ("bf16", 14)
    assert ka.instance(slabs, 100)[3] == 1
    assert ka.instance(torch.zeros(4, 5, 6, 3), 100)[:2] == ("f32", 0)
    assert ka.form(("bf16", 14, 4, 1), False) == "bf16 C=14 4B x1"
    assert ka.form(("f32", 0, 4, 8), True) == "f32 C=generic 4B x8 windowed"
    assert kc.instance(True, 1, False) == ("sweep_bwd_shared", False, 1)
    assert kc.instance(False, 3, True) == ("sweep_bwd_global", True, 0)
    assert kc.form(kc.instance(False, 14, True), True) == (
        "global C=14 bf16 station-major g")


@pytest.mark.parametrize("c,want", [(1, 1), (2, 4), (5, 8), (11, 12),
                                    (14, 16), (16, 16)])
def test_acc_stride(c, want):
    """The accumulator's channel stride takes whole 16-byte reductions."""
    assert kc.acc_stride(c) == want


@pytest.mark.parametrize("gu,gv,c,n,shared", [
    (104, 96, 1, 160000, True),      # a counted view of a coarse grid
    (104, 96, 5, 8192, False),       # a coarse step: fits, too few rays
    (104, 96, 5, 40000, True),       # 195 KB fits, 4 rays a voxel
    (160, 152, 14, 8192, False),     # the fine step: 1.3 MB
    (352, 371, 11, 4096, False),     # the MPI step
    (120, 100, 5, 48000, False),     # 240,000 bytes: over the limit
    (104, 96, 1, 39935, False),      # one ray short of 4 a voxel
])
def test_shared_form_rule(gu, gv, c, n, shared):
    """K-C's shared form needs the f32 plane within a block's opt-in
    shared memory and at least four rays a voxel of the plane."""
    assert kc.shared_form(gu, gv, c, n, H100[0]) is shared
    got_shared, chunks = kc.plan(gu, gv, c, n, 207, H100)
    assert got_shared is shared and (chunks > 0) is shared


def test_shared_form_rule_at_the_limit():
    """A plane of exactly the opt-in size fits; one float more does not."""
    limit = 104 * 96 * 4
    assert kc.shared_form(104, 96, 1, 40000, limit)
    assert not kc.shared_form(104, 96, 1, 40000, limit - 4)


@pytest.mark.parametrize("n,s_total,plane,want", [
    (160000, 207, 104 * 96 * 4, 10),  # 4 blocks an SM: 4 waves of 528
    (40000, 207, 104 * 96 * 20, 2),   # one 195 KB block an SM
    (160000, 20, 104 * 96 * 4, 78),   # few stations: 2048 rays a chunk
    (4096, 20, 104 * 96 * 4, 2),      # at least 4 rays a thread
])
def test_shared_chunks(n, s_total, plane, want):
    """Four waves of blocks over the stations, chunks of >= 2048 rays."""
    assert kc.shared_chunks(n, s_total, plane, *H100[1:]) == want


def test_scratch_epochs_grow_and_wrap():
    """The scratch grows to the largest grid asked for; each call gets the
    next epoch, and past 255 the marks are cleared and the epoch is 1."""
    dev = torch.device("cpu")
    kc._scratch.pop(dev, None)
    try:
        acc, marks, epoch = kc.take_scratch(dev, 10, 4)
        assert (acc.numel(), marks.numel(), epoch) == (40, 10, 1)
        marks[3] = epoch
        acc2, marks2, epoch2 = kc.take_scratch(dev, 5, 16)
        assert (acc2.numel(), marks2.numel(), epoch2) == (80, 10, 1)
        assert not marks2.any()
        for want in range(2, 256):
            assert kc.take_scratch(dev, 5, 16)[2] == want
        marks2[:] = 255
        st = kc.take_scratch(dev, 5, 16)
        assert st[2] == 1 and not st[1].any() and st[0] is acc2
    finally:
        kc._scratch.pop(dev, None)


def test_sweep_bwd_reads_the_cotangent_through_its_strides():
    """Autograd's [C, N, S] cotangent, viewed as [S, C, N], gives the same
    grid cotangent as a contiguous copy; it is station-major."""
    rng = np.random.default_rng(2)
    gp, gu, gv, c, k, n = 6, 8, 9, 5, 2, 300
    s = k * (gp - 1) + 1
    rays = torch.tensor(np.stack([
        rng.uniform(-1, gp, n), rng.uniform(-1, gu, n), rng.uniform(-1, gv, n),
        rng.uniform(0.3, 1, n) * rng.choice([-1.0, 1.0], n),
        rng.uniform(-0.5, 0.5, n), rng.uniform(-0.5, 0.5, n)]),
        dtype=torch.float32)
    cot = torch.tensor(rng.normal(size=(c, n, s)), dtype=torch.float32)
    g = cot.permute(2, 0, 1)
    assert kc.station_major(g) and not kc.station_major(g.contiguous())
    out = kc.sweep_bwd(g, rays, k, (gp, gu, gv, c), torch.float32)
    ref = kc.sweep_bwd(g.contiguous(), rays, k, (gp, gu, gv, c),
                       torch.float32)
    assert np.abs(ref.numpy()).max() > 0.1
    assert torch.equal(out, ref)


def test_station_sweep_hands_k_c_autograd_s_layout(monkeypatch):
    """``station_sweep``'s backward passes the cotangent to K-C as a view
    of autograd's tensor (no copy), station-major for a [C, N, S] one."""
    seen = []
    orig = torch_sweep.sweep_bwd

    def spy(g, *a, **kw):
        seen.append(g)
        return orig(g, *a, **kw)

    monkeypatch.setattr(torch_sweep, "sweep_bwd", spy)
    rng = np.random.default_rng(3)
    gp, gu, gv, c, k, n = 5, 6, 7, 3, 2, 200
    grid = torch.tensor(rng.normal(size=(gp, gu, gv, c)), dtype=torch.float32,
                        requires_grad=True)
    r = torch.tensor(np.stack([
        rng.uniform(-1, gp, n), rng.uniform(-1, gu, n), rng.uniform(-1, gv, n),
        rng.uniform(0.3, 1, n), rng.uniform(-0.5, 0.5, n),
        rng.uniform(-0.5, 0.5, n)]), dtype=torch.float32)
    vals, _ = torch_sweep.station_sweep(grid, (tuple(r[:3]), tuple(r[3:])), k)
    cot = torch.tensor(rng.normal(size=vals.shape), dtype=torch.float32)
    (vals * cot).sum().backward()
    (g,) = seen
    assert g.shape == (vals.shape[2], c, n) and kc.station_major(g)
    assert g._base is not None          # a view, not a copy
    assert torch.equal(g, cot.permute(2, 0, 1))
