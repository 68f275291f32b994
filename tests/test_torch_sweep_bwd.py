"""Kernel K-C (the station-sweep backward) and the windowed form of K-A,
through their plain PyTorch versions on the CPU, against the JAX package:
``jax.vjp`` of ``station_sweep`` in its full, segment and per-tile windowed
forms, the Pallas backward kernel ``sweep_bwd_pallas`` + ``fold_bwd_partials``
and the windowed ``sweep_fwd_pallas``, both in interpret mode. Inputs are
made once with numpy from a seed and handed to both packages.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from directvoxgo_tpu.ops import pallas_sweep_train as pst
from directvoxgo_tpu.ops import sweep as jax_sweep
from directvoxgo_tpu_torch.ops import sweep as torch_sweep
from directvoxgo_tpu_torch.ops import sweep_bwd as kc
from directvoxgo_tpu_torch.ops import sweep_fwd as ka

GP, GU, GV = 10, 12, 40
N = 2 * kc.TILE_N
# form -> (v_base, wv): per-tile windows [0,16) and [16,32); in the segment
# form the third entry is the whole batch's window [8, 32)
FORMS = {"full": (None, 0), "tile": ([0, 16], 16), "segment": ([0, 16, 8], 24)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, c, k, in_window=False):
    """Rays over (and a little beyond) a GP x GU x GV grid, both march
    directions, and a cotangent of which two thirds is exactly zero."""
    rng = np.random.default_rng(seed)
    s = k * (GP - 1) + 1
    if in_window:   # every ray of tile i keeps v inside its window
        ov = np.concatenate([rng.uniform(2, 12, kc.TILE_N),
                             rng.uniform(18, 28, kc.TILE_N)])
        dv = rng.uniform(-0.03, 0.03, N)
    else:
        ov, dv = rng.uniform(-1, GV, N), rng.uniform(-0.5, 0.5, N)
    rays = np.stack([
        rng.uniform(-2, GP + 2, N), rng.uniform(-1, GU, N), ov,
        rng.uniform(0.3, 1.0, N) * rng.choice([-1.0, 1.0], N),
        rng.uniform(-0.5, 0.5, N), dv]).astype(np.float32)
    cot = (rng.normal(size=(c, N, s))
           * (rng.uniform(size=(1, N, s)) < 0.33)).astype(np.float32)
    grid = rng.normal(size=(GP, GU, GV, c)).astype(np.float32)
    return grid, rays, cot, s


def _port_bwd(rays, cot, c, k, dtype, form, out_dtype=None):
    v_base, wv = FORMS[form]
    vb = None if v_base is None else torch.tensor(v_base, dtype=torch.int32)
    g = torch.tensor(cot).permute(2, 0, 1).contiguous()        # [S, C, N]
    return kc.sweep_bwd(g, torch.tensor(rays), k, (GP, GU, GV, c), dtype,
                        vb, wv, out_dtype=out_dtype)


@pytest.mark.parametrize("c,k", [(1, 1), (5, 2), (14, 2)])
@pytest.mark.parametrize("mode", ["f32", "bf16"])
@pytest.mark.parametrize("form", list(FORMS))
def test_sweep_bwd_plain_matches_jax_vjp(form, mode, c, k, monkeypatch):
    """The cotangent that ``jax.vjp`` of ``station_sweep`` returns for the
    same rays, windows and cotangent."""
    monkeypatch.setenv("DVGO_SWEEP_BWD_WINDOWED", "1")   # per-tile form on
    grid, rays, cot, _ = _inputs(11, c, k)
    jdt = jnp.float32 if mode == "f32" else jnp.bfloat16
    tdt = torch.float32 if mode == "f32" else torch.bfloat16
    v_base, wv = FORMS[form]
    rj = [jnp.asarray(r) for r in rays]
    vb_j = jnp.asarray(np.asarray(v_base or [], np.int32))

    def fwd(g):
        return jax_sweep.station_sweep(
            g, (tuple(rj[:3]), tuple(rj[3:])), vb_j, c, k, (GU, GV),
            (jdt, jdt), wv)[0]

    grid_j = jnp.asarray(grid.reshape(GP, GU, GV * c), jdt)
    ref = np.asarray(jax.vjp(fwd, grid_j)[1](jnp.asarray(cot))[0].astype(
        jnp.float32)).reshape(GP, GU, GV, c)
    out = _port_bwd(rays, cot, c, k, tdt, form).float().numpy()
    assert np.abs(ref).max() > 1.0
    if mode == "f32":
        # the same f32 products summed over rays in another order
        assert np.abs(out - ref).max() < 1e-5 * np.abs(ref).max()
    else:
        # same rounding points; the f32 sums differ in their last bits, so
        # after the cast to the bf16 grid dtype a voxel can be one bf16 ulp
        # (2^-8 relative, 2^-7 across a binade edge) off
        assert np.all(np.abs(out - ref) <= 2.0 ** -7 * np.abs(ref) + 1e-6)
    # voxels no ray touches stay exactly zero (skip_zero_grad tests g != 0)
    assert (ref == 0).any()
    assert np.array_equal(out == 0, ref == 0)


@pytest.mark.parametrize("c,k", [(1, 1), (5, 2), (14, 2)])
def test_sweep_bwd_plain_matches_pallas_interpret(c, k):
    """``sweep_bwd_pallas`` (bf16 hat rows and products, per-tile windows)
    in interpret mode, folded by ``fold_bwd_partials``."""
    _, rays, cot, s = _inputs(12, c, k, in_window=True)
    v_base, wv = FORMS["tile"]
    cp = pst._round_up(c, pst.C_TILE)
    s_pad = pst._round_up(s, pst.S_BLK)
    g_snc = jnp.pad(jnp.transpose(jnp.asarray(cot), (2, 1, 0)),
                    ((0, s_pad - s), (0, 0), (0, cp - c)))
    rp_t = jnp.concatenate([jnp.asarray(rays),
                            jnp.zeros((2, N), jnp.float32)]).T
    partials = pst.sweep_bwd_pallas(
        g_snc, rp_t, jnp.asarray(np.asarray(v_base, np.int32)), c=c, cp=cp,
        k=k, gu=GU, gv=GV, wv=wv, interpret=True)
    ref = np.asarray(pst.fold_bwd_partials(partials, GP, GU, GV, c, cp, k)
                     ).reshape(GP, GU, GV, c)
    out = _port_bwd(rays, cot, c, k, torch.bfloat16, "tile",
                    out_dtype=torch.float32).numpy()
    assert np.abs(ref).max() > 1.0
    # same bf16 operands; f32 sums over the rays in another order
    assert np.abs(out - ref).max() < 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("mode", ["f32", "bf16"])
def test_sweep_bwd_is_the_transpose_of_sweep_fwd(mode):
    """<sweep_fwd(grid), g> == <grid, sweep_bwd(g)> at k=1, where the
    station slabs are the grid slabs themselves (f32: to rounding; bf16: up
    to the rounding of ``wv * g``)."""
    c, k = 5, 1
    grid, rays, cot, _ = _inputs(13, c, k)
    dt = torch.float32 if mode == "f32" else torch.bfloat16
    slabs = torch.tensor(grid).to(dt)
    vals = ka.sweep_fwd(slabs, torch.tensor(rays), k)           # [S, C, N]
    g = torch.tensor(cot).permute(2, 0, 1).contiguous()
    lhs = float((vals.double() * g.double()).sum())
    d_grid = kc.sweep_bwd(g, torch.tensor(rays), k, (GP, GU, GV, c), dt,
                          out_dtype=torch.float32)
    rhs = float((slabs.double() * d_grid.double()).sum())
    assert abs(lhs) > 10.0
    assert abs(lhs - rhs) < (1e-5 if mode == "f32" else 2e-2) * abs(lhs)


def test_sweep_bwd_ignores_rays_parallel_to_the_stations():
    """``dp`` ~ 0 gives a huge ``t``: such rays add nothing, and no NaN."""
    c, k = 3, 2
    _, rays, cot, _ = _inputs(14, c, k)
    rays[3] = 1e-10
    out = _port_bwd(rays, cot, c, k, torch.float32, "full").numpy()
    assert np.all(out == 0.0)


@pytest.mark.parametrize("c,k", [(3, 2), (14, 1)])
def test_windowed_sweep_fwd_plain_matches_pallas_interpret(c, k):
    """``sweep_fwd_pallas(wv > 0)`` in interpret mode: each ray tile reads
    only its v-window of every slab."""
    grid, rays, _, s = _inputs(15, c, k)     # rays leave their windows too
    v_base, wv = FORMS["tile"]
    grid_p, cp = pst.pad_channels(
        jnp.asarray(grid.reshape(GP, GU, GV * c), jnp.bfloat16), c)
    slabs = jax_sweep._station_slabs(grid_p, k)
    s_pad = pst._round_up(s, pst.S_BLK)
    slabs = jnp.concatenate(
        [slabs, jnp.zeros((s_pad - s, GU, GV * cp), slabs.dtype)])
    rp = jnp.concatenate([jnp.asarray(rays), jnp.zeros((2, N), jnp.float32)])
    ref = np.asarray(pst.sweep_fwd_pallas(
        slabs, rp, jnp.asarray(np.asarray(v_base, np.int32)), c=c, cp=cp,
        k=k, gu=GU, gv=GV, wv=wv, interpret=True))[:s]
    t_slabs = torch_sweep._station_slabs(
        torch.tensor(grid).to(torch.bfloat16), k).contiguous()
    vb = torch.tensor(v_base, dtype=torch.int32)
    out = ka.sweep_fwd(t_slabs, torch.tensor(rays), k, vb, wv).numpy()
    full = ka.sweep_fwd(t_slabs, torch.tensor(rays), k).numpy()
    assert np.abs(out - full).max() > 0.1          # the window does cut
    assert np.abs(ref).max() > 0.1
    # the JAX package's own kernel-vs-scan bound
    assert np.abs(out - ref).max() < 1e-2


def test_station_sweep_function_returns_the_grid_dtype():
    """``station_sweep``'s backward hands autograd a cotangent in the
    permuted grid's dtype and none for the rays."""
    c, k = 5, 2
    grid, rays, cot, _ = _inputs(16, c, k)
    gperm = torch.tensor(grid).to(torch.bfloat16).requires_grad_()
    r = [torch.tensor(x).requires_grad_() for x in rays]
    vals, t = torch_sweep.station_sweep(gperm, (tuple(r[:3]), tuple(r[3:])),
                                        k)
    assert vals.shape == cot.shape and not t.requires_grad
    (vals * torch.tensor(cot)).sum().backward()
    assert gperm.grad.dtype == torch.bfloat16
    assert all(x.grad is None for x in r)
    ref = _port_bwd(rays, cot, c, k, torch.bfloat16, "full")
    assert torch.equal(gperm.grad, ref)
