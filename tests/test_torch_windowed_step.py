"""The port's windowed train steps on the CPU: a batch drawn as a composed
clip box ``(bp, eu, ev)`` (perspective, over the occupancy box, and MPI,
with the station extent pinned to the grid's), and the blocked step
``('blk', B, eu, ev)``, each against the port's unwindowed step on the
same batch and against the JAX package's windowed step; the MPI windows
also with dense and with sparse TV.

Windows are exact, so a windowed step and the unwindowed one differ by
f32 reassociation only. Tolerances, port against port, are the JAX
package's own for the same comparison: loss 1e-6 relative and parameters
5e-4 (``tests/test_dmpigo.py::test_tv_step_windows_match_full``; a first
Adam step turns f32 noise of gradients near zero into steps of up to that
size), and for the blocked step loss 3e-5 and parameters 5e-5 of their
scale (``tests/test_blocked_engine.py``). Port against JAX, the criteria
of ``tests/test_torch_dmpigo.py::test_train_step_matches_jax``: loss 1e-4
relative, parameters within 2% of the largest step and nearly all entries
within 1e-5. Both packages sweep in f32 here (the parity mode).
"""

import copy

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from directvoxgo_tpu.config import ConfigDict as JaxConfigDict
from directvoxgo_tpu.engine import train as jax_train
from directvoxgo_tpu.models.dmpigo import DirectMPIGO as JaxMPIGO
from directvoxgo_tpu.models.dvgo import DirectVoxGO as JaxDVGO
from directvoxgo_tpu_torch import convert
from directvoxgo_tpu_torch.config import ConfigDict as TorchConfigDict
from directvoxgo_tpu_torch.engine import train as torch_train
from directvoxgo_tpu_torch.engine.draws import Draws
from directvoxgo_tpu_torch.models.dmpigo import DirectMPIGO as TorchMPIGO
from directvoxgo_tpu_torch.models.dvgo import DirectVoxGO as TorchDVGO
from directvoxgo_tpu_torch.ops import sweep as sweep_ops


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(cls, n_rand, w_tv=0.0):
    return cls(N_rand=n_rand, weight_main=1.0, weight_entropy_last=0.001,
               weight_rgbper=0.01, weight_tv_density=w_tv, weight_tv_k0=w_tv,
               lrate_decay=20, lrate_density=1e-1, lrate_k0=1e-1,
               lrate_rgbnet=1e-3, skip_zero_grad_fields=["density", "k0"])


def _port_of(jm, cls):
    """The port's model with the JAX model's parameters and mask, f32."""
    tm = cls(**jm.get_kwargs(), device="cpu")
    tm.load_state_dict(convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jm.params), np.asarray(jm.mask)))
    tm.sweep_dtype, tm.mlp_dtype = torch.float32, None
    return tm


def _blob(jm, centre, radius, seed):
    rng = np.random.default_rng(seed)
    pts = np.asarray(jm.grid_points())
    r2 = (((pts - np.asarray(centre)) / radius) ** 2).sum(-1)
    jm.params["density"] = jnp.asarray(
        (16 * np.exp(-2 * r2) - 8).astype(np.float32))
    jm.params["k0"] = jnp.asarray(
        rng.normal(0, 0.5, jm.params["k0"].shape).astype(np.float32))
    jm.update_occupancy_cache()
    jm.sweep_dtype, jm.mlp_dtype = jnp.float32, None
    return jm


def _run(jm, tm, cfg_j, cfg_t, rk, tv, axis, key, off, pool, sel):
    """One port step and one JAX step of ``key`` at offsets ``off``:
    (port loss, port params, JAX loss, JAX params, params before)."""
    apply_tv, tv_dense = tv
    t_opt = torch_train.create_optimizer_or_freeze_model(tm, cfg_t)
    t_step = torch_train.make_train_step(tm, t_opt, cfg_t, rk, apply_tv,
                                         tv_dense, axis=axis,
                                         clip_sizes=key)
    before = jax.tree_util.tree_map(np.copy, convert.params_to_jax(tm)[0])
    loss_t, _ = t_step({k: torch.tensor(v) for k, v in pool.items()},
                       torch.tensor(sel), off)
    after, _ = convert.params_to_jax(tm)
    if jm is None:
        return float(loss_t), after, None, None, before
    j_opt = jax_train.create_optimizer_or_freeze_model(jm, cfg_j)
    j_step = jax_train.make_train_step(jm, j_opt, cfg_j, rk, apply_tv,
                                       tv_dense, axis=axis, clip_sizes=key)
    params, _, loss_j, _ = j_step(
        jm.params, jm.mask, j_opt.init(jm.params),
        {k: jnp.asarray(v) for k, v in pool.items()},
        jnp.asarray(sel, jnp.int32), jnp.asarray(off))
    return float(loss_t), after, float(loss_j), \
        jax.tree_util.tree_map(np.asarray, params), before


def _leaves(p):
    return ([p["density"], p["k0"]]
            + jax.tree_util.tree_leaves(p.get("rgbnet", {})))


def _assert_port_pair(loss_a, p_a, loss_b, p_b, loss_tol, param_tol):
    assert abs(loss_a - loss_b) <= loss_tol(loss_b), (loss_a, loss_b)
    for a, b in zip(_leaves(p_a), _leaves(p_b)):
        assert np.abs(np.asarray(a) - np.asarray(b)).max() < param_tol(b)


def _assert_port_jax(loss_t, p_t, loss_j, p_j, p0):
    assert abs(loss_t - loss_j) < 1e-4 * abs(loss_j)
    for name in ("density", "k0"):
        moved = np.abs(p_j[name] - p0[name]).max()
        assert moved > 1e-3, name
        err = np.abs(p_t[name] - p_j[name])
        assert err.max() < 2e-2 * moved, name
        assert np.mean(err < 1e-5) > 0.995, name
    for a, b in zip(jax.tree_util.tree_leaves(p_t["rgbnet"]),
                    jax.tree_util.tree_leaves(p_j["rgbnet"])):
        assert np.abs(a - b).max() < 2e-2 * 3 * 1e-3


def _oracle_tol():
    return (lambda ref: 1e-6 * max(1.0, abs(ref)), lambda ref: 5e-4)


@pytest.mark.parametrize("axis", [0, 2])
def test_perspective_2d_window_step(axis):
    """A Morton segment of a tight perspective fan, drawn as a composed
    box over the occupancy clip box (region mode), against the clip-box
    step and the JAX package's composed-box step."""
    jm = _blob(JaxDVGO(xyz_min=[-1] * 3, xyz_max=[1] * 3,
                       num_voxels=40 ** 3, num_voxels_base=40 ** 3,
                       alpha_init=1e-2, fast_color_thres=1e-4, rgbnet_dim=6,
                       rgbnet_direct=True, rgbnet_width=16, k_density=None,
                       k_color=0), [0.1, -0.05, 0.05], 0.75, 19)
    tm = _port_of(jm, TorchDVGO)
    n_rand = 512
    rng = np.random.default_rng(20)
    n = 6 * n_rand
    o = np.tile([[0.15, -0.1, 3.0]], (n, 1)).astype(np.float32)
    ang = rng.uniform(-0.04, 0.04, (n, 2))
    d = np.stack([np.tan(ang[:, 0]) + rng.uniform(-0.1, 0.1, n),
                  np.tan(ang[:, 1]), -np.ones(n)], -1).astype(np.float32)
    o, d = np.roll(o, axis - 2, 1), np.roll(d, axis - 2, 1)
    pool = {"rays_o": o, "rays_d": d,
            "viewdirs": d / np.linalg.norm(d, axis=-1, keepdims=True),
            "rgb": rng.uniform(0, 1, (n, 3)).astype(np.float32)}
    clip_sizes, clip_off = tm.sweep_clip_for_axis(axis, quantum=8)
    assert clip_sizes is not None
    (bp, bu, bv), offs = clip_sizes, np.asarray(clip_off)
    bk = sweep_ops.build_ray_segments_2d(
        o, d, tm.xyz_min, tm.xyz_max, tm.world_size, axis, n_rand=n_rand,
        widths=(16, 24, 32), clip_box=tuple(
            float(x) for a, b in zip(offs, (bp, bu, bv))
            for x in (a, a + b - 1)))
    key2d = next(k for k in bk if k != (0, 0)
                 and Draws._eff(k, bu, bv) != (bu, bv))
    eu, ev = Draws._eff(key2d, bu, bv)
    idx, ulo, vlo = bk[key2d]
    off = Draws._clamped(offs, (bu, bv), (eu, ev), ulo[0], vlo[0])
    sel = idx[0]
    ct, cj = _cfg(TorchConfigDict, n_rand), _cfg(JaxConfigDict, n_rand)
    rk = dict(near=0.5, far=6.0, bg=1.0, stepsize=0.5)
    lw, pw, lj, pj, p0 = _run(jm, tm, cj, ct, rk, (False, False), axis,
                              (bp, eu, ev), off, pool, sel)
    lf, pf, _, _, _ = _run(None, _port_of(jm, TorchDVGO), None, ct, rk,
                           (False, False), axis, clip_sizes, clip_off, pool,
                           sel)
    _assert_port_pair(lw, pw, lf, pf, *_oracle_tol())
    _assert_port_jax(lw, pw, lj, pj, p0)


@pytest.mark.parametrize("tv", ["none", "dense", "sparse"])
def test_mpi_2d_window_step(tv):
    """An MPI image tile drawn as a (gp, eu, ev) box at (0, u, v) (the
    station extent pinned to the grid's), with no TV, dense TV (full-size
    gradients) and sparse TV (region mode: the box form of K-F), against
    the unclipped step and the JAX package's windowed step."""
    jm = JaxMPIGO(xyz_min=[-1, -1, 0], xyz_max=[1, 1, 1],
                  num_voxels=48 * 48 * 32, mpi_depth=32,
                  fast_color_thres=1e-4, rgbnet_dim=6, rgbnet_width=16)
    rng = np.random.default_rng(3)
    jm.params["density"] = jnp.asarray(
        rng.normal(0, 1, jm.params["density"].shape).astype(np.float32))
    jm.params["k0"] = jnp.asarray(
        rng.normal(0, 0.5, jm.params["k0"].shape).astype(np.float32))
    jm.update_occupancy_cache()
    jm.sweep_dtype, jm.mlp_dtype = jnp.float32, None
    tm = _port_of(jm, TorchMPIGO)
    n = 256
    o = np.zeros((n, 3), np.float32)
    o[:, 0] = rng.uniform(0.1, 0.4, n)
    o[:, 1] = rng.uniform(-0.4, -0.1, n)
    d = np.zeros((n, 3), np.float32)
    d[:, :2] = rng.uniform(-0.05, 0.05, (n, 2))
    d[:, 2] = 1.0
    pool = {"rays_o": o, "rays_d": d,
            "viewdirs": d / np.linalg.norm(d, axis=-1, keepdims=True),
            "rgb": rng.uniform(0, 1, (n, 3)).astype(np.float32)}
    bk = sweep_ops.build_ray_segments_2d(
        o, d, tm.xyz_min, tm.xyz_max, tm.world_size, 2, n_rand=n,
        widths=(16, 24, 32), max_classes=4)
    gp, gu, gv = (int(tm.world_size[a]) for a in sweep_ops._PERMS[2])
    key2d = next(k for k in bk if k != (0, 0))
    eu, ev = Draws._eff(key2d, gu, gv)
    idx, ulo, vlo = bk[key2d]
    # a window start past the grid's last fitting row is shifted back
    off = Draws._clamped(np.zeros(3, np.int32), (gu, gv), (eu, ev),
                         ulo[0], vlo[0])
    sel = idx[0]
    ct, cj = _cfg(TorchConfigDict, n, 1e-2), _cfg(JaxConfigDict, n, 1e-2)
    rk = dict(near=0.0, far=1.0, bg=1.0, stepsize=1.0)
    tv_state = {"none": (False, False), "dense": (True, True),
                "sparse": (True, False)}[tv]
    lw, pw, lj, pj, p0 = _run(jm, tm, cj, ct, rk, tv_state, 2,
                              (gp, eu, ev), off, pool, sel)
    lf, pf, _, _, _ = _run(None, _port_of(jm, TorchMPIGO), None, ct, rk,
                           tv_state, 2, None, np.zeros(3, np.int32), pool,
                           sel)
    _assert_port_pair(lw, pw, lf, pf, *_oracle_tol())
    _assert_port_jax(lw, pw, lj, pj, p0)
    if tv == "dense":      # dense TV moves voxels outside the window too
        inside = np.zeros(tm.world_size, bool)
        inside[off[1]:off[1] + eu, off[2]:off[2] + ev, :] = True
        assert np.abs(pw["density"] - p0["density"])[~inside].max() > 0


def test_window_offsets_clamp_into_the_box():
    """A window overhanging the clip box is shifted back inside; one inside
    stays."""
    offs = np.asarray([3, 10, 20], np.int32)
    assert Draws._clamped(offs, (30, 40), (16, 24), 35, 50).tolist() \
        == [3, 24, 36]
    assert Draws._clamped(offs, (30, 40), (16, 24), 4, 5).tolist() \
        == [3, 10, 20]
    assert Draws._clamped(offs, (30, 40), (16, 24), 12, 25).tolist() \
        == [3, 12, 25]


def test_blocked_step_matches_plain():
    """A segment of two camera bundles drawn as ``('blk', B, eu, ev)`` with
    its [B, 2] per-block offsets: one K-A launch per block; the loss and
    the updated parameters as the plain unclipped step's, and as the JAX
    package's blocked step's."""
    jm = _blob(JaxDVGO(xyz_min=[-1] * 3, xyz_max=[1] * 3,
                       num_voxels=48 ** 3, num_voxels_base=48 ** 3,
                       alpha_init=1e-2, fast_color_thres=1e-4, rgbnet_dim=6,
                       rgbnet_direct=True, rgbnet_width=16, k_density=None,
                       k_color=0), [0.05, -0.1, 0.0], 0.6, 31)
    tm = _port_of(jm, TorchDVGO)
    rng = np.random.default_rng(32)
    n_rand = 512
    n = 4 * n_rand
    o = np.tile([[0.1, 0.1, 3.0]], (n, 1)).astype(np.float32)
    ang = rng.uniform(-0.12, 0.12, (n, 2))
    d = np.stack([np.tan(ang[:, 0]) + 0.05, np.tan(ang[:, 1]),
                  -np.ones(n)], -1).astype(np.float32)
    pool = {"rays_o": o, "rays_d": d,
            "viewdirs": d / np.linalg.norm(d, axis=-1, keepdims=True),
            "rgb": rng.uniform(0, 1, (n, 3)).astype(np.float32)}
    bk = sweep_ops.build_ray_segments_blocked(
        o, d, tm.xyz_min, tm.xyz_max, tm.world_size, 2, n_rand=n_rand,
        n_blocks=4, widths=(16, 24, 32, 40))
    wu, wv = next(k for k in bk if k != (0, 0))
    idx, uo, vo = bk[(wu, wv)]
    gu, gv = (int(tm.world_size[a]) for a in sweep_ops._PERMS[2][1:])
    key = ("blk", uo.shape[1], *Draws._eff((wu, wv), gu, gv))
    off = np.stack([uo[0], vo[0]], 1).astype(np.int32)
    ct, cj = _cfg(TorchConfigDict, n_rand), _cfg(JaxConfigDict, n_rand)
    rk = dict(near=0.5, far=6.0, bg=1.0, stepsize=0.5)
    from directvoxgo_tpu_torch.ops import sweep_fwd
    calls = []
    orig = sweep_fwd.sweep_fwd_plain

    def counted(*a, **k):
        calls.append(a[0].shape)
        return orig(*a, **k)

    sweep_fwd.sweep_fwd_plain = counted
    try:
        lb, pb, lj, pj, p0 = _run(jm, tm, cj, ct, rk, (False, False), 2,
                                  key, off, pool, idx[0])
    finally:
        sweep_fwd.sweep_fwd_plain = orig
    assert len(calls) == uo.shape[1] > 1
    assert all(c[1:3] == (key[2], key[3]) for c in calls)
    lp, pp, _, _, _ = _run(None, copy.deepcopy(_port_of(jm, TorchDVGO)),
                           None, ct, rk, (False, False), 2, None,
                           np.zeros(3, np.int32), pool, idx[0])
    _assert_port_pair(lb, pb, lp, pp, lambda ref: 3e-5,
                      lambda ref: 5e-5 * max(1.0, np.abs(ref).max()))
    _assert_port_jax(lb, pb, lj, pj, p0)
