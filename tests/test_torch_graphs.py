"""Step batching on the CPU: the JAX engine's chunk rule and chunk draws,
its no-window rule, an 8-step chunk against the JAX package's scanned step,
train steps that read their offsets as device data at every call, MaskedAdam
with its step count on the device, the launch counters that count per
replay, and K-F's path rule for device offsets.

On the CPU every step runs eagerly (``StepGraphs`` on a CPU device); the
CUDA graphs themselves run only on the card, where ``chip_smoke.py`` holds
graphed steps against eager ones. Inputs are made with numpy from a seed and
handed to both packages.
"""

import collections
import copy
import os
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from directvoxgo_tpu import rays as jax_rays
from directvoxgo_tpu.config import Config as JaxConfig
from directvoxgo_tpu.engine import train as jax_train
from directvoxgo_tpu.models.dvgo import DirectVoxGO as JaxDVGO
from directvoxgo_tpu.ops import sweep as jax_sweep
from directvoxgo_tpu.optim import MaskedAdam as JaxAdam
from directvoxgo_tpu_torch import convert
from directvoxgo_tpu_torch.config import Config as TorchConfig
from directvoxgo_tpu_torch.config import ConfigDict
from directvoxgo_tpu_torch.data.synthetic import make_synthetic_dataset
from directvoxgo_tpu_torch.engine import draws as draws_lib
from directvoxgo_tpu_torch.engine import graphs as graphs_lib
from directvoxgo_tpu_torch.engine import train as torch_train
from directvoxgo_tpu_torch.models.dmpigo import DirectMPIGO as TorchMPIGO
from directvoxgo_tpu_torch.models.dvgo import DirectVoxGO as TorchDVGO
from directvoxgo_tpu_torch.ops import grid as grid_ops
from directvoxgo_tpu_torch.ops import sweep as sweep_ops
from directvoxgo_tpu_torch.ops import tv as torch_tv
from directvoxgo_tpu_torch.optim import MaskedAdam as TorchAdam

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_CFG = os.path.join(REPO, "configs", "default.py")
RK = dict(near=0.5, far=8.0, bg=1.0, stepsize=0.5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ------------------------------------------------------------ the chunks

def _jax_chunk_len(i, n_dispatch, cfg_train, pg_set, tv_state_of, args):
    """The JAX engine's chunk_len (engine/train.py:1575-1593), copied."""
    length = 1
    while length < n_dispatch:
        j = i + length
        if (j > cfg_train.N_iters or j in pg_set
                or (j + 500) % 1000 == 0
                or tv_state_of(j) != tv_state_of(i)
                or (j - 1) % args.i_print == 0
                or (j - 1) % args.i_weights == 0):
            break
        length += 1
    return length if length == n_dispatch else 1


@pytest.mark.parametrize("n_dispatch", [8, 3, 1])
def test_chunk_len_matches_the_jax_rule(n_dispatch):
    """The schedule of ``tests/test_train_e2e.py::
    test_step_batch_chunks_respect_event_boundaries``: every chunk's length
    is the JAX rule's, quantised to {1, n_dispatch}; no event inside a
    chunk, prints and checkpoints only at its end, every step once."""
    ct = ConfigDict(N_iters=3000, pg_scale=[1000, 2000], tv_before=1e9,
                    tv_after=0, tv_every=1, tv_dense_before=1500,
                    weight_tv_density=1e-6, weight_tv_k0=0.0)
    args = types.SimpleNamespace(i_print=50, i_weights=700)
    pg_set = set(ct.pg_scale)

    def tv_state_of(j):
        apply_tv = (j < ct.tv_before and j > ct.tv_after
                    and j % ct.tv_every == 0
                    and (ct.weight_tv_density > 0 or ct.weight_tv_k0 > 0))
        return (apply_tv, j < ct.tv_dense_before)

    covered, lengths, i = [], collections.Counter(), 1
    while i <= ct.N_iters:
        n = torch_train.chunk_len(i, n_dispatch, ct.N_iters, pg_set,
                                  tv_state_of, args.i_print, args.i_weights)
        assert n == _jax_chunk_len(i, n_dispatch, ct, pg_set, tv_state_of,
                                   args)
        chunk = list(range(i, i + n))
        for j in chunk[1:]:
            assert j not in pg_set and (j + 500) % 1000 != 0
            assert tv_state_of(j) == tv_state_of(i)
        for j in chunk[:-1]:
            assert j % args.i_print != 0 and j % args.i_weights != 0
        covered.extend(chunk)
        lengths[n] += 1
        i += n
    assert covered == list(range(1, ct.N_iters + 1))
    assert set(lengths) <= {1, n_dispatch}
    if n_dispatch > 1:
        # whole chunks carry most steps; the edges run singly
        assert lengths[n_dispatch] * n_dispatch > 0.8 * ct.N_iters


@pytest.mark.parametrize("voxels,spd,width", [
    (100 ** 3, None, 8), (104 ** 3, None, 1), (100 ** 3, 4, 4),
    (128 ** 3, 8, 8), (32 ** 3, 0, 1)])
def test_dispatch_width_is_the_jax_rule(voxels, spd, width):
    """``Draws.dispatch_width``: 8 up to 1.1 M voxels, 1 above, or the
    stage's ``steps_per_dispatch`` (at least 1); windows engage at 1."""
    cfg = ConfigDict(N_rand=512, **({} if spd is None
                                    else {"steps_per_dispatch": spd}))
    draws = types.SimpleNamespace(
        model=types.SimpleNamespace(world_size=(voxels, 1, 1)),
        cfg_train=cfg)
    assert draws_lib.Draws.dispatch_width(draws) == width
    assert draws_lib.Draws.windows_engage(draws) is (width == 1)


def _rays_3groups(seed, n):
    """Rays from all sides of a unit box, so that every axis has a group."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = (-3.0 * d + rng.uniform(-0.2, 0.2, (n, 3))).astype(np.float32)
    return o, d


def _tiny_dvgo(**kw):
    base = dict(xyz_min=[-1] * 3, xyz_max=[1] * 3, num_voxels=16 ** 3,
                num_voxels_base=16 ** 3, alpha_init=1e-2,
                fast_color_thres=1e-4, rgbnet_dim=6, rgbnet_direct=True,
                rgbnet_width=16, k_density=None, k_color=0, device="cpu")
    base.update(kw)
    return TorchDVGO(**base)


def test_chunk_draws_match_the_jax_steady_state():
    """From one seed, the port's chunks consume the generator as the JAX
    engine's steady state (all axes ready): one ``rng.choice(3,
    p=group_p)`` a chunk, then the chunk's batches from that group's
    shuffled generator: the same axes and the same index batches."""
    model = _tiny_dvgo()
    o, d = _rays_3groups(1, 3000)
    n_rand = 128
    clip_plan = {ax: (None, np.zeros(3, np.int32)) for ax in range(3)}
    draws = draws_lib.Draws(model, ConfigDict(N_rand=n_rand),
                            ConfigDict(stepsize=0.5), o, d, 0.5, 6.0,
                            np.random.default_rng(11), clip_plan, "cpu",
                            "fine")
    draws.set_grid()
    assert draws.n_dispatch == 8 and not draws.windowed
    # the JAX engine's groups and generators
    groups = jax_sweep.dominant_axis(d, model.xyz_min, model.xyz_max,
                                     model.world_size)
    group_idx = [np.flatnonzero(groups == ax) for ax in range(3)]
    for a, b in zip(group_idx, draws.group_idx):
        np.testing.assert_array_equal(a, b)
    assert all(len(g) >= n_rand for g in group_idx)
    rng = np.random.default_rng(11)
    p = np.array([len(g) for g in group_idx], np.float64)
    group_p = p / p.sum()
    gens = [(g, jax_rays.batch_indices_generator(len(g), n_rand, rng=rng))
            for g in group_idx]
    axes = set()
    for n_sub in [8, 1, 8, 8, 1, 1, 8, 8, 8, 1, 8, 8]:
        sels, ax, key, offs = draws.next_chunk(n_sub, apply_tv=False)
        want_ax = int(rng.choice(3, p=group_p))
        want = [gens[want_ax][0][np.asarray(next(gens[want_ax][1]))]
                for _ in range(n_sub)]
        assert (ax, key, offs) == (want_ax, None, None)
        assert sels.shape == (n_sub, n_rand)
        np.testing.assert_array_equal(sels, np.stack(want))
        assert np.all(np.isin(sels, group_idx[ax]))
        axes.add(ax)
    assert len(axes) == 3


class _FakeTiles:
    """A fused tile bucket for ``Draws._buckets_of``: one (16, 16) class."""

    def __init__(self, draws):
        self.draws, self.calls = draws, 0

    def __call__(self, ax):
        self.calls += 1
        g = self.draws.group_idx[ax]
        return {("fblk", 16, 16, 1): g[:2 * 512].reshape(2, 512)}


@pytest.mark.parametrize("spd", [None, 1])
def test_no_window_or_fused_tile_while_the_width_is_above_one(
        spd, monkeypatch):
    """The fused trainer on a grid of up to 1.1 M voxels: at the default
    dispatch width of 8 no batch takes a fused tile (or any window class;
    the buckets are not even consulted), as in the JAX engine; with
    ``steps_per_dispatch`` 1 the tiles draw, except on TV steps."""
    monkeypatch.setenv("DVGO_FUSED_TRAIN", "force")
    model = _tiny_dvgo(rgbnet_depth=3)
    assert model.supports_fused_step()
    o, d = _rays_3groups(2, 6000)
    clip_plan = {ax: (None, np.zeros(3, np.int32)) for ax in range(3)}
    cfg = ConfigDict(N_rand=512, **({} if spd is None
                                    else {"steps_per_dispatch": spd}))
    draws = draws_lib.Draws(model, cfg, ConfigDict(stepsize=0.5), o, d, 0.5,
                            6.0, np.random.default_rng(3), clip_plan, "cpu",
                            "fine")
    draws.set_grid()
    assert draws.fused_tiles
    tiles = _FakeTiles(draws)
    monkeypatch.setattr(draws, "_buckets_of", tiles)
    keys = [draws.next_chunk(1, apply_tv=False)[2] for _ in range(20)]
    tv_keys = [draws.next_chunk(1, apply_tv=True)[2] for _ in range(5)]
    # a chunk of several steps is always uniform
    assert all(draws.next_chunk(2, apply_tv=False)[2] is None
               for _ in range(5))
    assert all(k is None for k in tv_keys)
    if spd is None:
        assert draws.n_dispatch == 8 and not draws.windowed
        assert keys == [None] * 20 and tiles.calls == 0
    else:
        assert draws.n_dispatch == 1 and draws.windowed
        assert all(k is not None and k[:3] == ("fblk", 16, 16)
                   for k in keys)


def test_stage_runs_chunks_and_re_evaluates_the_width(tmp_path, monkeypatch,
                                                      capsys):
    """A fine stage whose grid crosses the window threshold at its
    progressive rescale (the threshold set between the two sizes): chunks
    of 8 on one axis before it, as the JAX rule cuts them, single window
    steps after it; progress lines on the ``i_print`` steps."""
    monkeypatch.setattr(draws_lib, "SMALL_GRID_VOXELS", 20000)
    monkeypatch.setattr(draws_lib, "WINDOW_WIDTHS", (8, 12, 16, 24))
    data = make_synthetic_dataset(n_train=10, n_val=1, n_test=2, H=40, W=40)
    cfg = TorchConfig.fromfile(DEFAULT_CFG)
    cfg.expname, cfg.basedir = "chunks", str(tmp_path)
    cfg.data.dataset_type, cfg.data.white_bkgd = "synthetic_fixture", True
    cfg.coarse_train.N_iters = 0
    ft = cfg.fine_train
    ft.N_iters, ft.N_rand, ft.pg_scale = 60, 512, [30]
    ft.ray_sampler, ft.pervoxel_lr = "flatten", False
    fm = cfg.fine_model_and_render
    fm.num_voxels = fm.num_voxels_base = 32 ** 3    # 25^3 before the rescale
    fm.rgbnet_dim, fm.rgbnet_width = 6, 16
    runs = []
    orig = graphs_lib.StepGraphs.run

    def recording(self, key, step, pool, sels, offs, eager=False):
        runs.append((key, sels.shape[0], self.graphed))
        return orig(self, key, step, pool, sels, offs, eager)

    monkeypatch.setattr(graphs_lib.StepGraphs, "run", recording)
    args = types.SimpleNamespace(seed=777, no_reload=True,
                                 no_reload_optimizer=False, ft_path="",
                                 i_print=10, i_weights=100000)
    xyz_min, xyz_max = np.array([-1.2] * 3), np.array([1.2] * 3)
    os.makedirs(os.path.join(cfg.basedir, cfg.expname))
    torch_train.scene_rep_reconstruction(
        args, cfg, fm, ft, xyz_min, xyz_max, data, "fine", device="cpu")
    out = capsys.readouterr().out
    step, before, after = 0, [], []
    for key, n, graphed in runs:
        assert not graphed
        (before if step < 29 else after).append((key, n))
        step += n
    assert step == 60
    # steps 1-29: chunks cut at the prints (10, 20) and at step 29 (the
    # rescale at 30): 8 + 1 + 1 / 8 + 1 + 1 / 8 + 1
    assert [n for _, n in before] == [8, 1, 1, 8, 1, 1, 8, 1]
    assert all(key[1] is None or len(key[1]) == 3 and key[1][0] != "blk"
               for key, _ in before)
    assert [n for _, n in after] == [1] * 31
    assert any(key[1] is not None for key, _ in after)
    for it in (10, 20, 30, 40, 50, 60):
        assert f"iter {it:6d}" in out


# --------------------------------------------- an 8-step chunk against JAX

GRID_KW = dict(xyz_min=[-1.6, -1.0, -0.5], xyz_max=[1.6, 1.0, 0.5],
               num_voxels=64 * 40 * 20, num_voxels_base=64 * 40 * 20)


def _model_pair(seed):
    """A JAX fine model with a blob of density and the port's model with
    the same parameters and mask, both in the f32 parity mode."""
    rng = np.random.default_rng(seed)
    jm = JaxDVGO(alpha_init=1e-2, fast_color_thres=1e-4, rgbnet_dim=6,
                 rgbnet_direct=True, rgbnet_depth=3, rgbnet_width=16,
                 k_density=None, k_color=0, sweep_color_topk=0, **GRID_KW)
    pts = np.asarray(jm.grid_points())
    dens = (12.0 * np.exp(-(pts[..., 0] / 1.1) ** 2
                          - (pts[..., 1] / 0.35) ** 2
                          - (pts[..., 2] / 0.3) ** 2) - 8.0)
    jm.params["density"] = jnp.asarray(
        (dens + rng.normal(0, 0.5, dens.shape)).astype(np.float32))
    jm.params["k0"] = jnp.asarray(rng.normal(
        0, 0.5, jm.params["k0"].shape).astype(np.float32))
    jm.update_occupancy_cache()
    tm = TorchDVGO(**jm.get_kwargs(), device="cpu")
    tm.load_state_dict(convert.params_from_jax(_np_tree(jm.params),
                                               np.asarray(jm.mask)))
    jm.sweep_dtype, jm.mlp_dtype = jnp.float32, None
    tm.sweep_dtype, tm.mlp_dtype = torch.float32, None
    return jm, tm


def _rays_x(seed, n):
    rng = np.random.default_rng(seed)
    ro = np.stack([np.where(rng.uniform(size=n) < 0.5, -3.0, 3.0),
                   rng.uniform(-0.3, 0.3, n), rng.uniform(-0.3, 0.3, n)],
                  -1).astype(np.float32)
    rd = np.stack([-np.sign(ro[:, 0]), rng.uniform(-0.15, 0.15, n),
                   rng.uniform(-0.15, 0.15, n)], -1).astype(np.float32)
    vd = rd / np.linalg.norm(rd, axis=-1, keepdims=True)
    rgb = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    return ro, rd, vd.astype(np.float32), rgb


def test_eight_step_chunk_matches_the_jax_scanned_step():
    """An 8-step chunk of the port (``StepGraphs.run`` on the CPU: eight
    eager steps) against ``make_train_step(..., n_steps=8)`` of the JAX
    package (one ``lax.scan``) from the same parameters, mask and optimizer
    state with the same 8 batches, fine style (region mode, box-sized
    Adam). The tolerances of ``tests/test_torch_train.py::
    test_three_train_steps_match_jax``: loss 1e-4 relative and PSNR 1e-3
    per step, parameters within 2% of the largest step (nearly all entries
    within 1e-5), second moments 1e-3 of their largest entry."""
    jm, tm = _model_pair(3)
    axis, n_rand, n_pool = 0, 128, 1024
    ro, rd, vd, rgb = _rays_x(4, n_pool)
    jcfg, tcfg = JaxConfig.fromfile(DEFAULT_CFG), TorchConfig.fromfile(
        DEFAULT_CFG)
    j_ct, t_ct = jcfg.fine_train, tcfg.fine_train
    j_ct.N_rand = t_ct.N_rand = n_rand
    clip_sizes, clip_off = jm.sweep_clip_for_axis(axis)
    assert clip_sizes is not None
    assert clip_sizes == tm.sweep_clip_for_axis(axis)[0]
    j_opt = jax_train.create_optimizer_or_freeze_model(jm, j_ct)
    j_state = j_opt.init(jm.params)
    t_opt = torch_train.create_optimizer_or_freeze_model(tm, t_ct)
    j_state = dict(j_state, step=jnp.asarray(3, jnp.int32))
    convert.opt_state_from_jax(_np_tree(j_state), t_opt)

    j_step = jax_train.make_train_step(jm, j_opt, j_ct, RK, False, False,
                                       axis=axis, clip_sizes=clip_sizes,
                                       n_steps=8)
    t_step = torch_train.make_train_step(tm, t_opt, t_ct, RK, False, False,
                                         axis=axis, clip_sizes=clip_sizes)
    j_pool = {"rgb": jnp.asarray(rgb), "rays_o": jnp.asarray(ro),
              "rays_d": jnp.asarray(rd), "viewdirs": jnp.asarray(vd)}
    t_pool = {k: torch.tensor(np.asarray(v)) for k, v in j_pool.items()}
    sels = np.stack([np.random.default_rng(10 + i).permutation(n_pool)[
        :n_rand] for i in range(8)])
    p0 = np.asarray(jm.params["density"]).copy()
    params, j_state, losses, psnrs = j_step(
        jm.params, jm.mask, j_state, j_pool, jnp.asarray(sels, jnp.int32),
        jnp.asarray(clip_off))
    steps = graphs_lib.StepGraphs("cpu")
    steps.reset()
    res = steps.run((axis, clip_sizes), t_step, t_pool, sels,
                    np.broadcast_to(np.asarray(clip_off), (8, 3)))
    assert steps.stats == {"eager": 8}
    res = res.numpy()
    np.testing.assert_array_less(np.abs(res[:, 0] - np.asarray(losses)),
                                 1e-4 * np.asarray(losses))
    np.testing.assert_array_less(np.abs(res[:, 1] - np.asarray(psnrs)),
                                 1e-3)

    t_state = convert.opt_state_to_jax(t_opt)
    assert int(t_state["step"]) == int(j_state["step"]) == 11
    t_params, _ = convert.params_to_jax(tm)
    moved = np.abs(np.asarray(params["density"]) - p0).max()
    assert moved > 1e-3
    for name in ("density", "k0"):
        err = np.abs(t_params[name] - np.asarray(params[name]))
        assert err.max() < 2e-2 * moved, name
        assert np.mean(err < 1e-5) > 0.995, name
    for a, b in zip(jax.tree_util.tree_leaves(t_params["rgbnet"]),
                    jax.tree_util.tree_leaves(params["rgbnet"])):
        assert np.abs(a - np.asarray(b)).max() < 2e-2 * 3 * 1e-3
    for a, b in zip(jax.tree_util.tree_leaves(t_state["exp_avg_sq"]),
                    jax.tree_util.tree_leaves(j_state["exp_avg_sq"])):
        b = np.asarray(b)
        assert np.abs(a - b).max() < 1e-3 * np.abs(b).max()


# ------------------------------------- offsets read at every call

def _blob_dvgo(seed, n=24):
    rng = np.random.default_rng(seed)
    tm = _tiny_dvgo(num_voxels=n ** 3, num_voxels_base=n ** 3)
    pts = tm.grid_points().numpy()
    r2 = ((pts - np.asarray([0.1, -0.05, 0.05])) ** 2).sum(-1) / 0.6
    with torch.no_grad():
        tm.density.copy_(torch.tensor(16 * np.exp(-2 * r2) - 8))
        tm.k0.copy_(torch.tensor(rng.normal(0, 0.5, tm.k0.shape)))
    tm.update_occupancy_cache()
    tm.sweep_dtype, tm.mlp_dtype = torch.float32, None
    return tm


def _mpi(seed):
    rng = np.random.default_rng(seed)
    tm = TorchMPIGO(xyz_min=[-1, -1, 0], xyz_max=[1, 1, 1],
                    num_voxels=24 * 24 * 16, mpi_depth=16,
                    fast_color_thres=1e-4, rgbnet_dim=6, rgbnet_width=16,
                    device="cpu")
    with torch.no_grad():
        tm.density.copy_(torch.tensor(rng.normal(0, 1, tm.density.shape)))
        tm.k0.copy_(torch.tensor(rng.normal(0, 0.5, tm.k0.shape)))
    tm.update_occupancy_cache()
    tm.sweep_dtype, tm.mlp_dtype = torch.float32, None
    return tm


def _cfg(n_rand, w_tv=0.0):
    return ConfigDict(N_rand=n_rand, weight_main=1.0,
                      weight_entropy_last=0.001, weight_rgbper=0.01,
                      weight_tv_density=w_tv, weight_tv_k0=w_tv,
                      lrate_decay=20, lrate_density=1e-1, lrate_k0=1e-1,
                      lrate_rgbnet=1e-3,
                      skip_zero_grad_fields=["density", "k0"])


def _case(kind):
    """(model, axis, key, tv state, offsets A, offsets B, rays, rk)."""
    n = 256
    rng = np.random.default_rng(5)
    if kind == "boxed_tv":
        tm = _mpi(6)
        o = np.zeros((n, 3), np.float32)
        o[:, :2] = rng.uniform(-0.5, 0.5, (n, 2))
        d = np.zeros((n, 3), np.float32)
        d[:, :2] = rng.uniform(-0.05, 0.05, (n, 2))
        d[:, 2] = 1.0
        gp, gu, gv = (int(tm.world_size[a]) for a in sweep_ops._PERMS[2])
        return (tm, 2, (gp, 12, 16), (True, False), [0, 3, 5], [0, 9, 2],
                o, d, dict(near=0.0, far=1.0, bg=1.0, stepsize=1.0))
    tm = _blob_dvgo(7)
    o = np.tile([[0.1, 0.05, 3.0]], (n, 1)).astype(np.float32)
    ang = rng.uniform(-0.15, 0.15, (n, 2))
    d = np.stack([np.tan(ang[:, 0]), np.tan(ang[:, 1]), -np.ones(n)],
                 -1).astype(np.float32)
    rk = dict(near=0.5, far=6.0, bg=1.0, stepsize=0.5)
    if kind == "window":
        return (tm, 2, (24, 16, 12), (False, False), [0, 4, 6], [0, 7, 10],
                o, d, rk)
    nb = len(sweep_ops.blocked_p_rows(24, 3))
    a = np.stack([np.arange(nb) % 5, 8 - np.arange(nb) % 4], 1)
    return (tm, 2, ("blk", nb, 12, 16), (False, False), a.tolist(),
            (a[::-1] + [2, -2]).tolist(), o, d, rk)


@pytest.mark.parametrize("kind", ["window", "blocked", "boxed_tv"])
def test_a_step_reads_its_offsets_at_every_call(kind):
    """One step object called with the same static input tensors (as a CUDA
    graph's replays find them), first holding offsets A, then rewritten in
    place to offsets B and another batch, against a fresh step at A and a
    fresh one at B on a copy of the model: the same parameters and moments,
    bit for bit (the same arithmetic, on the CPU). B moves the parameters
    otherwise than A again would, so a step that kept A would show."""
    tm, axis, key, tv, off_a, off_b, o, d, rk = _case(kind)
    n = o.shape[0]
    rng = np.random.default_rng(8)
    pool = {"rays_o": torch.tensor(o), "rays_d": torch.tensor(d),
            "viewdirs": torch.tensor(d / np.linalg.norm(d, axis=-1,
                                                        keepdims=True)),
            "rgb": torch.tensor(rng.uniform(0, 1, (n, 3)).astype(
                np.float32))}
    sel_a, sel_b = rng.permutation(n)[:128], rng.permutation(n)[:128]
    ct = _cfg(128, 1e-2 if tv[0] else 0.0)

    def trained(calls):
        m = copy.deepcopy(tm)
        opt = torch_train.create_optimizer_or_freeze_model(m, ct)
        for step, sel, off in calls(m, opt):
            step(pool, sel, off)
        return (convert.params_to_jax(m)[0],
                convert.opt_state_to_jax(opt))

    def make(m, opt):
        return torch_train.make_train_step(m, opt, ct, rk, *tv, axis=axis,
                                           clip_sizes=key)

    def static(m, opt):
        step = make(m, opt)
        sel_buf = torch.tensor(sel_a)
        off_buf = torch.tensor(np.asarray(off_a, np.int32))
        yield step, sel_buf, off_buf
        sel_buf.copy_(torch.tensor(sel_b))
        off_buf.copy_(torch.tensor(np.asarray(off_b, np.int32)))
        yield step, sel_buf, off_buf

    def fresh(offs):
        def calls(m, opt):
            for sel, off in zip((sel_a, sel_b), offs):
                yield make(m, opt), torch.tensor(sel), np.asarray(off,
                                                                  np.int32)
        return calls

    got, want = trained(static), trained(fresh((off_a, off_b)))
    again = trained(fresh((off_a, off_a)))
    for a, b, c in zip(jax.tree_util.tree_leaves(got),
                       jax.tree_util.tree_leaves(want),
                       jax.tree_util.tree_leaves(again)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert any(not np.array_equal(np.asarray(b), np.asarray(c))
               for b, c in zip(jax.tree_util.tree_leaves(want[0]),
                               jax.tree_util.tree_leaves(again[0])))


# ------------------------------------------- MaskedAdam's device scalars

def test_masked_adam_keeps_its_step_on_the_device():
    """The step count is a 0-d int64 tensor that the update advances in
    place, and the decayed, bias-corrected step size is made from it:
    five steps with lr decay and a box region given as device offsets
    (``DeviceBox``) match the JAX package's optimizer (2e-6 relative, the
    tolerance of ``tests/test_torch_optim.py``); the state goes through the
    JAX layout as the integer 5 and back, and both optimizers' sixth steps
    then agree bit for bit."""
    rng = np.random.default_rng(12)
    grid, (offs, sizes) = (6, 7, 8), ((1, 2, 3), (4, 3, 4))
    box = tuple(slice(o, o + s) for o, s in zip(offs, sizes))
    density = rng.normal(size=grid).astype(np.float32)
    k0 = rng.normal(size=(*grid, 3)).astype(np.float32)
    decay = 0.1 ** (1.0 / 20.0)
    lrs = {"density": 0.1, "k0": 0.05}

    def torch_opt(d, k):
        return TorchAdam({n: {"params": [torch.tensor(x)], "lr": lrs[n],
                              "skip_zero_grad": True}
                          for n, x in (("density", d), ("k0", k))},
                         lr_decay_factor=decay)

    j_opt = JaxAdam({n: {"lr": lr, "skip_zero_grad": True}
                     for n, lr in lrs.items()}, lr_decay_factor=decay)
    j_params = {"density": jnp.asarray(density), "k0": jnp.asarray(k0)}
    j_state = j_opt.init(j_params)
    t_opt = torch_opt(density, k0)
    step_t = t_opt.state["step"]
    assert step_t.dtype == torch.int64 and step_t.dim() == 0
    dbox = grid_ops.DeviceBox(torch.tensor(offs, dtype=torch.int32), sizes,
                              grid)
    grads = []
    for _ in range(6):
        keep = np.zeros(grid, bool)
        keep[box] = rng.uniform(size=sizes) < 0.7
        grads.append((rng.normal(size=grid).astype(np.float32) * keep,
                      rng.normal(size=(*grid, 3)).astype(np.float32)
                      * keep[..., None]))
    for g_d, g_k in grads[:5]:
        j_params, j_state = j_opt.update(
            j_params, {"density": jnp.asarray(g_d), "k0": jnp.asarray(g_k)},
            j_state, regions={n: (jnp.asarray(offs, jnp.int32), sizes)
                              for n in lrs})
        t_opt.step({"density": [torch.tensor(g_d[box])],
                    "k0": [torch.tensor(g_k)]},
                   regions={n: dbox for n in lrs})
    assert t_opt.state["step"] is step_t and int(step_t) == 5
    for name in lrs:
        np.testing.assert_allclose(
            t_opt.groups[name]["params"][0].numpy(),
            np.asarray(j_params[name]), rtol=2e-6, atol=2e-6)
    state = convert.opt_state_to_jax(t_opt)
    assert state["step"].dtype == np.int32 and int(state["step"]) == 5
    t2 = torch_opt(density, k0)
    for name in lrs:
        t2.groups[name]["params"][0].copy_(t_opt.groups[name]["params"][0])
    convert.opt_state_from_jax(state, t2)
    assert int(t2.state["step"]) == 5
    g_d, g_k = grads[5]
    for opt in (t_opt, t2):
        opt.step({"density": [torch.tensor(g_d)], "k0": [torch.tensor(g_k)]},
                 regions={n: dbox for n in lrs})
    for name in lrs:
        np.testing.assert_array_equal(t_opt.groups[name]["params"][0],
                                      t2.groups[name]["params"][0])
    assert int(t2.state["step"]) == 6


# ------------------------------------------------------- device boxes

@pytest.mark.parametrize("perm,channels", [((0, 1, 2), 0), ((1, 2, 0), 3),
                                           ((2, 0, 1), 12)])
def test_device_box_reads_writes_and_differentiates_like_a_slice(
        perm, channels):
    """A box at device offsets (given in the sweep's permuted order) reads
    the grid's slice, writes into exactly that slice, and its gradient is
    the box's cotangent in zeros of the full size."""
    rng = np.random.default_rng(len(perm) + channels)
    dims, sizes = (7, 9, 8), (3, 4, 5)
    shape = dims + ((channels,) if channels else ())
    grid = torch.tensor(rng.normal(size=shape).astype(np.float32))
    for start in ((0, 0, 0), (4, 5, 3), (2, 1, 3)):
        box = tuple(slice(o, o + s) for o, s in zip(start, sizes))
        off = torch.tensor([start[a] for a in perm], dtype=torch.int32)
        dbox = grid_ops.DeviceBox(off, sizes, dims, perm)
        src = grid.clone().requires_grad_(True)
        got = dbox.take(src)
        assert torch.equal(got, grid[box])
        cot = torch.tensor(rng.normal(size=got.shape).astype(np.float32))
        (g,) = torch.autograd.grad(got, src, cot)
        want = torch.zeros_like(grid)
        want[box] = cot
        assert torch.equal(g, want)
        dst = grid.clone()
        dbox.put(dst, cot)
        want = grid.clone()
        want[box] = cot
        assert torch.equal(dst, want)


# ------------------------------------------------ counters, K-F's rule

def test_replay_counters_take_back_the_capture_and_count_each_replay(
        monkeypatch):
    """What a capture counted is taken back (it launched nothing) and added
    again per replay, for plain counters and counters by form."""
    mod = types.SimpleNamespace(launches=3,
                                by_form=collections.Counter(a=1))
    monkeypatch.setattr(graphs_lib, "COUNTERS",
                        [(mod, "launches"), (mod, "by_form")])
    form_dict = mod.by_form
    before = graphs_lib._counts()
    mod.launches += 2                      # a capture's wrapper calls
    mod.by_form["a"] += 1
    mod.by_form["b"] += 1
    after = graphs_lib._counts()
    graphs_lib._restore(before)
    delta = graphs_lib._delta(before, after)
    assert (mod.launches, dict(mod.by_form)) == (3, {"a": 1})
    for _ in range(4):                     # four replays
        graphs_lib._add(delta)
    assert (mod.launches, dict(mod.by_form)) == (11, {"a": 5, "b": 4})
    assert mod.by_form is form_dict        # changed in place


@pytest.mark.parametrize("c,sizes,dims,want", [
    (1, (8, 8, 16), (16, 16, 16), "rows"),      # spans z: only oz = 0
    (1, (8, 8, 12), (16, 16, 16), "strided"),   # oz may be odd
    (9, (8, 8, 16), (16, 16, 16), "rows"),
    (9, (8, 8, 8), (16, 16, 16), "strided"),
    (4, (8, 8, 12), (16, 16, 16), "rows"),      # any oz: 4 oz % 4 == 0
])
def test_k_f_path_for_device_offsets(c, sizes, dims, want):
    """Device offsets take the rows path only where every offset the box
    admits keeps the run in whole vectors; the plain version gives the
    same result for the offsets as a tensor and as integers."""
    shape = dims + ((c,) if c > 1 else ())
    rng = np.random.default_rng(c)
    param = torch.tensor(rng.normal(size=shape).astype(np.float32))
    g = rng.normal(size=sizes + shape[3:]).astype(np.float32)
    g *= rng.uniform(size=g.shape) < 0.5
    grad = torch.tensor(g)
    offs_t = torch.tensor([3, 5, dims[2] - sizes[2]], dtype=torch.int32)
    assert torch_tv.path_of(param, grad, offs_t) == want
    got = torch_tv.tv_add_grad_box(param, grad, offs_t, 0.3, 0.2, 0.1)
    ref = torch_tv.tv_add_grad_box(param, grad, tuple(offs_t.tolist()),
                                   0.3, 0.2, 0.1)
    assert torch.equal(got, ref)
