"""The port's conditioned engine, datasets and drivers against the JAX
package on the CPU: the area resize against ``cv2.INTER_AREA``, the
conditioning batch built on the device against the JAX numpy one, the loss
terms, three train steps of each driver's stages from carried-across
weights (the same draws from the same seed), resume, checkpoints of each
new model class across the two packages, the LR/HR and multi-scene Blender
datasets on small files in their layout, the v1 driver's lazy pools and
epoch schedule, and the drivers' device rule.

Tolerances: the resize 1e-6 (absolute, images in [0, 1]); the conditioning
batch 1e-6 of its scale; losses 1e-5 relative; after three Adam steps each
parameter group's change within 2e-2 of the JAX change's scale on 99.5% of
the entries (and 2e-2 of 3 x lr everywhere), moments within 1e-3 of their
scale.
"""

import importlib
import json
import os
import types

import cv2
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from directvoxgo_tpu.config import Config as JaxConfig
from directvoxgo_tpu.data import datasets as jax_datasets
from directvoxgo_tpu.data.synthetic import make_synthetic_dataset
from directvoxgo_tpu.engine import checkpoint as jax_ckpt
from directvoxgo_tpu.engine import train as jax_train
from directvoxgo_tpu.engine import train_conditioned as jax_cond
from directvoxgo_tpu.models import tri_dvgo as jax_tri
from directvoxgo_tpu.models.multiscene_dvgo import (
    MultiSceneImplicitDVGO as JaxImplicit)
from directvoxgo_tpu.models.sr_dvgo import SRDVGO as JaxSR
from directvoxgo_tpu.models.tri_dvgo_multiscene import (
    TriDVGOMultiScene as JaxTriMS)
from directvoxgo_tpu_torch import convert
from directvoxgo_tpu_torch import run_multiscene as t_run_ms
from directvoxgo_tpu_torch import run_sr as t_run_sr
from directvoxgo_tpu_torch import run_tri as t_run_tri
from directvoxgo_tpu_torch import run_tri_multiscene as t_run_v1
from directvoxgo_tpu_torch import run_tri_multiscene_v2 as t_run_v2
from directvoxgo_tpu_torch.config import Config as TorchConfig
from directvoxgo_tpu_torch.data import datasets as t_datasets
from directvoxgo_tpu_torch.engine import checkpoint as t_ckpt
from directvoxgo_tpu_torch.engine import train as t_train
from directvoxgo_tpu_torch.engine import train_conditioned as t_cond
from directvoxgo_tpu_torch.models.multiscene_dvgo import (
    MultiSceneImplicitDVGO)
from directvoxgo_tpu_torch.models.sr_dvgo import SRDVGO
from directvoxgo_tpu_torch.models.tri_dvgo import TriDVGO
from directvoxgo_tpu_torch.models.tri_dvgo_multiscene import (
    TriDVGOMultiScene)
from directvoxgo_tpu_torch.ops.resize import area_resize

jax_load_data = importlib.import_module("directvoxgo_tpu.data.load_data")
t_load_data = importlib.import_module("directvoxgo_tpu_torch.data.load_data")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(rgbnet_dim=4, rgbnet_width=16, n_feats=8, n_resblocks=2,
             map_width=16, k_density=32, k_color=16, num_voxels=16 ** 3,
             num_voxels_base=16 ** 3)
BOX = dict(xyz_min=[-1.2] * 3, xyz_max=[1.2] * 3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    return make_synthetic_dataset(n_train=8, n_val=1, n_test=2, H=32, W=32)



def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _args(**kw):
    base = dict(seed=777, no_reload=False, no_reload_optimizer=False,
                ft_path="", i_print=1, i_weights=100000)
    base.update(kw)
    return types.SimpleNamespace(**base)


def _cfgs(tmp_path, config_file, fine_train=None, fine_model=None):
    """The same config in both packages, each writing to its own dir."""
    out = []
    for cls, side in ((JaxConfig, "jax"), (TorchConfig, "port")):
        cfg = cls.fromfile(os.path.join(REPO, "configs", config_file))
        cfg.expname = side
        cfg.basedir = str(tmp_path)
        cfg.fine_train.update(dict(N_iters=3, N_rand=64,
                                   ray_sampler="random", pg_scale=[]),
                              **(fine_train or {}))
        cfg.fine_model_and_render.update(fine_model or {})
        out.append(cfg)
    return out


def _scene(data, idx=None):
    idx = data["i_train"] if idx is None else idx
    return {"images": [data["images"][i] for i in idx],
            "poses": data["poses"][idx], "HW": data["HW"][idx],
            "Ks": data["Ks"][idx]}


def _rk(data):
    return {"near": float(data["near"]), "far": float(data["far"]),
            "bg": 1, "stepsize": 0.5}


def _pair(jcls, tcls, seed, **kw):
    """JAX model with a density blob; the port's from its kwargs with the
    same parameters and mask."""
    jm = jcls(**kw)
    if "density" in jm.params:
        shape = jm.params["density"].shape
        grid = np.stack(np.meshgrid(*[np.linspace(-1, 1, n)
                                      for n in shape[-3:]], indexing="ij"),
                        -1)
        d = 6.0 * np.exp(-np.sum(grid ** 2, -1) / 0.4) - 3.0
        d = np.broadcast_to(d, shape) + np.random.default_rng(seed).normal(
            0, 0.3, shape)
        jm.params["density"] = jnp.asarray(d.astype(np.float32))
    tm = tcls(**jm.get_kwargs(), device="cpu")
    tm.load_state_dict(convert.params_from_jax(
        _np_tree(jm.params), np.asarray(jm.mask), model=tm))
    return jm, tm


def _changes_match(t_params, j_params, p0, lrs):
    """Each group's change after the steps against the JAX change."""
    for name, j in j_params.items():
        if not any(isinstance(x, (np.ndarray, jax.Array))
                   for x in jax.tree_util.tree_leaves(j)):
            continue
        jl = [np.asarray(x) for x in jax.tree_util.tree_leaves(j)
              if hasattr(x, "ndim") and x.ndim > 0]
        tl = [x for x in jax.tree_util.tree_leaves(t_params[name])
              if isinstance(x, np.ndarray) and x.ndim > 0]
        pl = [x for x in jax.tree_util.tree_leaves(p0[name])
              if isinstance(x, np.ndarray) and x.ndim > 0]
        assert len(jl) == len(tl) == len(pl), name
        dj = np.concatenate([(a - c).ravel() for a, c in zip(jl, pl)])
        dt = np.concatenate([(b - c).ravel() for b, c in zip(tl, pl)])
        lim = 3 * lrs.get(name, 0.0)
        if lim == 0:
            np.testing.assert_array_equal(dt, dj)
            continue
        err = np.abs(dt - dj)
        assert err.max() < 2e-2 * lim, (name, err.max(), lim)
        assert np.mean(err <= 2e-2 * np.abs(dj).max() + 1e-9) > 0.995, name


def _moments_match(t_state, j_state):
    for key in ("exp_avg", "exp_avg_sq"):
        for name in j_state[key]:
            jl = [np.asarray(x) for x in
                  jax.tree_util.tree_leaves(j_state[key][name])
                  if np.ndim(x) > 0]
            tl = [x for x in jax.tree_util.tree_leaves(t_state[key][name])
                  if np.ndim(x) > 0]
            assert len(jl) == len(tl), (key, name)
            scale = max(float(np.abs(x).max()) for x in jl) + 1e-30
            for a, b in zip(tl, jl):
                assert np.abs(a - b).max() <= 1e-3 * scale, (key, name)


def _lrs(cfg_train):
    return {k[len("lrate_"):]: float(v) for k, v in cfg_train.items()
            if k.startswith("lrate_")}


# ------------------------------------------------------------ conditioning

@pytest.mark.parametrize("hw", [(400, 400), (37, 53), (20, 33)])
def test_area_resize_matches_cv2(hw):
    """Every ``down`` in 2..15, whole and fractional factors."""
    img = np.random.default_rng(hw[1]).uniform(0, 1, (*hw, 3)).astype(
        np.float32)
    for down in range(2, 16):
        h, w = hw[0] // down, hw[1] // down
        if min(h, w) < 1:
            continue
        want = cv2.resize(img, (w, h), interpolation=cv2.INTER_AREA)
        got = area_resize(torch.tensor(img), h, w).numpy()
        assert np.abs(got - want).max() < 1e-6, down


@pytest.mark.parametrize("down,flags", [(1, {}), (3, {}),
                                        (5, dict(inverse_y=True,
                                                 flip_x=True))])
def test_conditioning_batch_matches_jax(data, down, flags):
    cfg = types.SimpleNamespace(ndc=False, inverse_y=False, flip_x=False,
                                flip_y=False)
    for k, v in flags.items():
        setattr(cfg, k, v)
    sc = _scene(data)
    views = [4, 0, 2]
    j_rgb, j_pose = jax_cond.build_conditioning_batch(
        sc["images"], sc["poses"], sc["HW"], sc["Ks"], views, cfg,
        down=down)
    imgs = torch.tensor(np.stack(sc["images"]))
    t_rgb, t_pose = t_cond.build_conditioning_batch(
        imgs, sc["poses"], sc["HW"], sc["Ks"], views, cfg, down=down)
    got = np.moveaxis(t_rgb.numpy(), 1, -1)
    assert got.shape == j_rgb.shape
    assert np.abs(got - j_rgb).max() <= 1e-6 * np.abs(j_rgb).max()
    np.testing.assert_array_equal(t_pose.numpy(), j_pose)


def test_loss_terms_match_jax():
    rng = np.random.default_rng(3)
    ret = {"rgb_marched": rng.uniform(0, 1, (16, 3)),
           "alphainv_last": rng.uniform(0, 1, 16),
           "raw_rgb": rng.uniform(0, 1, (16, 8, 3)),
           "weights": rng.uniform(0, 0.2, (16, 8))}
    target = rng.uniform(0, 1, (16, 3)).astype(np.float32)
    cfg = types.SimpleNamespace(weight_main=1.0, weight_entropy_last=0.01,
                                weight_rgbper=0.1)
    jl, jm = jax_cond.conditioned_loss_terms(
        {k: jnp.asarray(v, jnp.float32) for k, v in ret.items()},
        jnp.asarray(target), cfg, 16)
    tl, tm = t_cond.conditioned_loss_terms(
        {k: torch.tensor(v, dtype=torch.float32) for k, v in ret.items()},
        torch.tensor(target), cfg, 16)
    assert abs(float(tl) - float(jl)) <= 1e-6 * abs(float(jl))
    assert abs(float(tm) - float(jm)) <= 1e-6 * abs(float(jm))


# ------------------------------------------------------ three train steps

def _stage_pair(tmp_path, data, jm, tm, config_file, make_pools, cond_pair,
                multiscene=False, fine_train=None, sampler_pair=None):
    """Three steps of each package's conditioned stage from one state;
    the port's against the JAX one. Returns (cfg_j, cfg_t)."""
    cfg_j, cfg_t = _cfgs(tmp_path, config_file, fine_train)
    j_opt = jax_train.create_optimizer_or_freeze_model(jm, cfg_j.fine_train)
    t_opt = t_train.create_optimizer_or_freeze_model(tm, cfg_t.fine_train)
    assert set(t_opt.groups) == set(j_opt.group_cfg)
    p0 = jax.tree_util.tree_map(np.copy, convert.params_to_jax(tm)[0])
    j_pools, t_pools = make_pools(jm, tm, cfg_j, cfg_t)
    aux = {k: cfg_j.fine_train.get(k, 0.0) for k in
           ("weight_consistency", "weight_cosine", "weight_distillation")}
    extra_j, extra_t = ({}, {}) if sampler_pair is None else sampler_pair
    jm, j_state = jax_cond.train_conditioned_stage(
        _args(), cfg_j, cfg_j.fine_train, jm, j_opt,
        j_opt.init({n: jm.params[n] for n in j_opt.group_cfg
                    if n in jm.params}),
        j_pools, cond_pair[0], _rk(data), stage="fine", aux_weights=aux,
        multiscene=multiscene, **extra_j)
    tm, t_opt = t_cond.train_conditioned_stage(
        _args(), cfg_t, cfg_t.fine_train, tm, t_opt, t_pools, cond_pair[1],
        _rk(data), stage="fine", aux_weights=aux, multiscene=multiscene,
        **extra_t)
    t_params, t_mask = convert.params_to_jax(tm)
    _changes_match(t_params, _np_tree(jm.params), p0, _lrs(cfg_j.fine_train))
    t_state = convert.opt_state_to_jax(t_opt)
    assert int(t_state["step"]) == int(j_state["step"]) == 3
    _moments_match(t_state, j_state)

    # the checkpoints each stage wrote, read by the other package
    j_path = os.path.join(str(tmp_path), "jax", "fine_last.tar")
    t_path = os.path.join(str(tmp_path), "port", "fine_last.tar")
    t_from_j = t_ckpt.load_model(type(tm), j_path, device="cpu")
    got, _ = convert.params_to_jax(t_from_j)
    _changes_match(got, _np_tree(jm.params), p0, {})
    j_from_t = jax_ckpt.load_model(type(jm), t_path)
    _changes_match(_np_tree(j_from_t.params), t_params, p0, {})
    np.testing.assert_array_equal(np.asarray(j_from_t.mask), t_mask)
    opt2 = t_train.create_optimizer_or_freeze_model(t_from_j,
                                                    cfg_t.fine_train)
    convert.opt_state_from_jax(t_ckpt.load_checkpoint_file(j_path)
                               ["optimizer_state_dict"], opt2)
    _moments_match(convert.opt_state_to_jax(opt2), j_state)
    return cfg_j, cfg_t


def _single_pools(data, n_scene=1):
    def make(jm, tm, cfg_j, cfg_t):
        sc = _scene(data)
        jp = [jax_cond.gather_scene_ray_pool(jm, cfg_j, cfg_j.fine_train,
                                             sc, _rk(data))
              for _ in range(n_scene)]
        tp = [t_cond.gather_scene_ray_pool(tm, cfg_t, cfg_t.fine_train, sc,
                                           _rk(data))
              for _ in range(n_scene)]
        for k in ("rgb", "rays_o", "rays_d", "viewdirs"):
            np.testing.assert_array_equal(tp[0][k].numpy(),
                                          np.asarray(jp[0][k]))
        return jp, tp
    return make


def _views_sources(data, cfg_data, dynamic_down):
    """The drivers' 3-view conditioning sources of both packages."""
    sc = _scene(data)
    imgs = torch.tensor(np.stack(sc["images"]))

    def draw(rng):
        views = rng.choice(len(sc["poses"]), size=3, replace=False)
        down = int(rng.integers(2, dynamic_down)) if dynamic_down > 2 else 1
        return views, down

    def j_source(rng, sid):
        views, down = draw(rng)
        return jax_cond.build_conditioning_batch(
            sc["images"], sc["poses"], sc["HW"], sc["Ks"], views, cfg_data,
            down=down)

    def t_source(rng, sid):
        views, down = draw(rng)
        return t_cond.build_conditioning_batch(
            imgs, sc["poses"], sc["HW"], sc["Ks"], views, cfg_data,
            down=down)

    return j_source, t_source


def test_run_tri_fine_steps_match_jax(tmp_path, data):
    """run_tri's fine stage: TriDVGO, 3 views at a ``down`` drawn from
    [2, 6) each step."""
    jm, tm = _pair(jax_tri.TriDVGO, TriDVGO, 1, **BOX, **SMALL,
                   alpha_init=1e-2, fast_color_thres=1e-4)
    cfg = types.SimpleNamespace(ndc=False, inverse_y=False, flip_x=False,
                                flip_y=False)
    _stage_pair(tmp_path, data, jm, tm, "tri_default.py",
                _single_pools(data), _views_sources(data, cfg, 6))


def test_run_sr_fine_steps_match_jax(tmp_path, data):
    """run_sr's fine stage: one pool per view, each step conditioned on
    its view's LR image."""
    jm, tm = _pair(JaxSR, SRDVGO, 2, **BOX, **dict(SMALL, rgbnet_dim=6),
                   alpha_init=1e-2, fast_color_thres=1e-4)
    idx = data["i_train"]
    lrs = [((np.asarray(data["images"][i])[::2, ::2] - 0.5) / 0.5)
           .astype(np.float32) for i in idx]

    def make_pools(jm, tm, cfg_j, cfg_t):
        jp = [jax_cond.gather_scene_ray_pool(
            jm, cfg_j, cfg_j.fine_train, _scene(data, [i]), _rk(data))
            for i in idx]
        tp = [t_cond.gather_scene_ray_pool(
            tm, cfg_t, cfg_t.fine_train, _scene(data, [i]), _rk(data))
            for i in idx]
        return jp, tp

    _stage_pair(tmp_path, data, jm, tm, "sr_default.py", make_pools,
                (lambda rng, v: (lrs[v][None], None),
                 lambda rng, v: (torch.tensor(lrs[v]).permute(2, 0, 1)[None],
                                 None)))


def test_run_tri_multiscene_v2_fine_steps_match_jax(tmp_path, data):
    """The v2 fine stage: two scenes, consistency and cosine losses."""
    jm, tm = _pair(JaxTriMS, TriDVGOMultiScene, 3, **BOX, **SMALL,
                   n_scene=2, alpha_init=1e-2, fast_color_thres=1e-4,
                   compute_consistency=True, compute_cosine=True)
    cfg = types.SimpleNamespace(ndc=False, inverse_y=False, flip_x=False,
                                flip_y=False)
    _stage_pair(tmp_path, data, jm, tm, "tri_multiscene_default.py",
                _single_pools(data, 2), _views_sources(data, cfg, 4),
                multiscene=True,
                fine_train=dict(weight_consistency=0.1, weight_cosine=0.01))


def test_run_tri_multiscene_v1_fine_steps_match_jax(tmp_path, data):
    """The v1 fine stage: lazy pools (pow2-tiled) in shuffled epochs."""
    from run_tri_multiscene import EpochSchedule as JaxEpochs
    from run_tri_multiscene import LazyScenePools as JaxLazy
    jm, tm = _pair(JaxTriMS, TriDVGOMultiScene, 4, **BOX, **SMALL,
                   n_scene=3, alpha_init=1e-2, fast_color_thres=1e-4)
    cfg = types.SimpleNamespace(ndc=False, inverse_y=False, flip_x=False,
                                flip_y=False)
    ds = types.SimpleNamespace(
        n_scene=3, scenes=["a", "b", "c"],
        scene_data=lambda s: dict(_scene(data), near=data["near"],
                                  far=data["far"]))
    made = {}

    def make_pools(jm, tm, cfg_j, cfg_t):
        made["j"] = JaxLazy(ds, jm, cfg_j, cfg_j.fine_train, _rk(data))
        made["t"] = t_run_v1.LazyScenePools(ds, tm, cfg_t, cfg_t.fine_train,
                                            _rk(data))
        return made["j"], made["t"]

    class Lazy:
        """Schedules built once the pools exist."""
        def __init__(self, side, cls):
            self.side, self.cls, self.s = side, cls, None

        def __call__(self, rng, step):
            if self.s is None:
                self.s = self.cls(3, made[self.side], seed=5)
            return self.s(rng, step)

    _stage_pair(tmp_path, data, jm, tm, "tri_multiscene_default.py",
                make_pools, _views_sources(data, cfg, 1), multiscene=True,
                sampler_pair=(dict(n_scene=3, scene_sampler=Lazy(
                    "j", JaxEpochs)), dict(n_scene=3, scene_sampler=Lazy(
                        "t", t_run_v1.EpochSchedule))))
    made["t"].join()


def test_run_multiscene_fine_steps_match_jax(data):
    """The implicit model's train step (the JAX package's own stage cannot
    differentiate its ``skips`` leaf): three port steps against three JAX
    steps over the float leaves, on the same batches."""
    jm, tm = _pair(JaxImplicit, MultiSceneImplicitDVGO, 5, **BOX,
                   **dict(SMALL, rgbnet_depth=4, rgbnet_width=32),
                   fast_color_thres=1e-4)
    cfg = JaxConfig.fromfile(os.path.join(REPO, "configs",
                                          "multiscene_default.py"))
    cfg_t = TorchConfig.fromfile(os.path.join(REPO, "configs",
                                              "multiscene_default.py"))
    for c in (cfg, cfg_t):
        c.fine_train.N_rand = 48
    j_opt = jax_train.create_optimizer_or_freeze_model(jm, cfg.fine_train)
    t_opt = t_train.create_optimizer_or_freeze_model(tm, cfg_t.fine_train)
    trainable = list(j_opt.group_cfg)
    j_state = j_opt.init({n: jm.params[n] for n in trainable})
    t_step = t_cond.make_cond_train_step(tm, t_opt, cfg_t.fine_train,
                                         _rk(data))
    p0 = jax.tree_util.tree_map(np.copy, convert.params_to_jax(tm)[0])
    sc = _scene(data)
    pool = jax_cond.gather_scene_ray_pool(jm, cfg, cfg.fine_train, sc,
                                          _rk(data))
    t_pool = {k: torch.tensor(np.asarray(v)) for k, v in pool.items()}
    rng = np.random.default_rng(0)
    skips = jm.params["rgbnet"]["skips"]

    def float_tree(p):
        return {n: {k: v for k, v in p[n].items() if k != "skips"}
                if n == "rgbnet" else p[n] for n in trainable}

    params = jm.params
    for _ in range(3):
        sel = rng.integers(0, pool["rgb"].shape[0], 48)
        views = rng.choice(len(sc["poses"]), 3, replace=False)
        rgb, pose = jax_cond.build_conditioning_batch(
            sc["images"], sc["poses"], sc["HW"], sc["Ks"], views, cfg.data)

        def loss_fn(tr, batch):
            p = dict(params, **tr)
            p["rgbnet"] = dict(tr["rgbnet"], skips=skips)
            ret = jm.forward(p, jm.mask, *batch[:5], **_rk(data))
            return jax_cond.conditioned_loss_terms(
                ret, batch[5], cfg.fine_train, 48)

        # the batch as arguments: as constants XLA would fold the sampler
        # without the contractions the port's sampler reproduces
        batch = [jnp.asarray(rgb), jnp.asarray(pose)] + [
            pool[k][sel] for k in ("rays_o", "rays_d", "viewdirs", "rgb")]
        tr = float_tree(params)
        (j_loss, _), g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            tr, batch)
        st = dict(j_state, exp_avg=float_tree(j_state["exp_avg"]),
                  exp_avg_sq=float_tree(j_state["exp_avg_sq"]))
        new, j_state = j_opt.update(tr, g, st)
        new["rgbnet"] = dict(new["rgbnet"], skips=skips)
        params = dict(params, **new)
        t_loss, _ = t_step(t_pool, torch.tensor(sel),
                           torch.tensor(np.moveaxis(rgb, -1, 1)),
                           torch.tensor(pose), 0)
        assert abs(float(t_loss) - float(j_loss)) <= 1e-5 * float(j_loss)
    t_params, _ = convert.params_to_jax(tm)
    _changes_match(t_params, _np_tree(params), p0, _lrs(cfg.fine_train))


def test_v2_coarse_stage_matches_jax(tmp_path, data):
    """The joint coarse stage (DirectVoxGOMultiScene, zero-initialized
    grids): three steps over two scenes in each package."""
    from run_tri_multiscene_v2 import coarse_stage as jax_coarse
    cfg_j, cfg_t = _cfgs(tmp_path, "tri_multiscene_default.py")
    for c in (cfg_j, cfg_t):
        c.coarse_train.update(N_iters=3, N_rand=64, ray_sampler="random")
        c.coarse_model_and_render.update(num_voxels=16 ** 3,
                                         num_voxels_base=16 ** 3)
    ds = types.SimpleNamespace(
        n_scene=2, scenes=["a", "b"],
        scene_data=lambda s: dict(_scene(data), near=data["near"],
                                  far=data["far"]))
    mn, mx = t_run_v2.union_bbox(cfg_t, ds)
    for side in ("jax", "port"):
        os.makedirs(tmp_path / side)
    j_path, _ = jax_coarse(_args(), cfg_j, ds, mn, mx)
    t_path, _ = t_run_v2.coarse_stage(_args(), cfg_t, ds, mn, mx, "cpu")
    j_st = jax_ckpt.load_checkpoint_file(j_path)
    t_st = t_ckpt.load_checkpoint_file(t_path)
    p0 = {k: np.zeros_like(v) for k, v in t_st["model_state_dict"].items()
          if k in ("density", "k0")}
    _changes_match({k: t_st["model_state_dict"][k] for k in p0},
                   {k: j_st["model_state_dict"][k] for k in p0}, p0,
                   _lrs(cfg_j.coarse_train))
    np.testing.assert_array_equal(t_st["model_state_dict"]["mask"],
                                  j_st["model_state_dict"]["mask"])


def test_resume_picks_up_the_finished_stage(tmp_path, data):
    """A fresh model resumes from ``fine_last.tar`` at its step (a finished
    stage takes no new step) with the same parameters and moments."""
    _, cfg = _cfgs(tmp_path, "tri_default.py")
    kw = dict(**BOX, **SMALL, alpha_init=1e-2, fast_color_thres=1e-4)
    tm = TriDVGO(**kw, device="cpu")
    opt = t_train.create_optimizer_or_freeze_model(tm, cfg.fine_train)
    pool = t_cond.gather_scene_ray_pool(tm, cfg, cfg.fine_train,
                                        _scene(data), _rk(data))
    source = _views_sources(data, types.SimpleNamespace(
        ndc=False, inverse_y=False, flip_x=False, flip_y=False), 1)[1]
    t_cond.train_conditioned_stage(_args(), cfg, cfg.fine_train, tm, opt,
                                   [pool], source, _rk(data), "fine")
    assert t_cond.initial_num_voxels(_args(), cfg, cfg.fine_model_and_render,
                                     cfg.fine_train, "fine") == 16 ** 3
    tm2 = TriDVGO(**kw, device="cpu", seed=9)
    opt2 = t_train.create_optimizer_or_freeze_model(tm2, cfg.fine_train)
    loaded, start = t_cond.resume_latest_checkpoint(_args(), cfg, tm2, opt2,
                                                    "fine")
    assert loaded and start == 3
    for (n, a), (_, b) in zip(tm.state_dict().items(),
                              tm2.state_dict().items()):
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=n)
    _moments_match(convert.opt_state_to_jax(opt2),
                   convert.opt_state_to_jax(opt))
    assert t_cond.resume_latest_checkpoint(_args(no_reload=True), cfg, tm2,
                                           opt2, "fine") == (False, 0)


# --------------------------------------------------------------- datasets

def _write_blender(root, rng, n=(3, 1, 2), hw=(24, 20)):
    for split, count in zip(("train", "val", "test"), n):
        frames = []
        for i in range(count):
            name = f"{split}/r_{i}"
            os.makedirs(os.path.join(root, split), exist_ok=True)
            cv2.imwrite(os.path.join(root, f"{name}.png"), rng.integers(
                0, 256, (*hw, 4), dtype=np.uint8))
            frames.append({"file_path": f"./{name}",
                           "transform_matrix": rng.normal(
                               size=(4, 4)).tolist()})
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": 0.69, "frames": frames}, f)


def test_lrsr_loader_and_sr_task_match_jax(tmp_path):
    for side in ("jax", "port"):
        _write_blender(str(tmp_path / side), np.random.default_rng(0))
    j = jax_datasets.load_blender_data_lrsr(str(tmp_path / "jax"), down=3)
    t = t_datasets.load_blender_data_lrsr(str(tmp_path / "port"), down=3)
    assert np.abs(t[0] - j[0]).max() < 1e-6       # LR: area vs cv2
    for a, b in zip(t[1:4], j[1:4]):
        np.testing.assert_array_equal(a, b)
    assert t[4] == j[4] and t[5] == j[5]
    # the cache: the port reads back what it wrote, and the JAX package's
    again = t_datasets.load_blender_data_lrsr(str(tmp_path / "port"), down=3)
    np.testing.assert_array_equal(again[0], t[0])
    from_jax = t_datasets.load_blender_data_lrsr(str(tmp_path / "jax"),
                                                 down=3)
    np.testing.assert_array_equal(from_jax[0], j[0])
    args = dict(dataset_type="blender", half_res=False, testskip=1, down=3,
                white_bkgd=True, task="sr")
    from directvoxgo_tpu.config import ConfigDict as JaxConfigDict
    from directvoxgo_tpu_torch.config import ConfigDict
    jd = jax_load_data.load_data(JaxConfigDict(datadir=str(tmp_path / "jax"),
                                               **args))
    td = t_load_data.load_data(ConfigDict(datadir=str(tmp_path / "jax"),
                                          **args))
    assert set(td) == set(jd)
    for k in ("images", "images_lr", "HW_lr", "Ks_lr", "HW", "Ks", "poses"):
        np.testing.assert_array_equal(np.asarray(td[k]), np.asarray(jd[k]))


@pytest.mark.parametrize("lazy", [False, True])
def test_multiscene_blender_dataset_matches_jax(tmp_path, lazy):
    for s, scene in enumerate(("chair", "lego", "ship")):
        _write_blender(str(tmp_path / scene), np.random.default_rng(s),
                       hw=(16, 16))
    kw = dict(basedir=str(tmp_path), down=2, test_scenes=("ship",),
              lazy=lazy)
    for split in ("train", "test"):
        j = jax_datasets.MultisceneBlenderDataset(split=split, **kw)
        t = t_datasets.MultisceneBlenderDataset(split=split, **kw)
        assert t.scenes == j.scenes and t.n_scene == j.n_scene
        for s in range(t.n_scene):
            a, b = t.scene_data(s), j.scene_data(s)
            assert np.abs(a["images"] - b["images"]).max() < 1e-6
            for k in ("poses", "Ks", "HW"):
                np.testing.assert_array_equal(a[k], b[k])
    single_j = jax_datasets.BlenderDataset(str(tmp_path / "lego"), down=2)
    single_t = t_datasets.BlenderDataset(str(tmp_path / "lego"), down=2)
    assert np.abs(single_t.images - single_j.images).max() < 1e-6
    np.testing.assert_array_equal(single_t.K, single_j.K)
    # the multi-scene NSVF dataset on the same views in the NSVF layout
    from directvoxgo_tpu_torch.tools.scene_layouts import write_prefix_split
    for s, scene in enumerate(("chair", "lego", "ship")):
        j = single_j if scene == "lego" else jax_datasets.BlenderDataset(
            str(tmp_path / scene))
        K = np.array([[20.0, 0, 8.0], [0, 20.0, 8.0], [0, 0, 1]])
        n = len(j.images)
        write_prefix_split(str(tmp_path / "nsvf" / scene), j.images,
                           j.poses, K, [range(n - 1), [], [n - 1]], False)
    kw = dict(basedir=str(tmp_path / "nsvf"), down=2, test_scenes=("ship",))
    for split in ("train", "test"):
        j = jax_datasets.MultisceneNSVFDataset(split=split, **kw)
        t = t_datasets.MultisceneNSVFDataset(split=split, **kw)
        assert t.scenes == j.scenes and (t.near, t.far) == (j.near, j.far)
        for s in range(t.n_scene):
            a, b = t.scene_data(s), j.scene_data(s)
            assert np.abs(a["images"] - b["images"]).max() < 1e-6
            for k in ("poses", "Ks", "HW"):
                np.testing.assert_array_equal(a[k], b[k])


# ------------------------------------------------------------- v1's pools

class _CountingPools(t_run_v1.LazyScenePools):
    def __init__(self, max_cached=2):
        super().__init__(None, None, None, None, None, max_cached)
        self.calls = []

    def _gather(self, sid):
        self.calls.append(sid)
        return {"rgb": torch.zeros((100 + sid, 3))}

    def scene(self, sid):
        return {"id": sid}


def test_lazy_pools_cache_prefetch_and_schedule():
    pools = _CountingPools()
    pools(0)
    pools(1)
    pools(0)                      # cached: no new gather
    pools(2)                      # evicts 1 (0 was refreshed)
    pools(1)
    assert pools.calls == [0, 1, 2, 1]
    pools = _CountingPools()
    pools.prefetch(3)
    assert pools(3)["rgb"].shape[0] == 103 and pools.calls == [3]
    pools = _CountingPools(max_cached=8)
    sched = t_run_v1.EpochSchedule(4, pools, batch_per_scene=2, seed=0)
    visits = [sched(None, i) for i in range(16)]
    for epoch in (visits[:8], visits[8:]):
        assert sorted(set(epoch)) == [0, 1, 2, 3]
        assert all(epoch[i] == epoch[i + 1] for i in range(0, 8, 2))
    pools.join()


def test_lazy_pools_tile_to_a_power_of_two(monkeypatch):
    assert t_run_v1._round_up_pow2(100) == 128
    assert t_run_v1._round_up_pow2(128) == 128
    rows = torch.arange(100, dtype=torch.float32)[:, None].repeat(1, 3)
    monkeypatch.setattr(t_cond, "gather_scene_ray_pool",
                        lambda *a, **k: {"rgb": rows})
    pools = t_run_v1.LazyScenePools(None, None, None, None, None)
    pools.scene = lambda sid: None
    pool = pools._gather(0)
    assert pool["rgb"].shape[0] == 128
    np.testing.assert_array_equal(pool["rgb"][100].numpy(), rows[0].numpy())


# ----------------------------------------------------------------- drivers

DRIVERS = [t_run_tri, t_run_sr, t_run_ms, t_run_v2, t_run_v1]


@pytest.mark.parametrize("driver", DRIVERS,
                         ids=[d.__name__.split(".")[-1] for d in DRIVERS])
def test_drivers_run_on_cuda_unless_asked_for_the_cpu(driver, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        driver.main(["--config", os.path.join(REPO, "configs",
                                              "tri_default.py")])


def test_run_tri_trains_and_renders_on_the_cpu(tmp_path):
    """``python -m directvoxgo_tpu_torch.run_tri`` end to end on a tiny
    fixture config: coarse, fine through two rescales, the test views."""
    cfg = tmp_path / "tri_tiny.py"
    cfg.write_text(
        f"_base_ = {os.path.join(REPO, 'configs', 'tri_default.py')!r}\n"
        "expname = 'tri_tiny'\n"
        f"basedir = {str(tmp_path)!r}\n"
        "data = {'datadir': None, 'dataset_type': 'synthetic_fixture',\n"
        "        'white_bkgd': True, 'fixture_kwargs': {'H': 32, 'W': 32,\n"
        "        'n_train': 8, 'n_val': 1, 'n_test': 2}}\n"
        "coarse_train = {'N_iters': 100, 'N_rand': 512,\n"
        "                'lrate_density': 0.3}\n"
        "fine_train = {'N_iters': 30, 'N_rand': 128, 'pg_scale': [10, 20],\n"
        "              'dynamic_down': 5}\n"
        "coarse_model_and_render = {'num_voxels': 16 ** 3,\n"
        "                           'num_voxels_base': 16 ** 3}\n"
        "fine_model_and_render = {'num_voxels': 16 ** 3,\n"
        "    'num_voxels_base': 16 ** 3, 'rgbnet_dim': 4,\n"
        "    'rgbnet_width': 16, 'n_feats': 8, 'n_resblocks': 2,\n"
        "    'map_width': 16, 'k_density': 32, 'k_color': 16}\n")
    t_run_tri.main(["--config", str(cfg), "--device", "cpu", "--i_print",
                    "10", "--render_test"])
    out = tmp_path / "tri_tiny"
    assert (out / "coarse_last.tar").is_file()
    st = t_ckpt.load_checkpoint_file(str(out / "fine_last.tar"))
    assert st["global_step"] == 30
    assert st["model_kwargs"]["num_voxels"] == 16 ** 3
    pngs = sorted(p.name for p in (out / "render_test_fine_last").iterdir()
                  if p.suffix == ".png")
    assert pngs == ["000.png", "001.png"]
