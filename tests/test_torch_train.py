"""The port's training path against the JAX package on the CPU: loss
gradients of ``forward_sweep``, consecutive train steps from carried-over
parameters and optimizer state, the model's state surgery, the training
ray pools, and the training path as a whole (the port trains the tiny
fixture and the JAX package renders the checkpoint it wrote).

The port runs its kernels' plain versions (CPU tensors); the JAX sweep runs
its XLA scan and streamed transpose, as it does on the CPU. Inputs are made
with numpy from a seed and handed to both packages.
"""

import os
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from directvoxgo_tpu import rays as jax_rays
from directvoxgo_tpu.config import Config as JaxConfig
from directvoxgo_tpu.engine import checkpoint as jax_ckpt
from directvoxgo_tpu.engine import render as jax_render
from directvoxgo_tpu.engine import train as jax_train
from directvoxgo_tpu.models.dvgo import DirectVoxGO as JaxDVGO
from directvoxgo_tpu.optim import MaskedAdam as JaxAdam
from directvoxgo_tpu_torch import convert
from directvoxgo_tpu_torch import rays as torch_rays
from directvoxgo_tpu_torch.config import Config as TorchConfig
from directvoxgo_tpu_torch.data.synthetic import make_synthetic_dataset
from directvoxgo_tpu_torch.engine import checkpoint as torch_ckpt
from directvoxgo_tpu_torch.engine import train as torch_train
from directvoxgo_tpu_torch.models.dvgo import DirectVoxGO as TorchDVGO

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_CFG = os.path.join(REPO, "configs", "default.py")
RK = dict(near=0.5, far=8.0, bg=1.0, stepsize=0.5)
GRID_KW = dict(xyz_min=[-1.6, -1.0, -0.5], xyz_max=[1.6, 1.0, 0.5],
               num_voxels=64 * 40 * 20, num_voxels_base=64 * 40 * 20)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _model_pair(seed, rgbnet_dim, f32, topk=48):
    """A JAX model with a blob of density (a 64-deep grid, so the clipped
    sweep along x is long enough for top-K compaction) and the port's model
    with the same parameters and mask."""
    rng = np.random.default_rng(seed)
    jm = JaxDVGO(alpha_init=1e-2, fast_color_thres=1e-4,
                 rgbnet_dim=rgbnet_dim, rgbnet_direct=True, rgbnet_depth=3,
                 rgbnet_width=32, k_density=None, k_color=0,
                 sweep_color_topk=topk, **GRID_KW)
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
    if f32:
        jm.sweep_dtype, jm.mlp_dtype = jnp.float32, None
        tm.sweep_dtype, tm.mlp_dtype = torch.float32, None
    return jm, tm


def _rays(seed, n):
    """Rays along +-x through the blob, with targets."""
    rng = np.random.default_rng(seed)
    ro = np.stack([np.where(rng.uniform(size=n) < 0.5, -3.0, 3.0),
                   rng.uniform(-0.3, 0.3, n), rng.uniform(-0.3, 0.3, n)],
                  -1).astype(np.float32)
    rd = np.stack([-np.sign(ro[:, 0]), rng.uniform(-0.15, 0.15, n),
                   rng.uniform(-0.15, 0.15, n)], -1).astype(np.float32)
    vd = rd / np.linalg.norm(rd, axis=-1, keepdims=True)
    rgb = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    return ro, rd, vd.astype(np.float32), rgb


def _loss_jax(ret, target, n):
    mse = jnp.mean((ret["rgb_marched"] - target) ** 2)
    pout = jnp.clip(ret["alphainv_last"], 1e-6, 1 - 1e-6)
    ent = -jnp.mean(pout * jnp.log(pout) + (1 - pout) * jnp.log(1 - pout))
    rgbper = jnp.sum((ret["raw_rgb_cl"] - target.T[:, :, None]) ** 2, 0)
    return mse + 0.01 * ent + 0.1 * jnp.sum(
        rgbper * jax.lax.stop_gradient(ret["weights"])) / n


def _loss_torch(ret, target, n):
    mse = torch.mean((ret["rgb_marched"] - target) ** 2)
    pout = torch.clamp(ret["alphainv_last"], 1e-6, 1 - 1e-6)
    ent = -torch.mean(pout * torch.log(pout)
                      + (1 - pout) * torch.log(1 - pout))
    rgbper = torch.sum((ret["raw_rgb_cl"] - target.t()[:, :, None]) ** 2, 0)
    return mse + 0.01 * ent + 0.1 * torch.sum(
        rgbper * ret["weights"].detach()) / n


@pytest.mark.parametrize("pre_clipped", [False, True])
@pytest.mark.parametrize("mode", ["f32", "bf16"])
def test_forward_sweep_loss_gradients_match_jax(mode, pre_clipped):
    """d loss / d (density, k0, MLP) of the train loss through
    ``forward_sweep`` clipped to the occupancy box, top-K compaction on,
    against ``jax.grad``. f32 sweep and MLP: 2e-4 of each gradient's
    largest entry (f32 sums in another order through ~100 stations and a
    top-K gather). bf16 mode: both packages round values and cotangents to
    bf16 at the same points, so most leaves agree to a bf16 ulp; a bias
    cotangent is a sum of 24,576 bf16 values, which the two libraries'
    bf16 reductions round differently (4% seen), so 6e-2 of the largest
    entry."""
    jm, tm = _model_pair(1, 12, mode == "f32")
    axis, n = 0, 512
    clip_sizes, clip_off = jm.sweep_clip_for_axis(axis)
    assert clip_sizes is not None and 2 * (clip_sizes[0] - 1) + 1 > 96
    ro, rd, vd, rgb = _rays(2, n)
    inv = {0: 0, 1: 1, 2: 2}
    box = tuple(slice(int(clip_off[inv[a]]),
                      int(clip_off[inv[a]]) + clip_sizes[inv[a]])
                for a in range(3))

    def jax_loss(params, mask):
        ret = jm.forward_sweep(params, mask, jnp.asarray(ro),
                               jnp.asarray(rd), jnp.asarray(vd), axis,
                               clip_sizes=clip_sizes,
                               clip_offsets=jnp.asarray(clip_off),
                               grids_pre_clipped=pre_clipped, **RK)
        return _loss_jax(ret, jnp.asarray(rgb), n)

    j_params, j_mask = dict(jm.params), jm.mask
    if pre_clipped:
        j_params["density"] = j_params["density"][box]
        j_params["k0"] = j_params["k0"][box]
        j_mask = j_mask[box]
    loss_j, g_j = jax.value_and_grad(jax_loss)(j_params, j_mask)

    grids = None
    leaves = [tm.density, tm.k0]
    if pre_clipped:
        leaves = [tm.density.detach()[box].requires_grad_(),
                  tm.k0.detach()[box].requires_grad_()]
        grids = (*leaves, tm.mask[box])
    mlp_params = list(tm.rgbnet.parameters())
    ret = tm.forward_sweep(torch.tensor(ro), torch.tensor(rd),
                           torch.tensor(vd), axis, clip_sizes=clip_sizes,
                           clip_offsets=clip_off,
                           grids_pre_clipped=pre_clipped, grids=grids, **RK)
    assert ret["weights"].shape[1] == 48           # compaction is on
    loss_t = _loss_torch(ret, torch.tensor(rgb), n)
    grads = torch.autograd.grad(loss_t, leaves + mlp_params)
    tol = 2e-4 if mode == "f32" else 6e-2
    assert abs(float(loss_t.detach()) - float(loss_j)) < tol * float(loss_j)
    pairs = [("density", grads[0].numpy(), np.asarray(g_j["density"])),
             ("k0", grads[1].numpy(), np.asarray(g_j["k0"]))]
    for i, layer in enumerate(g_j["rgbnet"]["layers"]):
        pairs.append((f"w{i}", grads[2 + 2 * i].numpy().T,
                      np.asarray(layer["w"])))
        pairs.append((f"b{i}", grads[3 + 2 * i].numpy(),
                      np.asarray(layer["b"])))
    for name, got, ref in pairs:
        assert got.shape == ref.shape, name
        assert np.abs(ref).max() > 0, name
        assert np.abs(got - ref).max() < tol * np.abs(ref).max(), name
    if not pre_clipped:
        # full-size grid gradients: exactly zero outside the clip box
        outside = np.ones(tm.world_size, bool)
        outside[box] = False
        assert np.all(grads[0].numpy()[outside] == 0)
        assert np.all(grads[1].numpy()[outside] == 0)


def _cfg_train(cfg, stage, n_rand):
    ct = cfg.coarse_train if stage == "coarse" else cfg.fine_train
    ct.N_rand = n_rand
    return ct


@pytest.mark.parametrize("stage", ["coarse", "fine"])
def test_three_train_steps_match_jax(stage):
    """Three consecutive ``make_train_step`` steps of both packages from
    the same parameters, mask and optimizer state with the same ray
    indices, in f32 sweep/MLP mode. Coarse style: direct colour grid, plain
    Adam with a per-voxel lr, full-size gradients under the clip box. Fine
    style: MLP colours, ``skip_zero_grad`` grids, so region mode (box-sized
    gradients, box-sliced Adam).

    Loss and PSNR agree to 1e-4 relative. Adam turns a gradient into a
    step of about ``lr * g / (|g| + 1e-8)``, which magnifies the f32
    rounding of near-zero gradients, so parameters agree to 2% of the
    largest step taken (and most entries far closer), second moments to
    1e-3 of their largest entry."""
    fine = stage == "fine"
    jm, tm = _model_pair(3, 12 if fine else 0, True)
    axis, n_rand, n_pool = 0, 256, 1024
    ro, rd, vd, rgb = _rays(4, n_pool)
    jcfg, tcfg = JaxConfig.fromfile(DEFAULT_CFG), TorchConfig.fromfile(
        DEFAULT_CFG)
    j_ct, t_ct = _cfg_train(jcfg, stage, n_rand), _cfg_train(tcfg, stage,
                                                            n_rand)
    clip_sizes, clip_off = jm.sweep_clip_for_axis(axis)
    assert clip_sizes == tm.sweep_clip_for_axis(axis)[0]

    j_opt = jax_train.create_optimizer_or_freeze_model(jm, j_ct)
    j_state = j_opt.init(jm.params)
    t_opt = torch_train.create_optimizer_or_freeze_model(tm, t_ct)
    assert set(t_opt.groups) == set(j_opt.group_cfg)
    if not fine:
        cnt = np.random.default_rng(5).integers(
            0, 12, tm.world_size).astype(np.float32)
        j_state = JaxAdam.set_pervoxel_lr(j_state, jnp.asarray(cnt))
        t_opt.set_pervoxel_lr(torch.tensor(cnt))
    # carry a non-trivial optimizer state across: one JAX-layout pytree
    rng = np.random.default_rng(6)
    j_state = dict(j_state, step=jnp.asarray(7, jnp.int32))
    for key, scale in (("exp_avg", 1e-3), ("exp_avg_sq", 1e-6)):
        j_state[key] = jax.tree_util.tree_map(
            lambda x: jnp.asarray(np.abs(rng.normal(
                0, scale, x.shape)).astype(np.float32)), j_state[key])
    convert.opt_state_from_jax(_np_tree(j_state), t_opt)

    j_step = jax_train.make_train_step(jm, j_opt, j_ct, RK, False, False,
                                       axis=axis, clip_sizes=clip_sizes)
    t_step = torch_train.make_train_step(tm, t_opt, t_ct, RK, False, False,
                                         axis=axis, clip_sizes=clip_sizes)
    j_pool = {"rgb": jnp.asarray(rgb), "rays_o": jnp.asarray(ro),
              "rays_d": jnp.asarray(rd), "viewdirs": jnp.asarray(vd)}
    t_pool = {k: torch.tensor(np.asarray(v)) for k, v in j_pool.items()}
    p0 = np.asarray(jm.params["density"]).copy()
    params = jm.params
    for i in range(3):
        sel = np.random.default_rng(10 + i).permutation(n_pool)[:n_rand]
        params, j_state, loss_j, psnr_j = j_step(
            params, jm.mask, j_state, j_pool, jnp.asarray(sel, jnp.int32),
            jnp.asarray(clip_off))
        loss_t, psnr_t = t_step(t_pool, torch.tensor(sel), clip_off)
        assert abs(float(loss_t) - float(loss_j)) < 1e-4 * float(loss_j)
        assert abs(float(psnr_t) - float(psnr_j)) < 1e-3

    t_state = convert.opt_state_to_jax(t_opt)
    assert int(t_state["step"]) == int(j_state["step"]) == 10
    t_params, _ = convert.params_to_jax(tm)
    moved = np.abs(np.asarray(params["density"]) - p0).max()
    assert moved > 1e-3
    for name in ("density", "k0"):
        ref = np.asarray(params[name])
        err = np.abs(t_params[name] - ref)
        assert err.max() < 2e-2 * moved, name
        assert np.mean(err < 1e-5) > 0.995, name
    for a, b in zip(jax.tree_util.tree_leaves(t_params.get("rgbnet", {})),
                    jax.tree_util.tree_leaves(params.get("rgbnet", {}))):
        assert np.abs(a - np.asarray(b)).max() < 2e-2 * 3 * 1e-3
    for key in ("exp_avg", "exp_avg_sq"):
        flat_t = jax.tree_util.tree_leaves(t_state[key])
        flat_j = jax.tree_util.tree_leaves(j_state[key])
        assert len(flat_t) == len(flat_j)
        for a, b in zip(flat_t, flat_j):
            b = np.asarray(b)
            assert np.abs(a - b).max() < 1e-3 * np.abs(b).max(), key


# ------------------------------------------------------- state surgery

@pytest.fixture(scope="module")
def tiny_data():
    return make_synthetic_dataset(n_train=10, n_val=1, n_test=2, H=40, W=40)


@pytest.fixture(scope="module")
def fine_pair(tmp_path_factory, tiny_data):
    """A coarse JAX checkpoint (a blob of density) and a fine model of each
    package that takes its mask from it."""
    rng = np.random.default_rng(20)
    kw = dict(xyz_min=[-1.2, -1.1, -1.0], xyz_max=[1.1, 1.2, 1.0],
              alpha_init=1e-2, fast_color_thres=1e-4, k_density=None,
              k_color=0)
    coarse = JaxDVGO(num_voxels=20 ** 3, num_voxels_base=20 ** 3,
                     rgbnet_dim=0, **kw)
    pts = np.asarray(coarse.grid_points())
    coarse.params["density"] = jnp.asarray(
        (14.0 * np.exp(-3.0 * (pts ** 2).sum(-1)) - 6.0).astype(np.float32))
    path = str(tmp_path_factory.mktemp("coarse") / "coarse_last.tar")
    jax_ckpt.save_model_checkpoint(path, coarse, 0)
    jm = JaxDVGO(num_voxels=16 ** 3, num_voxels_base=24 ** 3, rgbnet_dim=6,
                 rgbnet_width=16, mask_cache_path=path, **kw)
    pts = np.asarray(jm.grid_points())
    jm.params["density"] = jnp.asarray(
        (12.0 * np.exp(-3.0 * (pts ** 2).sum(-1)) - 5.0
         + rng.normal(0, 0.3, pts.shape[:3])).astype(np.float32))
    jm.params["k0"] = jnp.asarray(rng.normal(
        0, 0.5, jm.params["k0"].shape).astype(np.float32))
    tm = TorchDVGO(**jm.get_kwargs(), device="cpu")
    np.testing.assert_array_equal(tm.mask.numpy(), np.asarray(jm.mask))
    tm.load_state_dict(convert.params_from_jax(_np_tree(jm.params),
                                               np.asarray(jm.mask)))
    return jm, tm


def test_state_surgery_matches_jax(fine_pair, tiny_data):
    """``maskout_near_cam_vox``, ``update_occupancy_cache`` and
    ``scale_volume_grid`` (with its mask refresh from the new density and
    the coarse checkpoint), applied in turn to both models."""
    jm, tm = fine_pair
    cams = tiny_data["poses"][tiny_data["i_train"], :3, 3] * 0.3
    jm.maskout_near_cam_vox(cams, 0.4)
    tm.maskout_near_cam_vox(cams, 0.4)
    assert (np.asarray(jm.params["density"]) == -100).any()
    np.testing.assert_array_equal(tm.density.detach().numpy(),
                                  np.asarray(jm.params["density"]))
    jm.update_occupancy_cache()
    tm.update_occupancy_cache()
    assert 0 < np.asarray(jm.mask).mean() < 1
    np.testing.assert_array_equal(tm.mask.numpy(), np.asarray(jm.mask))
    for ax in range(3):
        js, jo = jm.sweep_clip_for_axis(ax, quantum=4)
        ts, to = tm.sweep_clip_for_axis(ax, quantum=4)
        assert js == ts and np.array_equal(jo, to) and js is not None
        kept = tm.sweep_clip_for_axis(ax, fixed_sizes=tuple(
            min(s + 1, w) for s, w in zip(ts, np.asarray(tm.world_size)[
                list({0: (0, 1, 2), 1: (1, 0, 2), 2: (2, 0, 1)}[ax])])))
        ref = jm.sweep_clip_for_axis(ax, fixed_sizes=kept[0])
        assert kept[0] == ref[0] and np.array_equal(kept[1], ref[1])
    jm.scale_volume_grid(24 ** 3)
    tm.scale_volume_grid(24 ** 3)
    assert tuple(tm.world_size) == tuple(jm.world_size)
    assert tuple(tm.density.shape) == tuple(jm.world_size)
    # three separable f32 contractions in another order
    np.testing.assert_allclose(tm.density.detach().numpy(),
                               np.asarray(jm.params["density"]), atol=2e-5)
    np.testing.assert_allclose(tm.k0.detach().numpy(),
                               np.asarray(jm.params["k0"]), atol=2e-5)
    # a voxel whose pooled alpha sits within rounding of the threshold may
    # fall on either side
    assert np.mean(tm.mask.numpy() != np.asarray(jm.mask)) < 1e-3
    assert 0 < tm.mask.float().mean() < 1


def test_voxel_count_views_matches_jax(tiny_data):
    """The sweep-form view count (K-A / K-C at one f32 channel with an
    all-ones cotangent, thresholded per view) on the tiny fixture's rays,
    in the flat and the per-image ray layouts."""
    kw = dict(xyz_min=[-1.3, -1.3, -1.3], xyz_max=[1.3, 1.3, 1.3],
              num_voxels=22 ** 3, num_voxels_base=22 ** 3, alpha_init=1e-6,
              fast_color_thres=1e-7, k_density=None, k_color=0)
    jm, tm = JaxDVGO(**kw), TorchDVGO(**kw, device="cpu")
    d, i_tr = tiny_data, tiny_data["i_train"]
    args = dict(train_poses=d["poses"][i_tr], HW=d["HW"][i_tr],
                Ks=d["Ks"][i_tr], ndc=False, inverse_y=False, flip_x=False,
                flip_y=False)
    imgs = np.asarray(d["images"], np.float32)[i_tr]
    for fn_name, key in (("get_training_rays_flatten", "rgb_tr_ori"),
                         ("get_training_rays", "rgb_tr")):
        out_j = getattr(jax_rays, fn_name)(**{key: imgs}, **args)
        out_t = getattr(torch_rays, fn_name)(**{key: imgs}, **args)
        for a, b in zip(out_j[:4], out_t[:4]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert list(out_j[4]) == list(out_t[4])
        _, ro, rd, _, imsz = out_t
        cnt_j = np.asarray(jm.voxel_count_views(
            ro, rd, imsz, near=d["near"], far=d["far"], stepsize=0.5))
        cnt_t = tm.voxel_count_views(
            ro, rd, imsz, near=d["near"], far=d["far"], stepsize=0.5).numpy()
        assert cnt_j.max() == len(i_tr) and cnt_j.min() == 0
        # a voxel whose per-view sum sits within f32 rounding of the
        # threshold 1 may be counted by one package only
        assert np.mean(cnt_t != cnt_j) < 2e-3
        assert np.abs(cnt_t - cnt_j).max() <= 1


def test_in_maskcache_ray_pool_matches_jax(fine_pair, tiny_data):
    """``get_training_rays_in_maskcache_sampling``: the rays that hit the
    coarse geometry (``hit_coarse_geo_view`` on device-generated rays), and
    ``hit_coarse_geo`` on host rays."""
    jm, tm = fine_pair
    d, i_tr = tiny_data, tiny_data["i_train"]
    rk = dict(near=d["near"], far=d["far"], bg=1, stepsize=0.5,
              inverse_y=False, flip_x=False, flip_y=False)
    args = dict(rgb_tr_ori=np.asarray(d["images"], np.float32)[i_tr],
                train_poses=d["poses"][i_tr], HW=d["HW"][i_tr],
                Ks=d["Ks"][i_tr], ndc=False, inverse_y=False, flip_x=False,
                flip_y=False, render_kwargs=rk)
    out_j = jax_rays.get_training_rays_in_maskcache_sampling(model=jm, **args)
    out_t = torch_rays.get_training_rays_in_maskcache_sampling(model=tm,
                                                               **args)
    n_all = 10 * 40 * 40
    assert 0.05 * n_all < len(out_j[0]) < 0.95 * n_all
    # a sample point within rounding of a voxel boundary may look up the
    # neighbouring mask voxel: per view, at most 2 rays of 1600 differ
    assert all(abs(a - b) <= 2 for a, b in zip(out_j[4], out_t[4]))
    if list(out_j[4]) == list(out_t[4]):
        for a, b in zip(out_j[:4], out_t[:4]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    ro, rd, _ = torch_rays.get_rays_of_a_view(
        40, 40, d["Ks"][0], d["poses"][0], False, False, False, False)
    hit_t = tm.hit_coarse_geo(ro, rd, d["near"], d["far"], 0.5)
    hit_j = np.asarray(jm.hit_coarse_geo(ro, rd, d["near"], d["far"], 0.5))
    assert hit_t.shape == (1600,) and 0 < hit_j.mean() < 1
    assert np.sum(hit_t != hit_j) <= 2


# ------------------------------------------ the training path as a whole

def _tiny_cfg(basedir, cls):
    cfg = cls.fromfile(DEFAULT_CFG)
    cfg.expname = "tiny_e2e"
    cfg.basedir = str(basedir)
    cfg.data.dataset_type = "synthetic_fixture"
    cfg.data.white_bkgd = True
    cfg.coarse_train.N_iters = 150
    cfg.coarse_train.N_rand = 512
    cfg.coarse_train.lrate_density = 0.3
    cfg.fine_train.N_iters = 150
    cfg.fine_train.N_rand = 512
    cfg.fine_train.pg_scale = [75]
    cfg.coarse_model_and_render.num_voxels = 24 ** 3
    cfg.coarse_model_and_render.num_voxels_base = 24 ** 3
    cfg.fine_model_and_render.num_voxels = 32 ** 3
    cfg.fine_model_and_render.num_voxels_base = 32 ** 3
    cfg.fine_model_and_render.rgbnet_dim = 6
    cfg.fine_model_and_render.rgbnet_width = 32
    cfg.fine_model_and_render.k_density = 64
    cfg.fine_model_and_render.k_color = 32
    return cfg


def _args(**kw):
    base = dict(seed=777, no_reload=False, no_reload_optimizer=False,
                ft_path="", i_print=50, i_weights=100)
    base.update(kw)
    return types.SimpleNamespace(**base)


@pytest.fixture(scope="module")
def trained(tmp_path_factory, tiny_data):
    cfg = _tiny_cfg(tmp_path_factory.mktemp("logs"), TorchConfig)
    model = torch_train.train(_args(), cfg, tiny_data, device="cpu")
    return cfg, model


def test_port_trains_the_tiny_fixture_and_jax_renders_it(trained, tiny_data):
    """The port's ``train()`` on the configuration of the JAX package's own
    end-to-end test writes both checkpoints; the JAX package loads
    ``fine_last.tar`` and renders the test views above 18 dB and within
    2.5 dB of that test's 30.86 dB golden."""
    cfg, model = trained
    logdir = os.path.join(cfg.basedir, cfg.expname)
    for name in ("coarse_last.tar", "fine_last.tar", "coarse_000100.tar",
                 "fine_000100.tar", "config.py", "args.txt"):
        assert os.path.isfile(os.path.join(logdir, name)), name
    st = torch_ckpt.load_checkpoint_file(os.path.join(logdir,
                                                      "fine_last.tar"))
    assert st["global_step"] == 150
    assert int(st["optimizer_state_dict"]["step"]) == 76   # fresh at step 75
    assert all(np.isfinite(p.detach().numpy()).all()
               for p in model.parameters())
    jm = jax_ckpt.load_model(JaxDVGO, os.path.join(logdir, "fine_last.tar"))
    d, i_test = tiny_data, tiny_data["i_test"]
    rk = {"near": d["near"], "far": d["far"], "bg": 1, "stepsize": 0.5,
          "inverse_y": False, "render_depth": True}
    rgbs, depths, stats = jax_render.render_viewpoints(
        model=jm, render_poses=d["poses"][i_test], HW=d["HW"][i_test],
        Ks=d["Ks"][i_test], ndc=False, render_kwargs=rk,
        gt_imgs=[d["images"][i] for i in i_test], chunk=2048, verbose=False)
    psnr = float(np.mean(stats["psnr"]))
    print("port-trained fixture psnr:", psnr)
    assert psnr > 18.0
    assert abs(psnr - 30.86) < 2.5
    assert rgbs.shape == (2, 40, 40, 3) and np.isfinite(depths).all()


def test_reentry_resumes_without_training(trained, tiny_data, capsys):
    cfg, model = trained
    logdir = os.path.join(cfg.basedir, cfg.expname)
    before = os.path.getmtime(os.path.join(logdir, "fine_last.tar"))
    xyz_min, xyz_max = torch_train.compute_bbox_by_cam_frustrm(
        cfg=cfg, **tiny_data)
    again = torch_train.scene_rep_reconstruction(
        args=_args(), cfg=cfg, cfg_model=cfg.fine_model_and_render,
        cfg_train=cfg.fine_train, xyz_min=xyz_min, xyz_max=xyz_max,
        data_dict=tiny_data, stage="fine", device="cpu",
        coarse_ckpt_path=os.path.join(logdir, "coarse_last.tar"))
    out = capsys.readouterr().out
    assert "reload from" in out and "iter" not in out
    assert os.path.getmtime(os.path.join(logdir, "fine_last.tar")) == before
    assert torch.equal(again.density, model.density)


def test_interrupted_stage_resumes_from_numbered_checkpoint(trained,
                                                            tiny_data,
                                                            tmp_path,
                                                            capsys):
    """With no ``fine_last.tar`` the stage picks up the newest numbered
    checkpoint with its optimizer state and trains the remaining steps."""
    import shutil
    cfg, _ = trained
    src = os.path.join(cfg.basedir, cfg.expname)
    cfg2 = _tiny_cfg(tmp_path, TorchConfig)
    dst = os.path.join(cfg2.basedir, cfg2.expname)
    os.makedirs(dst)
    for name in ("coarse_last.tar", "fine_000100.tar"):
        shutil.copy(os.path.join(src, name), dst)
    xyz_min, xyz_max = torch_train.compute_bbox_by_coarse_geo(
        TorchDVGO, os.path.join(dst, "coarse_last.tar"), 1e-3, device="cpu")
    torch_train.scene_rep_reconstruction(
        args=_args(i_weights=100000), cfg=cfg2,
        cfg_model=cfg2.fine_model_and_render, cfg_train=cfg2.fine_train,
        xyz_min=xyz_min, xyz_max=xyz_max, data_dict=tiny_data, stage="fine",
        device="cpu", coarse_ckpt_path=os.path.join(dst, "coarse_last.tar"))
    out = capsys.readouterr().out
    assert "fine_000100.tar" in out and "iter    150" in out
    st = torch_ckpt.load_checkpoint_file(os.path.join(dst, "fine_last.tar"))
    assert st["global_step"] == 150
    assert int(st["optimizer_state_dict"]["step"]) == 76
