"""The port's forward-facing (NDC) path against the JAX package on the CPU:
DirectMPIGO's state (init, progressive scaling, occupancy renewal, the
coarse-geometry ray filter), its z-sweep forward with its gradients, one
train step in each TV mode, the NDC fixture and LLFF loaders, the NDC
bbox, checkpoints both ways, and the path as a whole (the port trains the
tiny NDC fixture through ``run.main`` and the JAX package renders the
checkpoint it wrote).

The port runs its kernels' plain versions (CPU tensors); inputs are made
with numpy from a seed and handed to both packages.
"""

import contextlib
import importlib
import io
import os
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from directvoxgo_tpu.config import Config as JaxConfig
from directvoxgo_tpu.config import ConfigDict as JaxConfigDict
from directvoxgo_tpu.engine import checkpoint as jax_ckpt
from directvoxgo_tpu.engine import render as jax_render
from directvoxgo_tpu.engine import train as jax_train
from directvoxgo_tpu.models.dmpigo import DirectMPIGO as JaxMPIGO
from directvoxgo_tpu_torch import convert
from directvoxgo_tpu_torch import run as torch_run
from directvoxgo_tpu_torch.config import Config as TorchConfig
from directvoxgo_tpu_torch.config import ConfigDict as TorchConfigDict
from directvoxgo_tpu_torch.engine import checkpoint as torch_ckpt
from directvoxgo_tpu_torch.engine import render as torch_render
from directvoxgo_tpu_torch.engine import train as torch_train
from directvoxgo_tpu_torch.models.dmpigo import DirectMPIGO as TorchMPIGO

jax_load_data = importlib.import_module("directvoxgo_tpu.data.load_data")
torch_load_data = importlib.import_module(
    "directvoxgo_tpu_torch.data.load_data")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_CFG = os.path.join(REPO, "configs", "synthetic", "fixture_ndc_tiny.py")
BOX = dict(xyz_min=[-1.0, -1.0, -1.0], xyz_max=[1.0, 1.0, 1.0])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_same(a, b, path="root"):
    """Recursive equality of dicts, lists and numpy arrays."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert np.array_equal(a, b), path
    else:
        assert a == b, path


def _model_pair(seed, rgbnet_dim=0, f32=True, topk=0, carve=False):
    """A JAX DMPIGO (24x24x64 over the NDC box) with a sharp off-centre
    blob of density and random colour features, and the port's model with
    the same parameters and mask. ``carve``: the mask is the blob's
    occupancy, so the z sweep's clip box shrinks."""
    rng = np.random.default_rng(seed)
    jm = JaxMPIGO(num_voxels=24 * 24 * 64, mpi_depth=64,
                  fast_color_thres=1e-4, rgbnet_dim=rgbnet_dim,
                  rgbnet_width=16, viewbase_pe=2, k_color=0,
                  sweep_color_topk=topk, **BOX)
    pts = np.asarray(jm.grid_points())
    r2 = (((pts - np.array([0.15, -0.1, 0.1])) / 0.3) ** 2).sum(-1)
    dens = 30 * np.exp(-4 * r2) - 12 + rng.normal(0, 0.3, r2.shape)
    dens[..., -1] = 10.0
    jm.params["density"] = jnp.asarray(dens.astype(np.float32))
    jm.params["k0"] = jnp.asarray(rng.normal(
        0, 0.5, jm.params["k0"].shape).astype(np.float32))
    if carve:
        jm.mask = jm.activate_density(jm.params["density"]) > 1e-3
        jm.mask = jm.mask.at[..., -1].set(False)
    tm = TorchMPIGO(**jm.get_kwargs(), device="cpu")
    tm.load_state_dict(convert.params_from_jax(_np_tree(jm.params),
                                               np.asarray(jm.mask)))
    if f32:
        jm.sweep_dtype, jm.mlp_dtype = jnp.float32, None
        tm.sweep_dtype, tm.mlp_dtype = torch.float32, None
    return jm, tm


def _ndc_rays(seed, n):
    """NDC-space rays: origins on the near plane z = -1, directions with
    d_z = 2 (the whole box's depth), small in-plane slopes."""
    rng = np.random.default_rng(seed)
    o = np.stack([rng.uniform(-0.4, 0.6, n), rng.uniform(-0.6, 0.4, n),
                  np.full(n, -1.0)], -1).astype(np.float32)
    d = np.stack([rng.uniform(-0.2, 0.2, n), rng.uniform(-0.2, 0.2, n),
                  np.full(n, 2.0)], -1).astype(np.float32)
    vd = d / np.linalg.norm(d, axis=-1, keepdims=True)
    rgb = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    return o, d, vd.astype(np.float32), rgb


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


# --------------------------------------------------------------- the model

@pytest.mark.parametrize("rgbnet_dim", [0, 9])
def test_init_matches_jax(rgbnet_dim):
    """World size (xy from the voxel budget over the xy extent, truncated),
    ``voxel_size_ratio`` 256/mpi_depth, the density init (computed in f64,
    stored f32) bit for bit, zero k0, the MLP's layer shapes and the
    checkpoint manifest."""
    kw = dict(xyz_min=[-1.43, -1.52, -1.0], xyz_max=[1.40, 1.46, 1.0],
              num_voxels=256 ** 3 // 16, mpi_depth=128,
              fast_color_thres=1e-3, rgbnet_dim=rgbnet_dim, rgbnet_width=64,
              sweep_color_topk=64)
    jm = JaxMPIGO(**kw)
    tm = TorchMPIGO(**kw, device="cpu")
    assert tm.world_size == jm.world_size == (88, 92, 128)
    assert tm.voxel_size_ratio == jm.voxel_size_ratio == 2.0
    assert tm.voxel_size == jm.voxel_size
    np.testing.assert_array_equal(tm.density.detach().numpy(),
                                  np.asarray(jm.params["density"]))
    np.testing.assert_array_equal(tm.k0.detach().numpy(),
                                  np.asarray(jm.params["k0"]))
    np.testing.assert_array_equal(tm.mask.numpy(), np.asarray(jm.mask))
    _assert_same(tm.get_kwargs(), jm.get_kwargs())
    assert tm.forced_sweep_axis == jm.forced_sweep_axis == 2
    assert tm.tv_axis_scales() == jm.tv_axis_scales()
    if rgbnet_dim:
        shapes = [tuple(l_.weight.shape[::-1]) for l_ in tm.rgbnet.layers]
        assert shapes == [tuple(layer["w"].shape)
                          for layer in jm.params["rgbnet"]["layers"]]
    else:
        assert tm.rgbnet is None and "rgbnet" not in jm.params


def test_scale_volume_grid_and_renewal_match_jax():
    """Progressive scaling (trilinear upsample of both grids, mask from the
    new density alone) and the occupancy renewal ``mask &= maxpool(alpha)
    > thres``, against the JAX model from the same state."""
    jm, tm = _model_pair(3, rgbnet_dim=6, carve=True)
    jm.scale_volume_grid(40 * 36 * 64, 64)
    tm.scale_volume_grid(40 * 36 * 64, 64)
    assert tm.world_size == jm.world_size and tm.world_size[2] == 64
    for name in ("density", "k0"):
        ref = np.asarray(jm.params[name])
        got = getattr(tm, name).detach().numpy()
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max(), name
    assert np.sum(tm.mask.numpy() != np.asarray(jm.mask)) <= 2
    assert 0 < np.asarray(jm.mask).mean() < 1
    rng = np.random.default_rng(4)
    d = (np.asarray(jm.params["density"])
         + rng.normal(0, 3, jm.world_size)).astype(np.float32)
    jm.params["density"] = jnp.asarray(d)
    with torch.no_grad():
        tm.density.copy_(torch.tensor(d))
        tm.mask.copy_(torch.tensor(np.asarray(jm.mask)))
    jm.update_occupancy_cache()
    tm.update_occupancy_cache()
    assert np.sum(tm.mask.numpy() != np.asarray(jm.mask)) <= 2
    assert tm.sweep_clip_for_axis(2)[0] == jm.sweep_clip_for_axis(2)[0]


def test_hit_coarse_geo_matches_jax():
    """The NDC-sampler ray filter over a carved mask."""
    jm, tm = _model_pair(5, carve=True)
    o, d, _, _ = _ndc_rays(6, 700)
    hit_j = jm.hit_coarse_geo(o, d, 0.0, 1.0, 0.5)
    hit_t = tm.hit_coarse_geo(o, d, 0.0, 1.0, 0.5)
    assert hit_t.shape == (700,) and 0 < hit_j.mean() < 1
    assert np.sum(hit_t != hit_j) <= 2


def test_hit_coarse_geo_is_bitwise_jax():
    """The NDC-sampler ray filter over a carved mask, bit for bit, its
    sample points one fused multiply-add each as the JAX package's
    compiled filter computes them."""
    jm, tm = _model_pair(5, carve=True)
    o, d, _, _ = _ndc_rays(7, 20000)
    hit_j = jm.hit_coarse_geo(o, d, 0.0, 1.0, 0.5)
    hit_t = tm.hit_coarse_geo(o, d, 0.0, 1.0, 0.5)
    assert 0 < hit_j.mean() < 1
    np.testing.assert_array_equal(hit_t, hit_j)


# (rgbnet_dim, sweep_color_topk, f32, clipped, stepsize)
SWEEP_CASES = {
    "sigmoid_k1": (0, 0, True, False, 1.0),
    "mlp_topk": (6, 48, True, False, 0.5),
    "mlp_clipped": (6, 48, True, True, 0.5),
    "mlp_topk_bf16": (6, 48, False, False, 0.5),
}


@pytest.mark.parametrize("case", list(SWEEP_CASES))
def test_forward_sweep_matches_jax(case):
    """``forward_sweep`` along z: rgb, alphainv_last and depth (in sample
    index units) of the port and of JAX, and the gradients of the train
    loss for density, k0 and the MLP. With the top-K compaction on (S =
    127 stations > 96), sigmoid colours at k = 1, and a sweep clipped to
    the occupancy box (31 stations from plane ``p_offset``, too few to
    compact). Tolerances of the JAX
    oracle (tests/test_dmpigo.py): f32 rgb and alphainv within 2e-5, depth
    within 1e-2, gradients within 2e-3 of each gradient's largest entry;
    bf16 sweeps round grids, weights and MLP activations to bf16 at the
    same points in both packages, so values agree within the oracle's
    sweep bound of 3e-2 (2e-2 for alphainv) and gradients within 6e-2 (a
    bias cotangent sums thousands of bf16 values, reduced differently)."""
    rgbnet_dim, topk, f32, clipped, stepsize = SWEEP_CASES[case]
    jm, tm = _model_pair(1, rgbnet_dim, f32, topk, carve=clipped)
    n = 256
    o, d, vd, rgb = _ndc_rays(2, n)
    clip_sizes, clip_off = jm.sweep_clip_for_axis(2)
    assert (clip_sizes is not None) == clipped
    rk = dict(near=0.0, far=1.0, bg=0.0, stepsize=stepsize)

    def jax_loss(params):
        ret = jm.forward_sweep(params, jm.mask, jnp.asarray(o),
                               jnp.asarray(d), jnp.asarray(vd), 2,
                               render_depth=True, clip_sizes=clip_sizes,
                               clip_offsets=jnp.asarray(clip_off), **rk)
        return _loss_jax(ret, jnp.asarray(rgb), n), ret

    (loss_j, ret_j), g_j = jax.value_and_grad(jax_loss, has_aux=True)(
        jm.params)
    leaves = [tm.density, tm.k0] + (list(tm.rgbnet.parameters())
                                    if rgbnet_dim else [])
    ret_t = tm.forward_sweep(torch.tensor(o), torch.tensor(d),
                             torch.tensor(vd), 2, render_depth=True,
                             clip_sizes=clip_sizes, clip_offsets=clip_off,
                             **rk)
    assert ret_t["weights"].shape[1] == (
        31 if clipped else topk if topk else int(63 / stepsize) + 1)
    loss_t = _loss_torch(ret_t, torch.tensor(rgb), n)
    grads = torch.autograd.grad(loss_t, leaves)

    tol_v, tol_a, tol_g = (2e-5, 2e-5, 2e-3) if f32 else (3e-2, 2e-2, 6e-2)
    rgb_t = ret_t["rgb_marched"].detach().numpy()
    assert np.abs(rgb_t - np.asarray(ret_j["rgb_marched"])).max() < tol_v
    assert np.abs(ret_t["alphainv_last"].detach().numpy()
                  - np.asarray(ret_j["alphainv_last"])).max() < tol_a
    dep_j = np.asarray(ret_j["depth"])
    assert dep_j.max() > 5.0
    assert np.abs(ret_t["depth"].numpy() - dep_j).max() < (
        1e-2 if f32 else 0.5)
    assert abs(float(loss_t.detach()) - float(loss_j)) < tol_g * float(loss_j)
    pairs = [("density", grads[0].numpy(), np.asarray(g_j["density"])),
             ("k0", grads[1].numpy(), np.asarray(g_j["k0"]))]
    if rgbnet_dim:
        for i, layer in enumerate(g_j["rgbnet"]["layers"]):
            pairs.append((f"w{i}", grads[2 + 2 * i].numpy().T,
                          np.asarray(layer["w"])))
            pairs.append((f"b{i}", grads[3 + 2 * i].numpy(),
                          np.asarray(layer["b"])))
    for name, got, ref in pairs:
        assert got.shape == ref.shape, name
        assert np.abs(ref).max() > 0, name
        assert np.abs(got - ref).max() < tol_g * np.abs(ref).max(), name


# ------------------------------------------------------- one train step

def _cfg_train(cls, n_rand):
    return cls(N_rand=n_rand, weight_main=1.0, weight_entropy_last=0.001,
               weight_rgbper=0.01, weight_tv_density=1e-1,
               weight_tv_k0=1e-1, lrate_decay=20, lrate_density=1e-1,
               lrate_k0=1e-1, lrate_rgbnet=1e-3,
               skip_zero_grad_fields=["density", "k0"])


# mode -> (apply_tv, tv_dense, clipped): no TV, dense TV (whole grid, full
# gradients), sparse TV on the whole grid (no clip box) and sparse TV on
# the clip box (region mode, the boxed form)
STEP_MODES = {"no_tv": (False, False, True), "dense_tv": (True, True, True),
              "sparse_tv": (True, False, False),
              "sparse_tv_box": (True, False, True)}


@pytest.mark.parametrize("mode", list(STEP_MODES))
def test_train_step_matches_jax(mode):
    """One ``make_train_step`` step of both packages from the same
    parameters, mask and (carried-over, non-trivial) optimizer state on the
    same ray indices, f32 sweep and MLP. Loss and PSNR within 1e-4
    relative; parameters within 2% of the largest step taken and nearly all
    entries within 1e-5 (Adam turns a gradient into a step of about
    ``lr * g / sqrt(v)``, which magnifies the f32 rounding of small
    gradients); optimizer moments within 1e-3 of their largest entry. The
    TV weights are large enough here that the term moves the step."""
    apply_tv, tv_dense, clipped = STEP_MODES[mode]
    jm, tm = _model_pair(7, rgbnet_dim=6, carve=True)
    if not clipped:
        jm.mask = jnp.ones(jm.world_size, bool)
        with torch.no_grad():
            tm.mask.fill_(True)
    clip_sizes, clip_off = jm.sweep_clip_for_axis(2)
    assert (clip_sizes is not None) == clipped
    n_rand, n_pool = 256, 512
    ro, rd, vd, rgb = _ndc_rays(8, n_pool)
    rk = dict(near=0.0, far=1.0, bg=0.0, stepsize=0.5)
    j_ct, t_ct = _cfg_train(JaxConfigDict, n_rand), _cfg_train(
        TorchConfigDict, n_rand)
    j_opt = jax_train.create_optimizer_or_freeze_model(jm, j_ct)
    t_opt = torch_train.create_optimizer_or_freeze_model(tm, t_ct)
    assert set(t_opt.groups) == set(j_opt.group_cfg) == {"density", "k0",
                                                          "rgbnet"}
    rng = np.random.default_rng(9)
    j_state = dict(j_opt.init(jm.params), step=jnp.asarray(5, jnp.int32))
    for key, scale in (("exp_avg", 1e-3), ("exp_avg_sq", 1e-6)):
        j_state[key] = jax.tree_util.tree_map(
            lambda x: jnp.asarray(np.abs(rng.normal(
                0, scale, x.shape)).astype(np.float32)), j_state[key])
    convert.opt_state_from_jax(_np_tree(j_state), t_opt)

    j_step = jax_train.make_train_step(jm, j_opt, j_ct, rk, apply_tv,
                                       tv_dense, axis=2,
                                       clip_sizes=clip_sizes)
    t_step = torch_train.make_train_step(tm, t_opt, t_ct, rk, apply_tv,
                                         tv_dense, axis=2,
                                         clip_sizes=clip_sizes)
    j_pool = {"rgb": jnp.asarray(rgb), "rays_o": jnp.asarray(ro),
              "rays_d": jnp.asarray(rd), "viewdirs": jnp.asarray(vd)}
    t_pool = {k: torch.tensor(np.asarray(v)) for k, v in j_pool.items()}
    sel = np.random.default_rng(10).permutation(n_pool)[:n_rand]
    p0 = {n: np.asarray(jm.params[n]).copy() for n in ("density", "k0")}
    params, j_state, loss_j, psnr_j = j_step(
        jm.params, jm.mask, j_state, j_pool, jnp.asarray(sel, jnp.int32),
        jnp.asarray(clip_off))
    loss_t, psnr_t = t_step(t_pool, torch.tensor(sel), clip_off)
    assert abs(float(loss_t) - float(loss_j)) < 1e-4 * float(loss_j)
    assert abs(float(psnr_t) - float(psnr_j)) < 1e-3

    t_state = convert.opt_state_to_jax(t_opt)
    assert int(t_state["step"]) == int(j_state["step"]) == 6
    t_params, _ = convert.params_to_jax(tm)
    for name in ("density", "k0"):
        ref = np.asarray(params[name])
        step = np.abs(ref - p0[name])
        moved = step.max()
        assert moved > 1e-3, name
        err = np.abs(t_params[name] - ref)
        assert err.max() < 2e-2 * moved, name
        assert np.mean(err < 1e-5) > 0.995, name
        if apply_tv and tv_dense:
            # dense TV moves voxels that no ray touched
            assert np.mean(step > 0) > 0.9, name
    for a, b in zip(jax.tree_util.tree_leaves(t_params["rgbnet"]),
                    jax.tree_util.tree_leaves(params["rgbnet"])):
        assert np.abs(a - np.asarray(b)).max() < 2e-2 * 3 * 1e-3
    for key in ("exp_avg", "exp_avg_sq"):
        flat_t = jax.tree_util.tree_leaves(t_state[key])
        flat_j = jax.tree_util.tree_leaves(j_state[key])
        assert len(flat_t) == len(flat_j)
        for a, b in zip(flat_t, flat_j):
            b = np.asarray(b)
            assert np.abs(a - b).max() < 1e-3 * np.abs(b).max(), key
            np.testing.assert_array_equal(a == 0, b == 0)


# ------------------------------------------------------------ loaders

def test_ndc_fixture_and_bbox_match_jax():
    """The tiny NDC fixture's data dict, identical to JAX's, and the NDC
    frustum bbox of its training views."""
    cfg_j = JaxConfig.fromfile(TINY_CFG)
    cfg_t = TorchConfig.fromfile(TINY_CFG)
    d_t = torch_load_data.load_everything(None, cfg_t)
    d_j = jax_load_data.load_everything(None, cfg_j)
    _assert_same(d_t, d_j)
    assert d_t["near"] == 0.0 and d_t["far"] == 1.0
    bb_t = torch_train.compute_bbox_by_cam_frustrm(cfg=cfg_t, **d_t)
    bb_j = jax_train.compute_bbox_by_cam_frustrm(cfg=cfg_j, **d_j)
    _assert_same(list(bb_t), [np.asarray(x) for x in bb_j])
    assert np.allclose(bb_t[0][2], -1.0) and np.allclose(bb_t[1][2], 1.0)


def _llff_dir(root, n=6, h=12, w=16):
    """A small LLFF scene: ``images/*.png`` and ``poses_bounds.npy`` (per
    view a 3x5 [R | t | hwf] matrix in LLFF's [down, right, back] axes,
    then near and far bounds)."""
    import imageio.v2 as imageio
    rng = np.random.default_rng(11)
    os.makedirs(os.path.join(root, "images"))
    rows = []
    for i in range(n):
        a = rng.normal(0, 0.05, 3)
        rot = np.array([[0, 1, 0], [1, 0, 0], [0, 0, -1]], np.float64)
        rot = rot @ np.array([[1, -a[2], a[1]], [a[2], 1, -a[0]],
                              [-a[1], a[0], 1]])
        q, _ = np.linalg.qr(rot)
        t = rng.normal(0, 0.3, (3, 1))
        hwf = np.array([[h], [w], [14.0]])
        rows.append(np.concatenate([np.concatenate([q, t, hwf], 1).ravel(),
                                    [2.0 + rng.uniform(0, 0.5),
                                     9.0 + rng.uniform(0, 2)]]))
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        imageio.imwrite(os.path.join(root, "images", f"{i:03d}.png"), img)
    np.save(os.path.join(root, "poses_bounds.npy"), np.stack(rows))


@pytest.mark.parametrize("factor,spherify,ndc", [(1, False, True),
                                                 (2, True, False)])
def test_llff_data_matches_jax(tmp_path, factor, spherify, ndc):
    """``load_everything`` of an LLFF scene (recentred poses and a spiral
    path, or spherified poses; ``llffhold`` split; NDC 0/1 or bound-derived
    near/far), identical to JAX's; ``factor`` 2 goes through the
    downsampled-images cache."""
    _llff_dir(str(tmp_path))
    data = dict(dataset_type="llff", datadir=str(tmp_path), factor=factor,
                width=None, height=None, spherify=spherify, llffhold=3,
                ndc=ndc, load_depths=False, white_bkgd=False)
    d_j = jax_load_data.load_everything(
        None, JaxConfigDict(data=JaxConfigDict(data)))
    d_t = torch_load_data.load_everything(
        None, TorchConfigDict(data=TorchConfigDict(data)))
    _assert_same(d_t, d_j)
    assert list(d_t["i_test"]) == [0, 3]
    assert d_t["images"].shape == (6, 12 // factor, 16 // factor, 3)
    assert (d_t["near"], d_t["far"]) == ((0.0, 1.0) if ndc else
                                         (d_j["near"], d_j["far"]))


def test_checkpoint_jax_to_port(tmp_path):
    """A JAX DMPIGO checkpoint loads into the port's model unchanged."""
    jm, _ = _model_pair(12, rgbnet_dim=6, carve=True)
    path = str(tmp_path / "fine_last.tar")
    jax_ckpt.save_model_checkpoint(path, jm, 9)
    tm = torch_ckpt.load_model(TorchMPIGO, path, device="cpu")
    assert tm.world_size == jm.world_size
    _assert_same(tm.get_kwargs(), jm.get_kwargs())
    params, mask = convert.params_to_jax(tm)
    _assert_same(params, _np_tree(jm.params))
    np.testing.assert_array_equal(mask, np.asarray(jm.mask))


# ------------------------------------------ the NDC path as a whole

@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """``run.main`` trains the tiny NDC fixture for 200 steps on the CPU
    and renders its test views (``--render_test``), then renders them again
    from the checkpoint (``--render_only``)."""
    root = tmp_path_factory.mktemp("ndc")
    cfg_path = str(root / "ndc_tiny.py")
    with open(cfg_path, "w") as f:
        f.write(f"_base_ = {TINY_CFG!r}\n"
                f"basedir = {str(root)!r}\n"
                "fine_train = {'N_iters': 200}\n")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        torch_run.main(["--config", cfg_path, "--device", "cpu",
                        "--render_test", "--i_print", "100"])
        torch_run.main(["--config", cfg_path, "--device", "cpu",
                        "--render_only", "--render_test"])
    cfg = TorchConfig.fromfile(cfg_path)
    data = torch_load_data.load_everything(None, cfg)
    logdir = os.path.join(cfg.basedir, cfg.expname)
    return cfg, data, logdir, out.getvalue()


def _render_port(model, data):
    i_test = data["i_test"]
    rk = {"near": 0.0, "far": 1.0, "bg": 0, "stepsize": 1.0,
          "inverse_y": False, "render_depth": True}
    return torch_render.render_viewpoints(
        model, data["poses"][i_test], data["HW"][i_test], data["Ks"][i_test],
        True, rk, gt_imgs=[data["images"][i] for i in i_test],
        verbose=False)


def test_port_trains_the_ndc_fixture(trained):
    """200 steps of the tiny NDC fixture: the checkpoint, its step count,
    both renders' PNGs, and test views above the JAX oracle's 28 dB
    (tests/test_train_ndc_e2e.py; an all-black frame scores 16.6 dB)."""
    cfg, data, logdir, _ = trained
    st = torch_ckpt.load_checkpoint_file(os.path.join(logdir,
                                                      "fine_last.tar"))
    assert st["global_step"] == 200
    assert int(st["optimizer_state_dict"]["step"]) == 200
    pngs = [f for f in os.listdir(os.path.join(
        logdir, "render_test_fine_last")) if f.endswith(".png")]
    assert len(pngs) == 2 * len(data["i_test"])      # rgb and depth
    model = torch_ckpt.load_model(TorchMPIGO, os.path.join(
        logdir, "fine_last.tar"), device="cpu")
    rgbs, depths, stats = _render_port(model, data)
    psnr = float(np.mean(stats["psnr"]))
    print("port NDC fixture psnr:", psnr)
    assert psnr > 28.0
    assert stats["path"] == ["rays"] * len(data["i_test"])
    assert np.isfinite(rgbs).all() and np.isfinite(depths).all()


def test_jax_renders_the_port_checkpoint_alike(trained):
    """The JAX package loads the port's checkpoint and renders the test
    views (through its NDC tile renderer) as the port does: both sweep the
    same bf16 slabs along z, so the frames agree within 2e-3 on average
    (the JAX tile renderer's own bound against its chunked path) and 3e-2
    at any pixel."""
    cfg, data, logdir, _ = trained
    path = os.path.join(logdir, "fine_last.tar")
    jm = jax_ckpt.load_model(JaxMPIGO, path)
    model = torch_ckpt.load_model(TorchMPIGO, path, device="cpu")
    rgb_t, dep_t, stats_t = _render_port(model, data)
    i_test = data["i_test"]
    rk = {"near": 0.0, "far": 1.0, "bg": 0, "stepsize": 1.0,
          "inverse_y": False}
    rgb_j, dep_j, stats_j = jax_render.render_viewpoints(
        model=jm, render_poses=data["poses"][i_test], HW=data["HW"][i_test],
        Ks=data["Ks"][i_test], ndc=True, render_kwargs=rk,
        gt_imgs=[data["images"][i] for i in i_test], chunk=2048,
        verbose=False)
    diff = np.abs(rgb_t - np.asarray(rgb_j))
    print("port vs JAX render: mean", diff.mean(), "max", diff.max())
    assert diff.mean() < 2e-3 and diff.max() < 3e-2
    assert abs(np.mean(stats_t["psnr"]) - np.mean(stats_j["psnr"])) < 0.2
    assert np.abs(dep_t - np.asarray(dep_j)).mean() < 0.05


def test_run_without_a_gpu_needs_the_cpu_asked_for():
    """Without ``--device cpu`` and without a GPU ``run.main`` raises, and so
    does the model built without a device: neither falls back to the
    CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        torch_run.main(["--config", TINY_CFG])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchMPIGO(num_voxels=8 * 8 * 8, mpi_depth=8, **BOX)


def test_ndc_engine_routes_rays_to_z_and_reloads(trained, capsys):
    """The training run routed every ray of the pool to the z sweep and
    rendered every test view per ray; re-entering the trained stage
    reloads the DMPIGO checkpoint (the model class follows ``data.ndc``)
    and trains nothing."""
    cfg, data, logdir, log = trained
    n_rays = len(data["i_train"]) * 64 * 64
    assert f"sweep axis groups [0, 0, {n_rays}]" in log
    assert log.count("views rendered by path ['rays', 'rays', 'rays']") == 2
    assert torch_train.model_class_for(cfg) is TorchMPIGO
    args = types.SimpleNamespace(seed=777, no_reload=False,
                                 no_reload_optimizer=False, ft_path="",
                                 i_print=100, i_weights=100000)
    xyz_min, xyz_max = torch_train.compute_bbox_by_cam_frustrm(
        cfg=cfg, **data)
    model = torch_train.scene_rep_reconstruction(
        args=args, cfg=cfg, cfg_model=cfg.fine_model_and_render,
        cfg_train=cfg.fine_train, xyz_min=xyz_min, xyz_max=xyz_max,
        data_dict=data, stage="fine", device="cpu")
    out = capsys.readouterr().out
    assert isinstance(model, TorchMPIGO)
    assert "reload from" in out and "iter" not in out
