"""The port's fused train step (``ops/train_fused.py``, kernels K-D and K-E)
against the JAX package's (``ops/pallas_train_fused.py``) on the CPU.

The same inputs, made from a seed with numpy, go through both. The JAX
kernels run in Pallas interpret mode, as the JAX package's own tests run
them; the port's wrappers run their plain versions, as they do for every
CPU tensor. Covered: the tile sort and the window cells (identical
integers), the forward and backward kernels' functions, the model's
``forward_sweep_fused`` with its gradients, one ``('fblk', ...)`` train step,
and the engine with ``DVGO_FUSED_TRAIN=force`` on the tiny fixture.
"""

import os
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from directvoxgo_tpu.config import Config as JaxConfig
from directvoxgo_tpu.engine import checkpoint as jax_ckpt
from directvoxgo_tpu.engine import render as jax_render
from directvoxgo_tpu.engine import train as jax_train
from directvoxgo_tpu.models.dvgo import DirectVoxGO as JaxDVGO
from directvoxgo_tpu.ops import pallas_train_fused as ptf
from directvoxgo_tpu.ops import sweep as jax_sweep
from directvoxgo_tpu_torch import convert
from directvoxgo_tpu_torch.config import Config as TorchConfig
from directvoxgo_tpu_torch.data.synthetic import make_synthetic_dataset
from directvoxgo_tpu_torch.engine import train as torch_train
from directvoxgo_tpu_torch.models.dvgo import DirectVoxGO as TorchDVGO
from directvoxgo_tpu_torch.ops import sweep as torch_sweep
from directvoxgo_tpu_torch.ops import train_fused as tf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_CFG = os.path.join(REPO, "configs", "default.py")
BF16 = torch.bfloat16
ACT_SHIFT, THRES, BG = -4.0, 1e-4, 1.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---------------------------------------------------- tiles and window cells

def _pool(seed, n, lo=-0.7, hi=0.7):
    """Clustered rays along +-x through a [-1, 1]^3 box."""
    rng = np.random.default_rng(seed)
    o = np.zeros((n, 3), np.float32)
    d = np.zeros((n, 3), np.float32)
    for j in range(n // 512):
        sl = slice(j * 512, (j + 1) * 512)
        sign = 1.0 if j % 2 == 0 else -1.0
        o[sl, 0], d[sl, 0] = -3.0 * sign, sign
        o[sl, 1:] = rng.normal(rng.uniform(lo, hi, 2), 0.05, (512, 2))
        d[sl, 1:] = rng.normal(0, 0.06, (512, 2))
    return o, d


@pytest.mark.parametrize("clip_box", [None, (6.0, 40.0, 4.0, 43.0, 8.0,
                                             39.0)])
def test_ray_tiles_match_jax(clip_box):
    """``build_ray_tiles_blocktile`` is numpy in both packages: the same
    class keys and the same index arrays, bit for bit."""
    o, d = _pool(0, 8192)
    perm = np.random.default_rng(1).permutation(len(o))
    o, d = o[perm], d[perm]
    kw = dict(xyz_min=np.full(3, -1.0, np.float32),
              xyz_max=np.full(3, 1.0, np.float32), world_size=(48, 48, 48),
              axis=0, near=0.5, far=8.0, stepsize=0.5, clip_box=clip_box)
    ref = jax_sweep.build_ray_tiles_blocktile(o, d, **kw)
    got = torch_sweep.build_ray_tiles_blocktile(o, d, **kw)
    assert list(got) == list(ref)
    assert any(k[0] and k[1] for k in got), list(got)
    assert {k[2] for k in got if k[2]} == {1, -1}
    for key in ref:
        np.testing.assert_array_equal(got[key], ref[key])


def _kernel_inputs(seed, n, direct, desc, gp=24, gu=20, gv=28, width=32,
                   k=2):
    """Grids, voxel-frame rays (one aim point per 512-ray tile, 5% of the
    rays missing the box), ``sh1`` and MLP weights."""
    rng = np.random.default_rng(seed)
    k0_dim = 9 if direct else 12
    fdim = k0_dim if direct else k0_dim - 3
    dens = rng.normal(scale=3.0, size=(gp, gu, gv)).astype(np.float32)
    k0 = rng.normal(size=(gp, gu, gv, k0_dim)).astype(np.float32)
    mask = (rng.uniform(size=(gp, gu, gv)) < 0.8).astype(np.float32)
    rays = np.zeros((16, n), np.float32)
    for j in range(n // 512):
        sl = slice(j * 512, (j + 1) * 512)
        cu, cv = rng.uniform(4, gu - 4), rng.uniform(4, gv - 4)
        dp = (-1.0 if desc else 1.0) * rng.uniform(0.6, 1.4, 512)
        op = (gp + 2.0 + rng.uniform(0, 2, 512)) if desc \
            else (-3.0 - rng.uniform(0, 2, 512))
        du = rng.normal(0, 0.12, 512) * np.abs(dp)
        dv = rng.normal(0, 0.12, 512) * np.abs(dp)
        tm = ((gp - 1) / 2 - op) / dp
        t_a, t_b = (1.3 - op) / dp, (gp - 2.6 - op) / dp
        tlo, thi = np.minimum(t_a, t_b), np.maximum(t_a, t_b)
        thi = np.where(rng.uniform(size=512) < 0.05, tlo - 0.1, thi)
        rays[0, sl], rays[3, sl], rays[4, sl], rays[5, sl] = op, dp, du, dv
        rays[1, sl] = cu + rng.normal(0, 1.5, 512) - tm * du
        rays[2, sl] = cv + rng.normal(0, 1.5, 512) - tm * dv
        rays[6, sl], rays[7, sl] = tlo, thi
        rays[8, sl] = rng.uniform(0.3, 1.0, 512)
        rays[9:12, sl] = rng.uniform(size=(3, 512))
    sh1 = rng.normal(scale=0.5, size=(width, n)).astype(np.float32)

    def lin(i, o):
        return ((rng.uniform(-1, 1, (i, o)) / np.sqrt(i)).astype(np.float32),
                rng.uniform(-0.1, 0.1, o).astype(np.float32))

    layers = [lin(fdim + 27, width), lin(width, width), lin(width, 3)]
    return dict(dens=dens, k0=k0, mask=mask, rays=rays, sh1=sh1,
                layers=layers, fdim=fdim, width=width, k=k, direct=direct,
                desc=desc)


def _jax_forward(d, wu, wv):
    cfg = ptf.FusedCfg(k=d["k"], f=d["fdim"], width=d["width"],
                       act_shift=ACT_SHIFT, thres=THRES, bg=BG,
                       direct=d["direct"], wu=wu, wv=wv, interpret=True)
    rgbnet = {"layers": [{"w": jnp.asarray(w), "b": jnp.asarray(b)}
                         for w, b in d["layers"]]}
    out, res = ptf._fused_chain_fwd(
        cfg, jnp.asarray(d["dens"]), jnp.asarray(d["k0"]),
        jnp.asarray(d["mask"]), jnp.asarray(d["rays"]),
        jnp.asarray(d["sh1"]), rgbnet)
    return cfg, out, res


def _port_operands(d, wu, wv):
    """(cfg, positional arguments of ``train_fwd``) from the same arrays."""
    gp, gu, gv = d["dens"].shape
    cfg = tf.FusedCfg(k=d["k"], f=d["fdim"], width=d["width"],
                      act_shift=ACT_SHIFT, thres=THRES, bg=BG,
                      direct=d["direct"], wu=wu, wv=wv)
    slabs = tf.build_slabs(torch.tensor(d["dens"]), torch.tensor(d["k0"]),
                           torch.tensor(d["mask"]), d["k"])
    rays16 = torch.tensor(d["rays"])
    (w1, _), (w2, b2), (w3, b3) = [(torch.tensor(w), torch.tensor(b))
                                   for w, b in d["layers"]]
    gu_p, gv_p, wu_e, wv_e, windowed = tf._window_plan(cfg, gu, gv)
    uvb = fits = None
    if windowed:
        s_pad, p0, pstep = tf.march_scalars(slabs.shape[0], d["k"],
                                            cfg.s_blk, d["desc"])
        uvb, fits = tf.blocktile_uv_bases(
            rays16, p0, pstep, s_pad // cfg.s_blk, cfg.s_blk, gu_p, gv_p,
            wu_e, wv_e, cfg.nt)
    args = [slabs, rays16, torch.tensor(d["sh1"]),
            w1[:d["fdim"]].to(BF16).contiguous(), w2.to(BF16), b2,
            w3.to(BF16), b3, d["desc"], uvb]
    return cfg, args, fits


CASES = [(direct, desc, win) for direct in (True, False)
         for desc in (False, True) for win in ((0, 0), (16, 16))]


@pytest.mark.parametrize("desc", [False, True])
def test_window_cells_match_jax(desc):
    """``blocktile_uv_bases``: identical cells and fit flags (the bases are
    floors of f32 coordinates computed by the same operations)."""
    d = _kernel_inputs(2, 1024, True, desc)
    _, _, res = _jax_forward(d, 16, 16)
    gp, gu, gv = d["dens"].shape
    rays16 = jnp.asarray(d["rays"])
    s_pad, p0, pstep = tf.march_scalars(2 * (gp - 1) + 1, 2, 8, desc)
    ref_uvb, ref_fits = ptf.blocktile_uv_bases(
        rays16, jnp.float32(p0), jnp.float32(pstep), s_pad // 8, 8, 32, 32,
        16, 16, 512)
    uvb, fits = tf.blocktile_uv_bases(torch.tensor(d["rays"]), p0, pstep,
                                      s_pad // 8, 8, 32, 32, 16, 16, 512)
    np.testing.assert_array_equal(uvb.numpy(), np.asarray(ref_uvb))
    np.testing.assert_array_equal(fits.numpy(), np.asarray(ref_fits))
    np.testing.assert_array_equal(uvb.numpy(), np.asarray(res[8]))
    assert uvb[..., 2].any() and len(np.unique(uvb[..., :2].numpy())) > 1


@pytest.mark.parametrize("direct,desc,win", CASES)
def test_train_fwd_plain_matches_pallas(direct, desc, win):
    """K-D's function against ``train_fwd_pallas``: rgb_marched,
    alphainv_last and rgbper_sum within 1e-5 of each row's largest value
    (the same taps, gates and bf16 rounding points; per-ray sums of a few
    dozen f32 terms in another order)."""
    n = 512 if win == (0, 0) else 1024
    d = _kernel_inputs(3, n, direct, desc)
    _, out, _ = _jax_forward(d, *win)
    cfg, args, _ = _port_operands(d, *win)
    before = tf.plain_calls_fwd
    pack = tf.train_fwd(*args, cfg=cfg).numpy()
    assert tf.plain_calls_fwd == before + 1 and tf.launches_fwd == 0
    ref = np.concatenate([np.asarray(out[0]).T, np.asarray(out[1])[None],
                          np.asarray(out[2])[None]])
    assert pack.shape == (8, n) and not pack[5:].any()
    for row in range(5):
        scale = np.abs(ref[row]).max()
        assert scale > 0.1
        assert np.abs(pack[row] - ref[row]).max() < 1e-5 * scale, row
    # the batch is not trivial: rays that end opaque, rays that miss
    assert (ref[3] < 0.5).mean() > 0.2 and (ref[3] == 1.0).mean() > 0.02


@pytest.mark.parametrize("direct,desc,win", CASES)
def test_train_bwd_plain_matches_pallas(direct, desc, win):
    """K-E's function against ``train_bwd_pallas`` and the glue behind it
    (``_fused_chain_bwd``: un-flip, fold onto the grid slabs, channel
    split). Both round h1, h2, d_logit, d_h2 and d_h1 to bf16 at the same
    points and sum in f32 in another order: the mean error of every output
    stays within 1e-5 of its largest entry, but where the two f32 sums land
    on either side of a bf16 rounding boundary one activation moves by 2^-8
    of itself, which single entries show (3.5e-4 seen, also in the density
    cotangent, which reads rgb): the largest error within 1e-3. The grids'
    zero patterns are identical."""
    n = 512 if win == (0, 0) else 1024
    d = _kernel_inputs(5, n, direct, desc)
    rng = np.random.default_rng(9)
    g_rgb = rng.normal(size=(n, 3)).astype(np.float32)
    g_ainv = rng.normal(size=n).astype(np.float32)
    g_per = rng.uniform(0, 0.1, n).astype(np.float32)
    cfg_j, _, res = _jax_forward(d, *win)
    d_density, d_k0, _, _, d_sh1, d_rgbnet = ptf._fused_chain_bwd(
        cfg_j, res, (jnp.asarray(g_rgb), jnp.asarray(g_ainv),
                     jnp.asarray(g_per)))
    cfg, args, _ = _port_operands(d, *win)
    pack = tf.train_fwd(*args, cfg=cfg)
    g_a = torch.tensor(g_ainv) + cfg.bg * torch.tensor(g_rgb).sum(-1)
    cot = torch.cat([torch.tensor(g_rgb).t(), g_a[None],
                     torch.tensor(g_per)[None], pack[3][None],
                     torch.zeros(2, n)]).contiguous()
    outs = tf.train_bwd(*args[:2], cot, *args[2:], cfg=cfg,
                        gp=d["dens"].shape[0])
    layers = d_rgbnet["layers"]
    refs = [d_density, d_k0, d_sh1, layers[0]["w"][:d["fdim"]],
            layers[1]["w"], layers[1]["b"], layers[2]["w"], layers[2]["b"]]
    names = ["d_density", "d_k0", "d_sh1", "d_w1a", "d_w2", "d_b2", "d_w3",
             "d_b3"]
    for name, ref, got in zip(names, refs, outs):
        ref, got = np.asarray(ref), got.numpy()
        assert ref.shape == got.shape, name
        scale = np.abs(ref).max()
        assert scale > 0, name
        assert np.abs(got - ref).max() < 1e-3 * scale, name
        assert np.abs(got - ref).mean() < 1e-5 * scale, name
        if name in ("d_density", "d_k0"):
            assert np.array_equal(got == 0, ref == 0), name
            assert 0 < (ref != 0).mean() < 0.6, name
    # the view rows of layer 0 and b1 get nothing here (they ride d_sh1)
    assert not np.asarray(layers[0]["w"][d["fdim"]:]).any()


# ------------------------------------------------- model, step and engine

def _model_pair(direct, seed=0):
    """The JAX package's fused-test model (24 x 20 x 28 grid, width 32) and
    the port's with the same parameters and mask."""
    jm = JaxDVGO(xyz_min=(-1.0, -0.8, -1.2), xyz_max=(1.0, 0.9, 1.1),
                 num_voxels=24 * 20 * 28, num_voxels_base=24 * 20 * 28,
                 alpha_init=1e-2, fast_color_thres=1e-4,
                 rgbnet_dim=9 if direct else 12, rgbnet_direct=direct,
                 rgbnet_depth=3, rgbnet_width=32, viewbase_pe=4,
                 k_density=None, k_color=0, sweep_color_topk=0, seed=7)
    rng = np.random.default_rng(seed)
    jm.params["density"] = jnp.asarray(
        rng.normal(scale=3.0, size=jm.world_size).astype(np.float32))
    jm.params["k0"] = jnp.asarray(rng.normal(
        size=(*jm.world_size, jm.k0_dim)).astype(np.float32))
    jm.mask = jnp.asarray(rng.uniform(size=jm.world_size) < 0.8)
    tm = TorchDVGO(**jm.get_kwargs(), device="cpu")
    tm.load_state_dict(convert.params_from_jax(_np_tree(jm.params),
                                               np.asarray(jm.mask)))
    return jm, tm


def _world_rays(jm, n, axis, sign, seed=1):
    rng = np.random.default_rng(seed)
    ctr = (np.asarray(jm.xyz_min) + np.asarray(jm.xyz_max)) / 2
    rad = float(np.linalg.norm(np.asarray(jm.xyz_max) - ctr)) * 2.2
    theta = rng.uniform(0, 2 * np.pi, n)
    phi = rng.uniform(-0.7, 0.7, n)
    ro = ctr + rad * np.stack([np.cos(theta) * np.cos(phi),
                               np.sin(theta) * np.cos(phi),
                               np.sin(phi)], -1)
    rd = ctr + rng.normal(scale=0.35, size=(n, 3)) - ro
    rd[:, axis] = sign * (np.abs(rd).max(1) * 1.5 + 0.1)
    ro[:, axis] = ctr[axis] - sign * rad
    vd = rd / np.linalg.norm(rd, axis=-1, keepdims=True)
    gt = rng.uniform(size=(n, 3))
    return [x.astype(np.float32) for x in (ro, rd, vd, gt)]


W_ENT, W_RGBPER = 1e-3, 1e-2


def _loss(lib, ret, gt, n):
    clip = lib.clip if lib is jnp else lib.clamp
    mse = lib.mean((ret["rgb_marched"] - gt) ** 2)
    pout = clip(ret["alphainv_last"], 1e-6, 1 - 1e-6)
    ent = -lib.mean(pout * lib.log(pout) + (1 - pout) * lib.log(1 - pout))
    return mse + W_ENT * ent + W_RGBPER * lib.sum(ret["rgbper_sum"]) / n


@pytest.mark.parametrize("case", ["direct asc", "logit+k0 desc",
                                  "axis 1", "clipped"])
def test_forward_sweep_fused_matches_jax(case):
    """The model's fused forward and the train loss's gradients against the
    JAX package's ``forward_sweep_fused`` with the same parameters
    (``convert.py``), unclipped and on pre-sliced box grids with offsets.
    Both run the same fused arithmetic, so the bounds are tighter than the
    JAX package's fused-against-XLA bounds (2e-3 values, 5e-3 density
    gradient): values 1e-5 of the largest entry; gradients 1e-3, with a
    mean error within 1e-5 (a bf16 rounding of a hidden activation that
    lands on the other side, see the kernel test)."""
    direct = case != "logit+k0 desc"
    axis = 1 if case == "axis 1" else 0
    sign = -1.0 if case == "logit+k0 desc" else 1.0
    jm, tm = _model_pair(direct)
    n = 512
    ro, rd, vd, gt = _world_rays(jm, n, axis, sign, seed=3)
    rk = dict(near=0.2, far=9.0, bg=1.0, stepsize=0.5)
    sizes, offs = None, None
    box = (slice(None),) * 3
    if case == "clipped":
        sizes, offs = (16, 16, 24), np.asarray([4, 2, 3], np.int32)
        box = tuple(slice(int(o), int(o) + s) for o, s in zip(offs, sizes))

    def jax_loss(tr):
        ret = jm.forward_sweep_fused(
            {**jm.params, **tr}, jm.mask[box], jnp.asarray(ro),
            jnp.asarray(rd), jnp.asarray(vd), axis, jnp.asarray(gt),
            clip_offsets=None if offs is None else jnp.asarray(offs),
            interpret=True, **rk)
        return _loss(jnp, ret, jnp.asarray(gt), n), ret

    tr = {"density": jm.params["density"][box], "k0": jm.params["k0"][box],
          "rgbnet": jm.params["rgbnet"]}
    (loss_j, ret_j), g_j = jax.value_and_grad(jax_loss, has_aux=True)(tr)

    leaves = [tm.density.detach()[box].clone().requires_grad_(),
              tm.k0.detach()[box].clone().requires_grad_()]
    mlp_params = list(tm.rgbnet.parameters())
    ret_t = tm.forward_sweep_fused(
        torch.tensor(ro), torch.tensor(rd), torch.tensor(vd), axis,
        torch.tensor(gt), grids=(*leaves, tm.mask[box]), clip_offsets=offs,
        **rk)
    loss_t = _loss(torch, ret_t, torch.tensor(gt), n)
    grads = torch.autograd.grad(loss_t, leaves + mlp_params)

    for key in ("rgb_marched", "alphainv_last", "rgbper_sum"):
        ref = np.asarray(ret_j[key])
        assert np.abs(ret_t[key].detach().numpy() - ref).max() \
            < 1e-5 * np.abs(ref).max(), key
    assert abs(float(loss_t.detach()) - float(loss_j)) < 1e-5 * float(loss_j)
    pairs = [("density", grads[0].numpy(), np.asarray(g_j["density"])),
             ("k0", grads[1].numpy(), np.asarray(g_j["k0"]))]
    for i, layer in enumerate(g_j["rgbnet"]["layers"]):
        pairs.append((f"w{i}", grads[2 + 2 * i].numpy().T,
                      np.asarray(layer["w"])))
        pairs.append((f"b{i}", grads[3 + 2 * i].numpy(),
                      np.asarray(layer["b"])))
    for name, got, ref in pairs:
        assert got.shape == ref.shape, name
        scale = np.abs(ref).max()
        assert scale > 0, name
        assert np.abs(got - ref).max() < 1e-3 * scale, name
        assert np.abs(got - ref).mean() < 1e-5 * scale, name
    assert np.array_equal(grads[0].numpy() == 0,
                          np.asarray(g_j["density"]) == 0)


def _blob_pair():
    """A 32^3 model with a density blob (so that the occupancy box clips
    the sweep) and random colour features, in both packages."""
    jm = JaxDVGO(xyz_min=[-1, -1, -1], xyz_max=[1, 1, 1],
                 num_voxels=32 ** 3, num_voxels_base=32 ** 3,
                 alpha_init=1e-2, fast_color_thres=1e-4, rgbnet_dim=6,
                 rgbnet_direct=True, rgbnet_width=32, k_density=None,
                 k_color=0, sweep_color_topk=0)
    rng = np.random.default_rng(11)
    pts = np.asarray(jm.grid_points())
    r2 = (((pts - np.array([0.05, -0.1, 0.0])) / 0.5) ** 2).sum(-1)
    jm.params["density"] = jnp.asarray(
        (14 * np.exp(-2 * r2) - 7).astype(np.float32))
    jm.params["k0"] = jnp.asarray(
        rng.normal(0, 0.5, jm.params["k0"].shape).astype(np.float32))
    jm.update_occupancy_cache()
    tm = TorchDVGO(**jm.get_kwargs(), device="cpu")
    tm.load_state_dict(convert.params_from_jax(_np_tree(jm.params),
                                               np.asarray(jm.mask)))
    return jm, tm


def test_fblk_train_step_matches_jax():
    """One ``('fblk', wu, wv, bp, bu, bv)`` step of ``make_train_step`` in
    both packages from the same parameters, mask and (non-trivial) optimizer
    state on the same batch, which the port's tile sort formed: region
    mode over the occupancy box, the fused forward and backward, the
    ``rgbper_sum`` loss and the box-sliced Adam update.

    Loss and PSNR agree to 1e-5 relative. Adam turns a gradient into a step
    of about ``lr * g / (sqrt(v) + eps)``; with second moments near 1e-6
    that magnifies the rounding of small gradients, so parameters agree to
    2% of the largest step taken and 99% of the entries to 1e-5."""
    jm, tm = _blob_pair()
    axis, n_rand = 0, 1024
    o, d = _pool(4, 8192, lo=-0.4, hi=0.4)
    vd = d / np.linalg.norm(d, axis=-1, keepdims=True)
    rgb = np.random.default_rng(5).uniform(0, 1, o.shape).astype(np.float32)
    rk = dict(near=0.5, far=8.0, bg=1.0, stepsize=0.5)

    csz, coff = tm.sweep_clip_for_axis(axis, quantum=8)
    assert csz is not None \
        and csz == jm.sweep_clip_for_axis(axis, quantum=8)[0]
    bp, bu, bv = csz
    box6 = tuple(float(x) for o_, b in zip(coff, csz)
                 for x in (o_, o_ + b - 1))
    tiles = torch_sweep.build_ray_tiles_blocktile(
        o, d, tm.xyz_min, tm.xyz_max, tm.world_size, axis, rk["near"],
        rk["far"], rk["stepsize"], clip_box=box6)
    wins = {k: v for k, v in tiles.items()
            if k[2] and v.shape[0] >= n_rand // 512
            and (k[0] < tf._round_up(bu, 16) or k[1] < tf._round_up(bv, 8))}
    assert wins, {k: v.shape for k, v in tiles.items()}
    key = max(wins, key=lambda k: wins[k].shape[0])
    sel = wins[key][: n_rand // 512].reshape(-1)
    skey = ("fblk", key[0], key[1], bp, bu, bv)

    jcfg, tcfg = JaxConfig.fromfile(DEFAULT_CFG), TorchConfig.fromfile(
        DEFAULT_CFG)
    jcfg.fine_train.N_rand = tcfg.fine_train.N_rand = n_rand
    j_opt = jax_train.create_optimizer_or_freeze_model(jm, jcfg.fine_train)
    t_opt = torch_train.create_optimizer_or_freeze_model(tm, tcfg.fine_train)
    j_state = j_opt.init(jm.params)
    rng = np.random.default_rng(6)
    j_state = dict(j_state, step=jnp.asarray(7, jnp.int32))
    for name, scale in (("exp_avg", 1e-3), ("exp_avg_sq", 1e-6)):
        j_state[name] = jax.tree_util.tree_map(
            lambda x: jnp.asarray(np.abs(rng.normal(
                0, scale, x.shape)).astype(np.float32)), j_state[name])
    convert.opt_state_from_jax(_np_tree(j_state), t_opt)

    j_step = jax_train.make_train_step(jm, j_opt, jcfg.fine_train, rk, False,
                                       False, axis=axis, clip_sizes=skey)
    t_step = torch_train.make_train_step(tm, t_opt, tcfg.fine_train, rk,
                                         False, False, axis=axis,
                                         clip_sizes=skey)
    j_pool = {"rgb": jnp.asarray(rgb), "rays_o": jnp.asarray(o),
              "rays_d": jnp.asarray(d), "viewdirs": jnp.asarray(vd)}
    t_pool = {k: torch.tensor(np.asarray(v)) for k, v in j_pool.items()}
    p0 = {n: np.asarray(jm.params[n]).copy() for n in ("density", "k0")}
    before = (tf.plain_calls_fwd, tf.plain_calls_bwd)
    params, j_state, loss_j, psnr_j = j_step(
        jm.params, jm.mask, j_state, j_pool, jnp.asarray(sel, jnp.int32),
        jnp.asarray(coff))
    loss_t, psnr_t = t_step(t_pool, torch.tensor(sel), coff)
    assert (tf.plain_calls_fwd, tf.plain_calls_bwd) == (before[0] + 1,
                                                        before[1] + 1)
    assert abs(float(loss_t) - float(loss_j)) < 1e-5 * float(loss_j)
    assert abs(float(psnr_t) - float(psnr_j)) < 1e-4
    t_params, _ = convert.params_to_jax(tm)
    for name in ("density", "k0"):
        ref = np.asarray(params[name])
        moved = np.abs(ref - p0[name]).max()
        assert moved > 1e-3, name
        err = np.abs(t_params[name] - ref)
        assert err.max() < 2e-2 * moved, name
        assert np.mean(err < 1e-5) > 0.99, name
        # the update stays inside the occupancy box
        outside = np.ones(tm.world_size, bool)
        outside[tuple(slice(int(o_), int(o_) + s)
                      for o_, s in zip(coff, csz))] = False
        assert np.array_equal(t_params[name][outside], p0[name][outside])
    for a, b in zip(jax.tree_util.tree_leaves(t_params["rgbnet"]),
                    jax.tree_util.tree_leaves(params["rgbnet"])):
        assert np.abs(a - np.asarray(b)).max() < 2e-2 * 3 * 1e-3


def test_fblk_key_rejected_outside_region_mode():
    """A fused key assumes box slices of the grids: with dense TV on (full
    size gradients) building the step fails instead of slicing wrongly."""
    _, tm = _blob_pair()
    tcfg = TorchConfig.fromfile(DEFAULT_CFG)
    tcfg.fine_train.weight_tv_density = 0.1
    opt = torch_train.create_optimizer_or_freeze_model(tm, tcfg.fine_train)
    with pytest.raises(AssertionError):
        torch_train.make_train_step(
            tm, opt, tcfg.fine_train,
            dict(near=0.5, far=8.0, bg=1.0, stepsize=0.5), True, True,
            axis=0, clip_sizes=("fblk", 32, 16, 32, 32, 32))


@pytest.mark.parametrize("env,device,want", [
    (None, "cpu", False), ("0", "cuda", False), ("1", "cpu", False),
    ("1", "cuda", True), ("force", "cpu", True), ("force", "cuda", True)])
def test_fused_switch(monkeypatch, env, device, want):
    """``DVGO_FUSED_TRAIN``: off by default, ``1`` for CUDA devices only,
    ``force`` also on the CPU."""
    if env is None:
        monkeypatch.delenv("DVGO_FUSED_TRAIN", raising=False)
    else:
        monkeypatch.setenv("DVGO_FUSED_TRAIN", env)
    assert tf.fused_enabled(device) is want
    assert tf.fused_available(1024, 40, 40, 12, 128, 1e-4, 3,
                              device=device) is want


@pytest.mark.parametrize("kw,want", [
    ({}, True), ({"depth": 2}, False), ({"fdim": 15}, False),
    ({"fdim": 0}, False), ({"thres": 0.0}, False), ({"n": 1000}, False),
    ({"wu": 32, "wv": 16}, True), ({"wu": 24, "wv": 16}, False),
    ({"wu": 32, "wv": 12}, False), ({"wu": 64, "wv": 16}, False),
    ({"wu": 48, "wv": 40}, True)])
def test_fused_shape_gates(monkeypatch, kw, want):
    """The shape gates of the fused step: a three-layer MLP, 1 to 14 feature
    channels, a positive threshold, whole ray tiles, windows aligned to
    16 x 8 that fit the padded plane (40 x 36 -> 48 x 40)."""
    monkeypatch.setenv("DVGO_FUSED_TRAIN", "force")
    args = dict(n=1024, gu=40, gv=36, fdim=12, width=128, thres=1e-4,
                depth=3)
    args.update(kw)
    assert tf.fused_available(**args) is want


def test_wrappers_refuse_mismatched_shapes():
    d = _kernel_inputs(3, 512, True, False)
    cfg, args, _ = _port_operands(d, 0, 0)
    with pytest.raises(ValueError):
        tf.train_fwd(args[0], args[1][:, :500].contiguous(), *args[2:],
                     cfg=cfg)
    with pytest.raises(TypeError):
        tf.train_fwd(args[0].float(), *args[1:], cfg=cfg)
    with pytest.raises(ValueError):    # a windowed step needs its cells
        tf.train_fwd(*args, cfg=cfg._replace(wu=16, wv=16))
    cot = torch.zeros((8, 512))
    with pytest.raises(ValueError):    # stations do not match gp
        tf.train_bwd(*args[:2], cot, *args[2:], cfg=cfg, gp=20)


# ----------------------------------------------------------- the engine

def _args(**kw):
    base = dict(seed=777, no_reload=False, no_reload_optimizer=False,
                ft_path="", i_print=50, i_weights=1000)
    base.update(kw)
    return types.SimpleNamespace(**base)


def test_engine_trains_fused_on_the_tiny_fixture(tmp_path, monkeypatch,
                                                 capsys):
    """``train()`` with ``DVGO_FUSED_TRAIN=force`` on the CPU: the coarse
    stage (no colour MLP) trains unfused, the fine stage (one step a
    dispatch) draws same-class tiles and takes fused steps (the wrappers' plain versions count them),
    rebuilds its tiles at the progressive rescale, and writes a checkpoint
    that the JAX package loads and renders above 25 dB. Without the switch
    the same engine takes no fused step."""
    data = make_synthetic_dataset()        # 16 train views of 64 x 64
    cfg = TorchConfig.fromfile(DEFAULT_CFG)
    cfg.expname, cfg.basedir = "tiny_fused", str(tmp_path)
    cfg.data.dataset_type, cfg.data.white_bkgd = "synthetic_fixture", True
    cfg.coarse_train.N_iters, cfg.coarse_train.N_rand = 150, 512
    cfg.coarse_train.lrate_density = 0.3
    cfg.fine_train.N_iters, cfg.fine_train.N_rand = 120, 512
    cfg.fine_train.pg_scale = [60]
    # the JAX engine fuses only where it takes one step a dispatch: at its
    # default width of 8 on a grid this small every batch is uniform
    cfg.fine_train.steps_per_dispatch = 1
    cfg.coarse_model_and_render.num_voxels = 24 ** 3
    cfg.coarse_model_and_render.num_voxels_base = 24 ** 3
    cfg.fine_model_and_render.num_voxels = 32 ** 3
    cfg.fine_model_and_render.num_voxels_base = 32 ** 3
    cfg.fine_model_and_render.rgbnet_dim = 6
    cfg.fine_model_and_render.rgbnet_width = 32

    keys = []
    orig = torch_train.make_train_step

    def recording(model, *a, **kw):
        step = orig(model, *a, **kw)

        def counted(*sa, **skw):
            keys.append((model.rgbnet is not None, kw.get("clip_sizes")))
            return step(*sa, **skw)
        return counted

    monkeypatch.setattr(torch_train, "make_train_step", recording)
    monkeypatch.setenv("DVGO_FUSED_TRAIN", "force")
    before = (tf.plain_calls_fwd, tf.plain_calls_bwd)
    model = torch_train.train(_args(), cfg, data, device="cpu")
    fused = [k for fine, k in keys if k is not None and k[0] == "fblk"]
    assert len(keys) == 270
    assert not any(k is not None and k[0] == "fblk"
                   for fine, k in keys if not fine)
    assert len(fused) >= 60                       # of 120 fine steps
    assert (tf.plain_calls_fwd - before[0], tf.plain_calls_bwd - before[1]) \
        == (len(fused), len(fused))
    assert len({k[3:] for k in fused}) >= 2       # both grid sizes
    out = capsys.readouterr().out
    assert out.count("fused tiles axis") >= 2
    assert all(np.isfinite(p.detach().numpy()).all()
               for p in model.parameters())

    path = os.path.join(cfg.basedir, cfg.expname, "fine_last.tar")
    jm = jax_ckpt.load_model(JaxDVGO, path)
    i_test = data["i_test"]
    rk = {"near": data["near"], "far": data["far"], "bg": 1, "stepsize": 0.5,
          "inverse_y": False, "render_depth": True}
    _, _, stats = jax_render.render_viewpoints(
        model=jm, render_poses=data["poses"][i_test], HW=data["HW"][i_test],
        Ks=data["Ks"][i_test], ndc=False, render_kwargs=rk,
        gt_imgs=[data["images"][i] for i in i_test], chunk=2048,
        verbose=False)
    assert float(np.mean(stats["psnr"])) > 25.0

    # the switch off: the same stage takes only unfused steps
    monkeypatch.delenv("DVGO_FUSED_TRAIN")
    keys.clear()
    cfg.expname = "tiny_unfused"
    cfg.coarse_train.N_iters, cfg.fine_train.N_iters = 30, 10
    cfg.fine_train.pg_scale = []
    calls = (tf.plain_calls_fwd, tf.plain_calls_bwd)
    torch_train.train(_args(), cfg, data, device="cpu")
    assert len(keys) == 40
    assert not any(k is not None and k[0] == "fblk" for _, k in keys)
    assert (tf.plain_calls_fwd, tf.plain_calls_bwd) == calls
