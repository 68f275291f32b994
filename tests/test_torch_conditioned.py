"""The port's conditioned and multi-scene models against the JAX package on
the CPU: every function of ``nets.py`` and ``backbone.py`` (forward, and
gradients with respect to inputs and parameters), the plane samplers, and
each model's forward with its gradient with respect to every parameter
group, from weights carried across by ``convert``.

Inputs are made with numpy from a seed and handed to both packages (maps
NHWC to JAX, NCHW to the port); the JAX functions run on the CPU as the
JAX package's own tests run them. Tolerances: 1e-5 relative to the
largest magnitude (1e-4 for the 16-block EDSR), index lookups bit for bit.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from directvoxgo_tpu.models import backbone as jax_bb
from directvoxgo_tpu.models import nets as jax_nets
from directvoxgo_tpu.models import tri_dvgo as jax_tri
from directvoxgo_tpu.models.dvgo import _pg_rescale_jit
from directvoxgo_tpu.models.dvgo_multiscene import (
    DirectVoxGOMultiScene as JaxDVGOMS)
from directvoxgo_tpu.models.multiscene_dvgo import (
    MultiSceneImplicitDVGO as JaxImplicit)
from directvoxgo_tpu.models.sr_dvgo import SRDVGO as JaxSR
from directvoxgo_tpu.models.tri_dvgo_multiscene import (
    TriDVGOMultiScene as JaxTriMS, affine_warp as jax_affine_warp)
from directvoxgo_tpu.ops import grid as jax_grid
from directvoxgo_tpu_torch import convert
from directvoxgo_tpu_torch.models import backbone as bb
from directvoxgo_tpu_torch.models import nets
from directvoxgo_tpu_torch.models import tri_dvgo as torch_tri
from directvoxgo_tpu_torch.models.dvgo_multiscene import DirectVoxGOMultiScene
from directvoxgo_tpu_torch.models.multiscene_dvgo import (
    MultiSceneImplicitDVGO)
from directvoxgo_tpu_torch.models.sr_dvgo import SRDVGO
from directvoxgo_tpu_torch.models.tri_dvgo_multiscene import (
    TriDVGOMultiScene, affine_warp)
from directvoxgo_tpu_torch.ops import grid as torch_grid

TOL = 1e-5
RK = dict(near=0.5, far=8.0, bg=1.0, stepsize=0.5)
BASE = dict(xyz_min=[-1, -1, -1], xyz_max=[1, 1, 1], num_voxels=16 ** 3,
            num_voxels_base=16 ** 3, alpha_init=1e-2, fast_color_thres=1e-4)
SMALL = dict(rgbnet_dim=4, rgbnet_width=16, n_feats=8, n_resblocks=2,
             map_width=16, k_density=32, k_color=16)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, tol=TOL, what="", scale=None):
    """Largest difference within ``tol`` of ``scale`` (default: the largest
    magnitude of ``want``)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if scale is None:
        scale = float(np.abs(want).max()) if want.size else 0.0
    err = float(np.abs(got - want).max()) / max(scale, 1e-6) \
        if want.size else 0.0
    assert err <= tol, f"{what}: relative error {err} > {tol}"


def _close_tree(got, want, tol=TOL, what=""):
    """Array leaves of two JAX-layout pytrees (non-array leaves skipped),
    against the largest magnitude of the whole tree."""
    g = [x for x in jax.tree_util.tree_leaves(got)
         if isinstance(x, np.ndarray) and x.ndim > 0]
    w = [np.asarray(x) for x in jax.tree_util.tree_leaves(want)
         if hasattr(x, "ndim") and x.ndim > 0]
    assert len(g) == len(w), (what, len(g), len(w))
    scale = max(float(np.abs(x).max()) for x in w)
    for i, (a, b) in enumerate(zip(g, w)):
        _close(a, b, tol, f"{what}[{i}]", scale)


def _nchw(x):
    return torch.tensor(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def _module_from(module, tree):
    """Load a JAX pytree into a port module."""
    with torch.no_grad():
        for p, a in zip(module.parameters(),
                        convert.module_from_jax(module, _np_tree(tree))):
            p.copy_(torch.tensor(a))
    return module


def _float_leaves_grad(fn, tree, has_aux=False):
    """``jax.grad`` (jitted) over the float leaves of ``tree`` (its int and
    str leaves - ``skips``, ``mode``, ``inter`` - held fixed); with
    ``has_aux``, ``fn`` returns (loss, aux) and the result is (aux,
    gradient tree)."""
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    is_f = [hasattr(x, "dtype") and jnp.issubdtype(x.dtype, jnp.floating)
            or isinstance(x, float) for x in leaves]
    fl = [jnp.asarray(x) for x, f in zip(leaves, is_f) if f]

    def g(fl):
        it = iter(fl)
        return fn(jax.tree_util.tree_unflatten(
            treedef, [next(it) if f else x for x, f in zip(leaves, is_f)]))

    if has_aux:
        grads, aux = jax.jit(jax.grad(g, has_aux=True))(fl)
    else:
        grads = jax.jit(jax.grad(g))(fl)
    it = iter(grads)
    tree = jax.tree_util.tree_unflatten(
        treedef, [np.asarray(next(it)) if f else x
                  for x, f in zip(leaves, is_f)])
    return (aux, tree) if has_aux else tree


# ----------------------------------------------------- nets and backbone

def _net_case(name, rng):
    """(jax params, jax apply(params, *inputs), port module class ctor,
    port apply(module, *inputs), inputs as numpy (maps NHWC), map flags)."""
    key = jax.random.PRNGKey(3)
    if name == "nerf_mlp":
        p = jax_nets.init_nerf_mlp(key, D=4, W=32, input_ch=12,
                                   input_ch_views=6, skips=(1,))
        return (p, lambda p, a, b: jax_nets.nerf_mlp_apply(p, a, b),
                lambda: nets.NerfMLP(4, 32, 12, 6, (1,)),
                lambda m, a, b: nets.nerf_mlp_apply(m, a, b),
                [rng.normal(size=(5, 12)), rng.normal(size=(5, 6))],
                [False, False])
    if name == "mapping":
        p = jax_nets.init_mapping(key, 8 + 16, 4, depth=3, width=16)
        return (p, jax_nets.mapping_apply,
                lambda: nets.Mapping(24, 4, 3, 16),
                nets.mapping_apply,
                [rng.normal(size=(2, 6, 5, 8)), rng.normal(size=(2, 4, 4))],
                [True, False])
    if name == "interp":
        p = jax_nets.init_interp_mlp(key, 8, 4, width=16, depth=4)
        return (p, jax_nets.interp_mlp_apply,
                lambda: nets.InterpMLP(8, 4, 16, 4), nets.interp_mlp_apply,
                [rng.normal(size=(3, 7, 8))], [False])
    if name in ("conv_mapping_pose", "conv_mapping_map"):
        cond = (rng.normal(size=(1, 4, 4)) if name.endswith("pose")
                else rng.normal(size=(1, 8, 6, 16)))
        p = jax_nets.init_conv_mapping(key, 8 + 16, 4, n_resblocks=2)
        return (p, jax_nets.conv_mapping_apply,
                lambda: nets.ConvMapping(24, 4, 3, 2),
                nets.conv_mapping_apply,
                [rng.normal(size=(1, 8, 6, 8)), cond],
                [True, name.endswith("map")])
    if name == "siren":
        p = jax_nets.init_siren_rgb_net(key, 3, 8, 16)
        return (p, jax_nets.siren_rgb_net_apply,
                lambda: nets.SirenRgbNet(3, 8, 16),
                nets.siren_rgb_net_apply,
                [0.1 * rng.normal(size=(4, 8))], [False])
    if name.startswith("nl_"):
        p = jax_nets.init_nl_block(key, 8, 1, mode=name[3:])
        # a nonzero output conv, so that the attention path shows
        p["wz"] = {"w": jnp.asarray(rng.normal(size=(1, 1, 4, 8)),
                                    jnp.float32),
                   "b": jnp.asarray(rng.normal(size=(8,)), jnp.float32)}
        return (p, jax_nets.nl_block_apply,
                lambda: nets.NLBlock(8, 1, mode=name[3:]),
                nets.nl_block_apply,
                [rng.normal(size=(1, 6, 8, 8)), rng.normal(size=(1, 6, 8, 1))],
                [True, True])
    if name == "attention":
        p = jax_nets.init_scaled_product_attention(key, 16, num_heads=2)
        return (p, jax_nets.scaled_product_attention_apply,
                lambda: nets.ScaledProductAttention(16, 2),
                nets.scaled_product_attention_apply,
                [rng.normal(size=(2, 5, 16)), rng.normal(size=(3, 5, 16))],
                [False, False])
    if name == "split_rgbnet":
        p = jax_nets.init_split_rgbnet(key, 12, vox_dim=8, width=32)
        return (p, jax_nets.split_rgbnet_apply,
                lambda: nets.SplitRgbnet(12, 8, 32),
                nets.split_rgbnet_apply,
                [rng.normal(size=(4, 12)), rng.normal(size=(4, 8))],
                [False, False])
    if name.startswith("edsr"):
        blocks = 16 if name == "edsr16" else 2
        up = name == "edsr_up"
        p, apply_fn, _ = jax_bb.make_edsr_baseline(
            key, n_resblocks=blocks, n_feats=8, n_colors=3 if up else 9,
            no_upsampling=not up, scale=2)
        return (p, apply_fn,
                lambda: bb.EDSR(blocks, 8, 3 if up else 9, 2,
                                no_upsampling=not up),
                bb.edsr_apply,
                [rng.uniform(-1, 1, (2, 10, 12, 3 if up else 9))], [True])
    if name == "resnet":
        p = jax_bb.init_resnet_extractor(key, width=8, n_blocks=2)
        for bn in [p["stem_bn"]] + [b[k] for b in p["blocks"]
                                    for k in ("bn1", "bn2")]:
            for k in bn:
                bn[k] = jnp.asarray(rng.uniform(0.5, 1.5, bn[k].shape),
                                    jnp.float32)
        return (p, jax_bb.resnet_extractor_apply,
                lambda: bb.ResNetExtractor(8, 2), bb.resnet_extractor_apply,
                [rng.uniform(-1, 1, (1, 17, 14, 3))], [True])
    raise KeyError(name)


NETS = ["nerf_mlp", "mapping", "interp", "conv_mapping_pose",
        "conv_mapping_map", "siren", "nl_embedded", "nl_dot", "attention",
        "split_rgbnet", "edsr", "edsr16", "edsr_up", "resnet"]


@pytest.mark.parametrize("name", NETS)
def test_net_forward_and_gradients_match_jax(name):
    rng = np.random.default_rng(NETS.index(name))
    jp, japply, ctor, tapply, inputs, is_map = _net_case(name, rng)
    inputs = [np.asarray(x, np.float32) for x in inputs]
    tol = 1e-4 if name == "edsr16" else TOL
    module = _module_from(ctor(), jp)

    j_out = japply(jp, *map(jnp.asarray, inputs))
    j_outs = j_out if isinstance(j_out, tuple) else (j_out,)
    t_in = [(_nchw(x) if m else torch.tensor(x)).requires_grad_()
            for x, m in zip(inputs, is_map)]
    t_out = tapply(module, *t_in)
    t_outs = t_out if isinstance(t_out, tuple) else (t_out,)
    out_is_map = is_map[0]
    cots = [rng.normal(size=np.shape(o)).astype(np.float32) for o in j_outs]
    for i, (a, b) in enumerate(zip(t_outs, j_outs)):
        a = a.detach().numpy()
        if out_is_map:
            a = np.moveaxis(a, 1, -1)
        _close(a, b, tol, f"{name} output {i}")

    def j_loss(params, *xs):
        outs = japply(params, *xs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        return sum(jnp.sum(o * c) for o, c in zip(outs, cots))

    j_gp = _float_leaves_grad(lambda p: j_loss(p, *map(jnp.asarray, inputs)),
                              jp)
    j_gx = jax.grad(lambda xs: j_loss(jp, *xs))(
        [jnp.asarray(x) for x in inputs])
    t_loss = sum(torch.sum(o * (_nchw(c) if out_is_map else torch.tensor(c)))
                 for o, c in zip(t_outs, cots))
    params = list(module.parameters())
    grads = torch.autograd.grad(t_loss, params + t_in)
    _close_tree(convert.module_to_jax(module, grads[:len(params)]), j_gp,
                tol, f"{name} parameter gradients")
    for x, g, jg, m in zip(inputs, grads[len(params):], j_gx, is_map):
        g = np.moveaxis(g.numpy(), 1, -1) if m else g.numpy()
        _close(g, jg, tol, f"{name} input gradient")


def test_pixel_shuffle_and_pools_match_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, 7, 12)).astype(np.float32)
    np.testing.assert_array_equal(
        np.moveaxis(bb.pixel_shuffle(_nchw(x), 2).numpy(), 1, -1),
        np.asarray(jax_bb.pixel_shuffle(jnp.asarray(x), 2)))
    np.testing.assert_array_equal(
        np.moveaxis(bb.max_pool2d(_nchw(x), 2).numpy(), 1, -1),
        np.asarray(jax_bb.max_pool2d(jnp.asarray(x), 2)))
    assert bb.same_pads(16, 7, 2) == (2, 3) and bb.same_pads(9, 3, 1) == (1, 1)


def test_liif_and_edsr_weight_imports(tmp_path):
    rng = np.random.default_rng(2)
    sd = {}
    dims = [(8, 16), (16, 16), (16, 16), (16, 16)]
    for i, (a, b) in zip((0, 2, 4, 6), dims):
        sd[f"imnet.layers.{i}.weight"] = torch.tensor(
            rng.normal(size=(b, a)).astype(np.float32))
        sd[f"imnet.layers.{i}.bias"] = torch.tensor(
            rng.normal(size=(b,)).astype(np.float32))
    path = str(tmp_path / "liif.pth")
    torch.save({"model": {"sd": sd}}, path)
    j_layers = jax_nets.load_liif_state_dict(path)
    t_layers = nets.load_liif_state_dict(path)
    for j, t in zip(j_layers, t_layers):
        np.testing.assert_array_equal(t["weight"].numpy().T,
                                      np.asarray(j["w"]))
    jp = jax_nets.apply_liif_sd_to_interp(
        jax_nets.init_interp_mlp(jax.random.PRNGKey(0), 8, 4, 16, 5),
        j_layers)
    tm = nets.apply_liif_sd_to_interp(nets.InterpMLP(8, 4, 16, 5), t_layers)
    tree = convert.module_to_jax(tm)
    for i in range(4):
        np.testing.assert_array_equal(tree["layers"][i]["w"],
                                      np.asarray(jp["layers"][i]["w"]))
    with pytest.raises(ValueError, match="does not match"):
        nets.apply_liif_sd_to_interp(nets.InterpMLP(6, 4, 16, 5), t_layers)

    # upstream EDSR state dict: head.0, body.{i}.body.{0,2}, body.{n}
    m = bb.EDSR(2, 8, 9)
    esd = {}
    for name, c in [("head.0", m.head), ("body.0.body.0", m.body[0].c1),
                    ("body.0.body.2", m.body[0].c2),
                    ("body.1.body.0", m.body[1].c1),
                    ("body.1.body.2", m.body[1].c2), ("body.2", m.body_tail)]:
        esd[name + ".weight"] = torch.tensor(rng.normal(
            size=tuple(c.weight.shape)).astype(np.float32))
        esd[name + ".bias"] = torch.tensor(rng.normal(
            size=tuple(c.bias.shape)).astype(np.float32))
    j = jax_bb.load_torch_edsr_weights(
        jax_bb.init_edsr(jax.random.PRNGKey(0), 2, 8, 9),
        {k: v.numpy() for k, v in esd.items()})
    bb.load_torch_edsr_weights(m, esd)
    _close_tree(convert.module_to_jax(m), _np_tree(j), 0.0, "edsr import")


def test_plane_samplers_match_jax():
    """Nearest taps bit for bit (half-way coordinates round to even), and
    the affine warp within 1e-5 of its scale (the identity warp within
    1e-6 of the map it reproduces)."""
    rng = np.random.default_rng(4)
    plane = rng.normal(size=(7, 9, 3)).astype(np.float32)
    iu = np.concatenate([rng.uniform(-2, 9, 200),
                         np.arange(-1, 8, 0.5)]).astype(np.float32)
    iv = np.concatenate([rng.uniform(-2, 11, 200),
                         np.arange(-1, 8, 0.5)]).astype(np.float32)
    want = np.asarray(jax_grid.nearest_sample_2d_parts(
        jnp.asarray(plane), jnp.asarray(iu), jnp.asarray(iv)))
    got = torch_grid.nearest_sample_2d_parts(
        torch.tensor(plane), torch.tensor(iu), torch.tensor(iv)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        torch_grid.nearest_sample_2d_parts(
            torch.tensor(plane[..., 0]), torch.tensor(iu),
            torch.tensor(iv)).numpy(),
        want[..., 0])
    feat = rng.normal(size=(12, 10, 4)).astype(np.float32)
    for theta in ([[1.0, 0, 0], [0, 1.0, 0]],
                  rng.normal(0, 0.6, (2, 3)).tolist()):
        theta = np.asarray(theta, np.float32)
        _close(affine_warp(torch.tensor(feat), torch.tensor(theta)).numpy(),
               jax_affine_warp(jnp.asarray(feat), jnp.asarray(theta)), TOL,
               "affine_warp")
    _close(affine_warp(torch.tensor(feat),
                       torch.tensor([[1.0, 0, 0], [0, 1.0, 0]])).numpy(),
           feat, 1e-6, "identity warp")


# -------------------------------------------------------------- the models

def _rays(n, seed=0):
    o = np.tile([[0.0, 0.0, 3.0]], (n, 1)).astype(np.float32)
    d = np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)
    d[:, :2] *= 0.3
    d[:, 2] = -np.abs(d[:, 2]) - 1
    vd = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d, vd.astype(np.float32)


def _cond(n_views, channels, seed, hw=(16, 16)):
    rng = np.random.default_rng(seed)
    rgb = rng.uniform(-1, 1, (n_views, *hw, channels)).astype(np.float32)
    pose = (jax_tri.anchor_poses()[:n_views]
            + rng.normal(scale=0.05, size=(n_views, 4, 4))).astype(np.float32)
    return rgb, pose


def _density_blob(shape, seed):
    rng = np.random.default_rng(seed)
    grid = np.stack(np.meshgrid(*[np.linspace(-1, 1, n) for n in shape[-3:]],
                                indexing="ij"), -1)
    d = 8.0 * np.exp(-np.sum(grid ** 2, -1) / 0.3) - 4.0
    return (np.broadcast_to(d, shape) + rng.normal(0, 0.5, shape)).astype(
        np.float32)


def _pair(jcls, tcls, seed, **kw):
    """A JAX model with a density blob, and the port's model from its
    kwargs carrying the same parameters and mask."""
    jm = jcls(**kw)
    if "density" in jm.params:
        jm.params["density"] = jnp.asarray(_density_blob(
            jm.params["density"].shape, seed))
        if jm.mask.ndim == 3:
            jm.update_occupancy_cache()
    if "k0" in jm.params:
        jm.params["k0"] = jnp.asarray(np.random.default_rng(seed).normal(
            0, 0.5, jm.params["k0"].shape).astype(np.float32))
    tm = tcls(**jm.get_kwargs(), device="cpu")
    tm.load_state_dict(convert.params_from_jax(
        _np_tree(jm.params), np.asarray(jm.mask), model=tm))
    return jm, tm


def _torch_grads(tm, loss):
    groups = tm.jax_groups() if hasattr(tm, "jax_groups") else {
        "density": tm.density, "k0": tm.k0,
        **({"rgbnet": tm.rgbnet} if tm.rgbnet is not None else {})}
    flat, index = [], {}
    for name, obj in groups.items():
        ps = [obj] if isinstance(obj, torch.Tensor) else list(
            obj.parameters())
        index[name] = (obj, len(flat), len(ps))
        flat += ps
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(flat, grads)]
    out = {}
    for name, (obj, i, n) in index.items():
        out[name] = (grads[i].numpy() if isinstance(obj, torch.Tensor)
                     else convert.module_to_jax(obj, grads[i:i + n]))
    return out


def _check_ret(t_ret, j_ret, what):
    for k in ("rgb_marched", "alphainv_last", "weights", "raw_rgb",
              "depth"):
        if k in j_ret:
            _close(t_ret[k].detach().numpy(), j_ret[k], TOL, f"{what} {k}")
    np.testing.assert_array_equal(t_ret["wmask"].numpy(),
                                  np.asarray(j_ret["wmask"]))


def _loss_terms(ret, aux, cot):
    return (jnp if isinstance(ret["rgb_marched"], jax.Array) else torch).sum(
        ret["rgb_marched"] * cot) + sum(aux)


TRI_MODES = {
    "concat": {},
    "sum": dict(tri_aggregation="sum"),
    "liif": dict(liif=True, interp_width=16, interp_depth=3),
    "liif_unfold": dict(liif=True, feat_unfold=True, interp_width=16,
                        interp_depth=3, cell_decode=False),
    "not_direct": dict(rgbnet_direct=False),
}


@pytest.mark.parametrize("mode", list(TRI_MODES))
def test_tri_dvgo_forward_and_gradients_match_jax(mode):
    jm, tm = _pair(jax_tri.TriDVGO, torch_tri.TriDVGO, 1,
                   **BASE, **SMALL, **TRI_MODES[mode])
    rgb, pose = _cond(3, 9, 2)
    o, d, vd = _rays(12)
    cot = np.random.default_rng(5).normal(size=(12, 3)).astype(np.float32)

    def j_loss(params):
        ret = jm.forward(params, jm.mask, jnp.asarray(rgb), jnp.asarray(pose),
                         jnp.asarray(o), jnp.asarray(d), jnp.asarray(vd),
                         render_depth=True, **RK)
        return _loss_terms(ret, [], cot), ret

    (_, j_ret), j_g = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(
        jm.params)
    t_ret = tm(_nchw(rgb), torch.tensor(pose), torch.tensor(o),
               torch.tensor(d), torch.tensor(vd), render_depth=True, **RK)
    _check_ret(t_ret, j_ret, mode)
    t_g = _torch_grads(tm, _loss_terms(t_ret, [], torch.tensor(cot)))
    assert set(t_g) == set(j_g)
    for name in j_g:
        _close_tree(t_g[name], _np_tree(j_g[name]), TOL, f"{mode} d{name}")


@pytest.mark.parametrize("direct", [True, False])
def test_sr_dvgo_forward_and_gradients_match_jax(direct):
    jm, tm = _pair(JaxSR, SRDVGO, 2, **BASE, rgbnet_dim=6, rgbnet_width=16,
                   n_feats=8, n_resblocks=2, k_density=32, k_color=16,
                   rgbnet_direct=direct)
    rgb, _ = _cond(1, 3, 3, hw=(12, 10))
    o, d, vd = _rays(10, 1)
    cot = np.random.default_rng(6).normal(size=(10, 3)).astype(np.float32)

    def j_loss(params):
        ret = jm.forward(params, jm.mask, jnp.asarray(rgb), jnp.asarray(o),
                         jnp.asarray(d), jnp.asarray(vd), render_depth=True,
                         **RK)
        return _loss_terms(ret, [], cot), ret

    (_, j_ret), j_g = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(
        jm.params)
    t_ret = tm(_nchw(rgb), torch.tensor(o), torch.tensor(d),
               torch.tensor(vd), render_depth=True, **RK)
    _check_ret(t_ret, j_ret, "sr")
    t_g = _torch_grads(tm, _loss_terms(t_ret, [], torch.tensor(cot)))
    for name in j_g:
        _close_tree(t_g[name], _np_tree(j_g[name]), TOL, f"sr d{name}")


def test_implicit_model_forward_and_gradients_match_jax():
    """The NeRF-MLP head with mip-NeRF density; the JAX gradient over the
    float leaves (its ``skips`` ints held fixed: ``jax.grad`` refuses
    integer leaves, the JAX package's known fault)."""
    jm, tm = _pair(JaxImplicit, MultiSceneImplicitDVGO, 3, **BASE,
                   rgbnet_dim=4, rgbnet_depth=4, rgbnet_width=32, n_feats=8,
                   n_resblocks=2, map_width=16, k_density=32)
    assert tm.density is None and tm.act_shift == -1.0
    rgb, pose = _cond(3, 9, 4)
    o, d, vd = _rays(8, 2)
    cot = np.random.default_rng(7).normal(size=(8, 3)).astype(np.float32)

    def j_fwd(params):
        return jm.forward(params, jm.mask, jnp.asarray(rgb),
                          jnp.asarray(pose), jnp.asarray(o), jnp.asarray(d),
                          jnp.asarray(vd), render_depth=True, **RK)

    def j_loss(params):
        ret = j_fwd(params)
        return _loss_terms(ret, [], cot), ret

    j_ret, j_g = _float_leaves_grad(j_loss, jm.params, has_aux=True)
    t_ret = tm(_nchw(rgb), torch.tensor(pose), torch.tensor(o),
               torch.tensor(d), torch.tensor(vd), render_depth=True, **RK)
    _check_ret(t_ret, j_ret, "implicit")
    t_g = _torch_grads(tm, _loss_terms(t_ret, [], torch.tensor(cot)))
    assert set(t_g) == set(j_g)
    for name in j_g:
        _close_tree(t_g[name], j_g[name], TOL, f"implicit d{name}")


@pytest.mark.parametrize("fine", [False, True])
def test_dvgo_multiscene_forward_and_gradients_match_jax(fine):
    kw = dict(rgbnet_dim=6, rgbnet_width=16, k_color=16) if fine \
        else dict(rgbnet_dim=0)
    jm, tm = _pair(JaxDVGOMS, DirectVoxGOMultiScene, 4, **BASE, n_scene=2,
                   **kw)
    assert tuple(tm.k0.shape) == tuple(jm.params["k0"].shape)
    o, d, vd = _rays(10, 3)
    cot = np.random.default_rng(8).normal(size=(10, 3)).astype(np.float32)
    for sid in (0, 1):
        def j_loss(params):
            ret = jm.forward(params, jm.mask, jnp.asarray(o), jnp.asarray(d),
                             jnp.asarray(vd), scene_id=sid,
                             render_depth=True, **RK)
            return _loss_terms(ret, [], cot), ret

        (_, j_ret), j_g = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(
            jm.params)
        t_ret = tm(torch.tensor(o), torch.tensor(d), torch.tensor(vd),
                   scene_id=sid, render_depth=True, **RK)
        _check_ret(t_ret, j_ret, f"scene {sid}")
        t_g = _torch_grads(tm, _loss_terms(t_ret, [], torch.tensor(cot)))
        for name in j_g:
            _close_tree(t_g[name], _np_tree(j_g[name]), TOL,
                        f"scene {sid} d{name}")


TRIMS_MODES = {
    "mlp_map": dict(compute_consistency=True, compute_cosine=True),
    "cosine_v1": dict(compute_cosine=True, cosine_v1=True),
    "inverse_mse": dict(compute_cosine=True, cosine_v2=False),
    "closed_map": dict(mlp_map=False, closed_map=True),
    "conv_map": dict(mlp_map=False, conv_map=True,
                     compute_consistency=True),
    "use_nl": dict(mlp_map=False, use_nl=True),
    "anchor_liif": dict(liif=True, use_anchor_liif=True, interp_width=16,
                        interp_depth=3),
}


@pytest.mark.parametrize("mode", list(TRIMS_MODES))
def test_tri_multiscene_forward_and_gradients_match_jax(mode):
    jm, tm = _pair(JaxTriMS, TriDVGOMultiScene, 5, **BASE, **SMALL,
                   n_scene=2, **TRIMS_MODES[mode])
    if mode == "use_nl":     # a nonzero output conv: attention shows
        rng = np.random.default_rng(9)
        jm.params["nl_block"]["wz"] = {
            "w": jnp.asarray(0.3 * rng.normal(size=(1, 1, 4, 8)),
                             jnp.float32),
            "b": jnp.asarray(rng.normal(size=(8,)), jnp.float32)}
        _module_from(tm.nl_block, jm.params["nl_block"])
    rgb, pose = _cond(3, 9, 6)
    o, d, vd = _rays(8, 4)
    cot = np.random.default_rng(10).normal(size=(8, 3)).astype(np.float32)

    def j_fwd(params):
        return jm.forward(params, jm.mask, jnp.asarray(rgb),
                          jnp.asarray(pose), jnp.asarray(o), jnp.asarray(d),
                          jnp.asarray(vd), scene_id=1, render_depth=True,
                          **RK)

    def j_loss(params):
        ret, cons, cos, dist = j_fwd(params)
        return (_loss_terms(ret, [cons, 0.01 * cos, dist], cot),
                (ret, cons, cos, dist))

    (j_ret, j_cons, j_cos, j_dist), j_g = _float_leaves_grad(
        j_loss, jm.params, has_aux=True)
    t_ret, t_cons, t_cos, t_dist = tm(
        _nchw(rgb), torch.tensor(pose), torch.tensor(o), torch.tensor(d),
        torch.tensor(vd), scene_id=1, render_depth=True, **RK)
    _check_ret(t_ret, j_ret, mode)
    for t, j, what in ((t_cons, j_cons, "consistency"),
                       (t_cos, j_cos, "cosine"),
                       (t_dist, j_dist, "distillation")):
        _close(float(t), float(j), TOL, f"{mode} {what}")
    if mode == "anchor_liif":
        assert float(t_dist) > 0
    t_g = _torch_grads(tm, _loss_terms(t_ret, [t_cons, 0.01 * t_cos, t_dist],
                                       torch.tensor(cot)))
    assert set(t_g) == {k for k in j_g}
    for name in j_g:
        _close_tree(t_g[name], j_g[name], TOL, f"{mode} d{name}")


def test_tri_rescale_matches_the_jax_grid_rescale():
    """The port's TriDVGO rescale is the JAX package's fused rescale
    without the k0 grid the JAX TriDVGO deleted (its own rescale raises)."""
    jm, tm = _pair(jax_tri.TriDVGO, torch_tri.TriDVGO, 6, **BASE, **SMALL)
    with pytest.raises(KeyError):
        jm.scale_volume_grid(20 ** 3)
    jm._set_grid_resolution(20 ** 3)
    d, _, mask = _pg_rescale_jit(
        jm.params["density"], None, None, None, None, None,
        new_size=tuple(jm.world_size), act_shift=float(jm.act_shift),
        interval=float(jm.voxel_size_ratio),
        thres=float(jm.fast_color_thres), c_bounds=None)
    tm.scale_volume_grid(20 ** 3)
    assert tuple(tm.world_size) == tuple(jm.world_size)
    _close(tm.density.detach().numpy(), d, TOL, "density")
    np.testing.assert_array_equal(tm.mask.numpy(), np.asarray(mask))


def test_multiscene_surgery_matches_jax():
    jm, tm = _pair(JaxDVGOMS, DirectVoxGOMultiScene, 7, **BASE, n_scene=2,
                   rgbnet_dim=0)
    cams = np.array([[0.0, 0.0, 0.0], [0.9, 0.9, 0.9]], np.float32)
    jm.maskout_near_cam_vox(cams, 0.5, scene_id=1)
    tm.maskout_near_cam_vox(cams, 0.5, scene_id=1)
    _close(tm.density.detach().numpy(), jm.params["density"], 0.0,
           "maskout")
    jm.update_occupancy_cache(scene_id=0)
    tm.update_occupancy_cache(scene_id=0)
    np.testing.assert_array_equal(tm.mask.numpy(), np.asarray(jm.mask))
    ro = np.array([[3.0, 0.0, 0.0], [0.0, 3.0, 0.1]], np.float32)
    rd = np.array([[-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]], np.float32)
    for sid in (0, 1):
        kw = dict(near=0.2, far=10.0, stepsize=0.5)
        np.testing.assert_array_equal(
            tm.hit_coarse_geo(ro, rd, scene_id=sid, **kw),
            np.asarray(jm.hit_coarse_geo(ro, rd, scene_id=sid, **kw)))
    jm.scale_volume_grid(20 ** 3)
    tm.scale_volume_grid(20 ** 3)
    _close(tm.density.detach().numpy(), jm.params["density"], TOL, "scale")
    _close(tm.k0.detach().numpy(), jm.params["k0"], TOL, "scale k0")
    np.testing.assert_array_equal(tm.mask.numpy(), np.asarray(jm.mask))
