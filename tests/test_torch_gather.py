"""The port's gather path against the JAX package on the CPU: the trilinear
sampler and its gradient, the samplers' points, validity, occupancy and
corner indices, compositing, the stable compaction, ``DirectVoxGO.forward``
in every colour mode (and ``DirectMPIGO.forward``) with its gradients, the
exact view count and its form selection, the gather draws, checkpoints of
gather models across the two packages, and the clamped device boxes.

Inputs are made with numpy from a seed and handed to both packages; the
JAX functions run on the CPU as the JAX package's own tests run them.
"""

import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from directvoxgo_tpu import rays as jax_rays
from directvoxgo_tpu.engine import checkpoint as jax_ckpt
from directvoxgo_tpu.engine import render as jax_render
from directvoxgo_tpu.models.dmpigo import DirectMPIGO as JaxMPIGO
from directvoxgo_tpu.models.dvgo import DirectVoxGO as JaxDVGO
from directvoxgo_tpu.ops import grid as jax_grid
from directvoxgo_tpu.ops import raymarch as jax_rm
from directvoxgo_tpu_torch import convert
from directvoxgo_tpu_torch.config import ConfigDict
from directvoxgo_tpu_torch.engine import checkpoint as torch_ckpt
from directvoxgo_tpu_torch.engine import draws as draws_lib
from directvoxgo_tpu_torch.engine import render as torch_render
from directvoxgo_tpu_torch.models.dmpigo import DirectMPIGO as TorchMPIGO
from directvoxgo_tpu_torch.models.dvgo import DirectVoxGO as TorchDVGO
from directvoxgo_tpu_torch.ops import grid as torch_grid
from directvoxgo_tpu_torch.ops import raymarch as torch_rm

RK = dict(near=0.5, far=8.0, bg=1.0, stepsize=0.5)
GRID_KW = dict(xyz_min=[-1.6, -1.0, -0.5], xyz_max=[1.6, 1.0, 0.5],
               num_voxels=32 * 20 * 10, num_voxels_base=32 * 20 * 10)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rays(seed, n):
    """Rays from both ends of the box along +-x through the blob, and a
    quarter of them in random directions from random points outside."""
    rng = np.random.default_rng(seed)
    ro = np.stack([np.where(rng.uniform(size=n) < 0.5, -3.0, 3.0),
                   rng.uniform(-0.3, 0.3, n), rng.uniform(-0.3, 0.3, n)],
                  -1).astype(np.float32)
    rd = np.stack([-np.sign(ro[:, 0]), rng.uniform(-0.15, 0.15, n),
                   rng.uniform(-0.15, 0.15, n)], -1).astype(np.float32)
    q = n // 4
    ro[:q] = rng.uniform(-2.5, 2.5, (q, 3))
    rd[:q] = -ro[:q] + rng.normal(0, 0.3, (q, 3))
    vd = rd / np.linalg.norm(rd, axis=-1, keepdims=True)
    rgb = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    return ro, rd, vd.astype(np.float32), rgb


def _dvgo_pair(seed, **kw):
    """A JAX gather model with a density blob and random k0 (and MLP), and
    the port's model with the same parameters and mask."""
    rng = np.random.default_rng(seed)
    kw = dict(dict(alpha_init=1e-2, fast_color_thres=1e-4, rgbnet_depth=3,
                   rgbnet_width=16, query_mode="gather"), **kw)
    jm = JaxDVGO(**GRID_KW, **kw)
    pts = np.asarray(jm.grid_points())
    dens = (12.0 * np.exp(-(pts[..., 0] / 1.1) ** 2
                          - (pts[..., 1] / 0.35) ** 2
                          - (pts[..., 2] / 0.3) ** 2) - 8.0)
    jm.params["density"] = jnp.asarray(
        (dens + rng.normal(0, 0.5, dens.shape)).astype(np.float32))
    jm.params["k0"] = jnp.asarray(rng.normal(
        0, 0.5, jm.params["k0"].shape).astype(np.float32))
    jm.update_occupancy_cache()
    # the port's constructor from the asked query_mode (grid-LIIF forces
    # gather in both packages)
    tm = TorchDVGO(**dict(jm.get_kwargs(), query_mode=kw["query_mode"]),
                   device="cpu")
    tm.load_state_dict(convert.params_from_jax(_np_tree(jm.params),
                                               np.asarray(jm.mask)))
    return jm, tm


def _t(x):
    return torch.tensor(np.asarray(x))


def _close(got, want, tol, rel=False):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    if not got.size:
        return
    scale = max(float(np.abs(want).max()), 1e-30) if rel else 1.0
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (err, tol * scale)


# ---------------------------------------------------------- the sampler

@pytest.mark.parametrize("form,dims,channels", [
    ("parts", (7, 6, 5), 0), ("parts", (7, 6, 5), 4),
    ("packed", (7, 6, 5), 4), ("world", (7, 6, 5), 3),
    ("parts", (1, 4, 2), 2)])
def test_trilinear_sample_and_its_gradient_match_jax(form, dims, channels):
    """Values and the grid's gradient (a random cotangent) of the sampler
    at points inside and outside the grid (clamped to the border), against
    the JAX package's: < 2e-5."""
    rng = np.random.default_rng(len(form) + channels)
    shape = dims + ((channels,) if channels else ())
    grid = rng.normal(size=shape).astype(np.float32)
    pts = np.stack([rng.uniform(-1.5, d + 0.5, (40, 9)) for d in dims],
                   -1).astype(np.float32)
    lo, hi = (-1.0, -2.0, 0.5), (1.5, 2.0, 3.0)
    ct = rng.normal(size=pts.shape[:2] + shape[3:]).astype(np.float32)

    def jf(g):
        if form == "parts":
            return jax_grid.trilinear_sample_parts(
                g, pts[..., 0], pts[..., 1], pts[..., 2])
        if form == "packed":
            return jax_grid.trilinear_sample(g, jnp.asarray(pts))
        return jax_grid.trilinear_sample_world(
            g, pts[..., 0], pts[..., 1], pts[..., 2], lo, hi)

    j_out, vjp = jax.vjp(jax.jit(jf), jnp.asarray(grid))
    (j_grad,) = vjp(jnp.asarray(ct))

    tg = _t(grid).requires_grad_(True)
    tp = _t(pts)
    if form == "parts":
        t_out = torch_grid.trilinear_sample_parts(tg, tp[..., 0], tp[..., 1],
                                                  tp[..., 2])
    elif form == "packed":
        t_out = torch_grid.trilinear_sample(tg, tp)
    else:
        t_out = torch_grid.trilinear_sample_world(tg, tp[..., 0], tp[..., 1],
                                                  tp[..., 2], lo, hi)
    (t_grad,) = torch.autograd.grad(t_out, tg, _t(ct))
    _close(t_out.detach(), j_out, 2e-5)
    _close(t_grad, j_grad, 2e-5)


@pytest.mark.parametrize("sampler", ["dense", "ndc"])
def test_samples_validity_occupancy_and_corners_bit_for_bit(sampler):
    """The samplers' points (within 2 ulp: the JAX package's division may
    round the other way), then bit for bit: validity, the mask's nearest
    voxel and occupancy, and the trilinear lower corners, each package
    from its own points; the corners also from the same points."""
    rng = np.random.default_rng(11)
    n = 256
    lo, hi = (-1.3, -1.1, -0.9), (1.2, 1.05, 0.95)
    if sampler == "dense":
        ro = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
        rd = rng.normal(size=(n, 3)).astype(np.float32)
        args = (lo, hi, 0.2, 6.0, 0.0237, 180)
        (jx, jy, jz), j_valid, _ = jax.jit(
            lambda o, d: jax_rm.sample_points_dense_parts(o, d, *args))(
                jnp.asarray(ro), jnp.asarray(rd))
        (tx, ty, tz), t_valid, _ = torch_rm.sample_points_dense_parts(
            _t(ro), _t(rd), *args)
    else:
        ro = np.concatenate([rng.uniform(-1.4, 1.4, (n, 2)),
                             -np.ones((n, 1))], 1).astype(np.float32)
        rd = np.concatenate([rng.uniform(-0.4, 0.4, (n, 2)),
                             2 * np.ones((n, 1))], 1).astype(np.float32)
        (jx, jy, jz), j_valid = jax.jit(
            lambda o, d: JaxMPIGO._sample_ndc_parts(o, d, 129, lo, hi))(
                jnp.asarray(ro), jnp.asarray(rd))
        (tx, ty, tz), t_valid = torch_rm.sample_points_ndc_parts(
            _t(ro), _t(rd), 129, lo, hi)
    for a, b in ((tx, jx), (ty, jy), (tz, jz)):
        b = np.asarray(b)
        assert np.all(np.abs(a.numpy() - b) <= 2 * np.spacing(np.abs(b)))
    np.testing.assert_array_equal(t_valid.numpy(), np.asarray(j_valid))

    dims = (13, 11, 9)
    mask = rng.uniform(size=dims) < 0.5
    j_occ = jax.jit(lambda m, x, y, z: jax_grid.occupancy_lookup_parts(
        m, x, y, z, lo, hi))(jnp.asarray(mask), jx, jy, jz)
    t_occ = torch_grid.occupancy_lookup_parts(_t(mask), tx, ty, tz, lo, hi)
    np.testing.assert_array_equal(t_occ.numpy(), np.asarray(j_occ))

    def j_corners(x, y, z):
        out = []
        for v, n_ in zip(jax_grid.world_to_grid_parts(x, y, z, lo, hi, dims),
                         dims):
            v = jnp.clip(v, 0.0, n_ - 1.0)
            out.append(jnp.clip(jnp.floor(v).astype(jnp.int32), 0,
                                max(n_ - 2, 0)))
        return (out[0] * dims[1] + out[1]) * dims[2] + out[2]

    def t_corners(x, y, z):
        base, _, _ = torch_grid.trilinear_corners(
            *torch_grid.world_to_grid_parts(x, y, z, lo, hi, dims), dims)
        return base.numpy()

    jc = np.asarray(jax.jit(j_corners)(jx, jy, jz))
    np.testing.assert_array_equal(t_corners(tx, ty, tz), jc)
    np.testing.assert_array_equal(
        t_corners(*(_t(v) for v in (jx, jy, jz))), jc)


def test_ndc_sampler_points_are_bitwise_jax():
    """The NDC sampler's points bit for bit: the JAX package's compiler
    divides by the sample count less one (126, not a power of two) as a
    product with the f32 reciprocal, and contracts ``o + d * frac`` into
    a fused multiply-add; the port does both."""
    rng = np.random.default_rng(13)
    n = 2048
    lo, hi = (-1.3, -1.1, -0.9), (1.2, 1.05, 0.95)
    ro = np.concatenate([rng.uniform(-1.4, 1.4, (n, 2)),
                         -np.ones((n, 1))], 1).astype(np.float32)
    rd = np.concatenate([rng.uniform(-0.4, 0.4, (n, 2)),
                         2 * np.ones((n, 1))], 1).astype(np.float32)
    jout = jax.jit(lambda o, d: JaxMPIGO._sample_ndc_parts(
        o, d, 127, lo, hi))(jnp.asarray(ro), jnp.asarray(rd))
    tout = torch_rm.sample_points_ndc_parts(_t(ro), _t(rd), 127, lo, hi)
    for a, b in zip(tout[0], jout[0]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(tout[1].numpy(), np.asarray(jout[1]))


def test_packed_samplers_and_occupancy_match_jax():
    """The packed-layout ``sample_points_dense``, ``sample_points_ndc``
    and ``occupancy_lookup``: points within 1e-6 (two ulp at the rays'
    extent of 6; the JAX package reduces the ray's norm in another
    order), validity and occupancy bit for bit."""
    rng = np.random.default_rng(12)
    n = 128
    lo = np.asarray([-1.3, -1.1, -0.9], np.float32)
    hi = np.asarray([1.2, 1.05, 0.95], np.float32)
    ro = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    mask = rng.uniform(size=(9, 8, 7)) < 0.5
    for jf, tf, args in (
            (jax_rm.sample_points_dense, torch_rm.sample_points_dense,
             (0.2, 6.0, 0.05, 90)),
            (jax_rm.sample_points_ndc, torch_rm.sample_points_ndc, (33,))):
        jp, jv, js = jax.jit(lambda o, d: jf(o, d, jnp.asarray(lo),
                                             jnp.asarray(hi), *args))(
            jnp.asarray(ro), jnp.asarray(rd))
        tp, tv, ts = tf(_t(ro), _t(rd), lo, hi, *args)
        jp = np.asarray(jp)
        assert np.abs(tp.numpy() - jp).max() <= 1e-6
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        j_occ = jax_grid.occupancy_lookup(jnp.asarray(mask), jnp.asarray(jp),
                                          lo, hi)
        t_occ = torch_grid.occupancy_lookup(_t(mask), _t(jp), lo, hi)
        np.testing.assert_array_equal(t_occ.numpy(), np.asarray(j_occ))


# ---------------------------------------------------- compositing, compaction

def test_alpha2weight_dense_matches_jax_and_stays_finite_when_saturated():
    """Weights, background transmittance and the live mask (< 1e-5, mask
    bit for bit), and the alpha gradient of a random cotangent (< 1e-5 of
    its largest entry), finite at an alpha of exactly 1."""
    rng = np.random.default_rng(0)
    a = rng.uniform(0, 0.5, (8, 24)).astype(np.float32)
    a[2, 10] = 1.0
    a[5, 0] = 1.0
    a[6, 3:] = 0.9
    valid = rng.uniform(size=(8, 24)) > 0.2
    ct_w = rng.normal(size=(8, 24)).astype(np.float32)
    ct_a = rng.normal(size=8).astype(np.float32)

    def jf(alpha):
        w, ainv, live = jax_rm.alpha2weight_dense(alpha, jnp.asarray(valid))
        return jnp.sum(w * ct_w) + jnp.sum(ainv * ct_a), (w, ainv, live)

    (_, (jw, ja, jl)), jg = jax.jit(jax.value_and_grad(jf, has_aux=True))(
        jnp.asarray(a))
    ta = _t(a).requires_grad_(True)
    tw, tai, tl = torch_rm.alpha2weight_dense(ta, _t(valid))
    (tg,) = torch.autograd.grad(torch.sum(tw * _t(ct_w))
                                + torch.sum(tai * _t(ct_a)), ta)
    _close(tw.detach(), jw, 1e-5)
    _close(tai.detach(), ja, 1e-5)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert torch.isfinite(tg).all()
    _close(tg, jg, 1e-5, rel=True)


@pytest.mark.parametrize("payloads", ["rank2", "rank3"])
def test_compact_by_key_keeps_the_jax_order_with_ties(payloads):
    """Keys with many ties (zero weights, as the colour compaction sees
    them, and equal steps) keep their sample order: every gathered payload
    bit for bit against the JAX package's (its multi-operand stable sort
    for rank-2 payloads, its argsort for rank > 2)."""
    rng = np.random.default_rng(3)
    w = np.where(rng.uniform(size=(16, 40)) < 0.6, 0.0,
                 rng.choice([0.25, 0.5, 0.125], (16, 40))).astype(np.float32)
    key = -w
    step = np.broadcast_to(np.arange(40, dtype=np.float32), (16, 40))
    occ = rng.uniform(size=(16, 40)) < 0.5
    arrays = [w, step, occ]
    if payloads == "rank3":
        arrays.append(rng.normal(size=(16, 40, 3)).astype(np.float32))
    j_out = jax_rm.compact_by_key(jnp.asarray(key), 12,
                                  *(jnp.asarray(a) for a in arrays))
    t_out = torch_rm.compact_by_key(_t(key), 12, *(_t(a) for a in arrays))
    assert len(j_out) == len(t_out) == len(arrays) + 1
    for a, b in zip(t_out, j_out):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ----------------------------------------------------------- the forwards

DVGO_MODES = {
    "coarse": dict(rgbnet_dim=0),
    "coarse dense": dict(rgbnet_dim=0, fast_color_thres=0),
    "fine": dict(rgbnet_dim=12, rgbnet_direct=False, k_density=40,
                 k_color=12),
    "fine dense": dict(rgbnet_dim=12, rgbnet_direct=False, k_color=0),
    "fine no thres": dict(rgbnet_dim=12, rgbnet_direct=False, k_color=12,
                          fast_color_thres=0),
    "fine direct": dict(rgbnet_dim=12, rgbnet_direct=True, k_density=40,
                        k_color=12),
    "posbase_pe": dict(rgbnet_dim=12, posbase_pe=2, k_color=12),
    "full_implicit": dict(rgbnet_dim=12, rgbnet_full_implicit=True,
                          k_density=40, k_color=12),
}
for _u in (True, False):
    for _c in (True, False):
        for _e in (True, False):
            DVGO_MODES[f"liif unfold={_u} cell={_c} ensemble={_e}"] = dict(
                rgbnet_dim=4, implicit_voxel_feat=True, feat_unfold=_u,
                cell_decode=_c, local_ensemble=_e, k_density=40, k_color=8,
                query_mode="sweep")


def _forward_pair(jm, tm, ro, rd, vd, fwd_j, fwd_t):
    """Outputs of both forwards and the gradients of a loss of all of them
    (MSE, the background entropy, the per-point colour loss) with respect
    to every parameter."""
    target = np.random.default_rng(1).uniform(0, 1, (ro.shape[0], 3))
    target = target.astype(np.float32)

    def loss_of(ret, lib, t):
        mse = lib.mean((ret["rgb_marched"] - t) ** 2)
        pout = lib.clip(ret["alphainv_last"], 1e-6, 1 - 1e-6)
        ent = -lib.mean(pout * lib.log(pout) + (1 - pout) * lib.log(1 - pout))
        per = lib.sum((ret["raw_rgb"] - t[:, None, :]) ** 2, -1)
        return mse + 0.01 * ent + 0.1 * lib.sum(per * ret["weights"]) / 100

    def jl(params):
        ret = fwd_j(params)
        return loss_of(ret, jnp, jnp.asarray(target)), ret

    (_, j_ret), j_grads = jax.jit(jax.value_and_grad(jl, has_aux=True))(
        jm.params)
    t_ret = fwd_t()
    t_loss = loss_of(t_ret, torch, _t(target))
    named = dict(tm.named_parameters())
    t_grads = dict(zip(named, torch.autograd.grad(
        t_loss, list(named.values()), allow_unused=True)))
    return j_ret, _np_tree(j_grads), t_ret, t_grads


def _check_forward(j_ret, j_grads, t_ret, t_grads):
    for key in ("rgb_marched", "alphainv_last", "weights", "raw_alpha",
                "raw_rgb", "depth"):
        _close(t_ret[key].detach(), j_ret[key], 1e-5)
    # Under differentiation the JAX package computes the transmittance's
    # cumprod as a parallel prefix scan, whose rounding differs from a
    # running product: a sample entering with T within an ulp of the 1e-3
    # termination may be live in one package only (its weight is then
    # below 1e-3 * alpha, inside the tolerances above).
    wm_t, wm_j = t_ret["wmask"].numpy(), np.asarray(j_ret["wmask"])
    assert np.mean(wm_t != wm_j) <= 1e-3
    want = convert.params_from_jax(j_grads, np.zeros(1, bool))
    want.pop("mask")
    for name, w in want.items():
        g = t_grads[name]
        g = torch.zeros_like(w) if g is None else g
        _close(g, w, 1e-4, rel=True)


@pytest.mark.parametrize("mode", list(DVGO_MODES))
def test_dvgo_forward_and_gradients_match_jax(mode):
    """``DirectVoxGO.forward`` (the gather forward) in every colour mode,
    with and without the ``k_density`` and ``k_color`` compactions and the
    ``fast_color_thres`` gates: every output (rgb 1e-5, the kept-sample
    fields 1e-5, ``wmask`` on all but at most 1e-3 of the samples, which
    may sit at the termination threshold) and the loss gradient of every
    parameter (1e-4 of its largest entry). Grid-LIIF forces gather."""
    jm, tm = _dvgo_pair(5, **DVGO_MODES[mode])
    assert jm.query_mode == tm.query_mode == "gather"
    if tm.rgbnet is not None:
        assert tm.rgbnet_dim0 == jm.rgbnet_dim0
    ro, rd, vd, _ = _rays(6, 100)
    j_ret, j_grads, t_ret, t_grads = _forward_pair(
        jm, tm, ro, rd, vd,
        lambda p: jm.forward(p, jm.mask, jnp.asarray(ro), jnp.asarray(rd),
                             jnp.asarray(vd), render_depth=True, **RK),
        lambda: tm(_t(ro), _t(rd), _t(vd), render_depth=True, **RK))
    _check_forward(j_ret, j_grads, t_ret, t_grads)


@pytest.mark.parametrize("rgbnet_dim,k_color", [(0, 0), (6, 24), (6, 0)])
def test_dmpigo_forward_and_gradients_match_jax(rgbnet_dim, k_color):
    """``DirectMPIGO.forward`` on NDC rays, coarse and fine, with and
    without the colour compaction: as the DirectVoxGO forward."""
    rng = np.random.default_rng(7)
    jm = JaxMPIGO(xyz_min=[-1.5, -1.2, -1.0], xyz_max=[1.5, 1.2, 1.0],
                  num_voxels=40 * 32 * 24, mpi_depth=24,
                  fast_color_thres=1e-3, rgbnet_dim=rgbnet_dim,
                  rgbnet_width=16, viewbase_pe=2, k_color=k_color,
                  query_mode="gather")
    jm.params["density"] = jnp.asarray(np.asarray(jm.params["density"])
                                       + rng.normal(0, 1.0, jm.world_size)
                                       .astype(np.float32))
    jm.params["k0"] = jnp.asarray(rng.normal(
        0, 0.5, jm.params["k0"].shape).astype(np.float32))
    jm.update_occupancy_cache()
    tm = TorchMPIGO(**jm.get_kwargs(), device="cpu")
    tm.load_state_dict(convert.params_from_jax(_np_tree(jm.params),
                                               np.asarray(jm.mask)))
    n = 100
    ro = np.concatenate([rng.uniform(-1.2, 1.2, (n, 2)), -np.ones((n, 1))],
                        1).astype(np.float32)
    rd = np.concatenate([rng.uniform(-0.3, 0.3, (n, 2)), 2 * np.ones((n, 1))],
                        1).astype(np.float32)
    vd = rng.normal(size=(n, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    rk = dict(near=0.0, far=1.0, bg=0.0, stepsize=0.5)
    j_ret, j_grads, t_ret, t_grads = _forward_pair(
        jm, tm, ro, rd, vd,
        lambda p: jm.forward(p, jm.mask, jnp.asarray(ro), jnp.asarray(rd),
                             jnp.asarray(vd), render_depth=True, **rk),
        lambda: tm(_t(ro), _t(rd), _t(vd), render_depth=True, **rk))
    _check_forward(j_ret, j_grads, t_ret, t_grads)


def test_unfold_grid_matches_jax():
    """The 3x3x3 edge-replicated neighbourhood, position-outer, bit for
    bit."""
    g = np.random.default_rng(4).normal(size=(5, 4, 3, 2)).astype(np.float32)
    np.testing.assert_array_equal(
        TorchDVGO._unfold_grid_3x3x3(_t(g)).numpy(),
        np.asarray(JaxDVGO._unfold_grid_3x3x3(jnp.asarray(g))))


# ------------------------------------------------------ the view count

def _count_views_case():
    """Three 24x24 ring views of a 24^3 grid (the JAX package's count
    test's geometry) and the models."""
    views_o, views_d, imsz = [], [], []
    for ang in (0.0, 0.7, 2.2):
        cam = np.array([3.0 * np.cos(ang), 3.0 * np.sin(ang), 1.2],
                       np.float32)
        fwd = -cam / np.linalg.norm(cam)
        right = np.cross(fwd, [0.0, 0.0, 1.0])
        right /= np.linalg.norm(right)
        up = np.cross(right, fwd)
        i, j = np.meshgrid(np.linspace(-0.35, 0.35, 24),
                           np.linspace(-0.35, 0.35, 24))
        d = (fwd[None, None] + i[..., None] * right[None, None]
             + j[..., None] * up[None, None]).reshape(-1, 3)
        views_o.append(np.tile(cam, (24 * 24, 1)).astype(np.float32))
        views_d.append(d.astype(np.float32))
        imsz.append(24 * 24)
    kw = dict(xyz_min=[-1.0, -1.0, -1.0], xyz_max=[1.0, 1.0, 1.0],
              num_voxels=24 ** 3, num_voxels_base=24 ** 3, alpha_init=1e-2,
              rgbnet_dim=0, query_mode="gather")
    return (np.concatenate(views_o), np.concatenate(views_d), imsz, kw)


def test_exact_view_count_matches_jax():
    """The exact count (``query_mode='gather'``) against the JAX
    package's: equal at every voxel whose JAX per-view sum lies more than
    1e-4 from the threshold in every view (the scatter adds in another
    order); the voxels within it are counted and printed."""
    ro, rd, imsz, kw = _count_views_case()
    jm, tm = JaxDVGO(**kw), TorchDVGO(**kw, device="cpu")
    ckw = dict(imsz=imsz, near=0.5, far=6.0, stepsize=0.5)
    want = np.asarray(jm.voxel_count_views(rays_o_tr=ro, rays_d_tr=rd,
                                           **ckw))
    got = tm.voxel_count_views(rays_o_tr=ro, rays_d_tr=rd, **ckw).numpy()
    # the JAX package's per-view sums (its count's own arithmetic)
    n_samples = int(np.linalg.norm(np.array(jm.world_size) + 1) / 0.5) + 1
    rng_s = np.arange(n_samples, dtype=np.float32)[None]
    near_thr = np.zeros(jm.world_size, bool)
    for v in range(len(imsz)):
        o = jnp.asarray(ro[v * 576:(v + 1) * 576])
        d = jnp.asarray(rd[v * 576:(v + 1) * 576])
        vec = jnp.where(d == 0, 1e-6, d)
        t_min = jnp.clip(jnp.max(jnp.minimum(
            (jnp.asarray(jm.xyz_max) - o) / vec,
            (jnp.asarray(jm.xyz_min) - o) / vec), -1), 0.5, 6.0)
        interp = t_min[:, None] + 0.5 * jm.voxel_size * jnp.asarray(
            rng_s) / jnp.linalg.norm(d, axis=-1, keepdims=True)
        pts = o[:, None, :] + d[:, None, :] * interp[..., None]
        g = jax.jit(jax.grad(lambda og: jnp.sum(jm.grid_sampler(pts, og))))(
            jnp.ones(jm.world_size, jnp.float32))
        near_thr |= np.abs(np.asarray(g) - 1.0) < 1e-4
    print(f"exact count: {int(near_thr.sum())} voxels within 1e-4 of the "
          f"threshold, {int((got != want).sum())} differ")
    assert want.max() > 0 and (want > 0).mean() > 0.05
    np.testing.assert_array_equal(got[~near_thr], want[~near_thr])


@pytest.mark.parametrize("form,query_mode,want", [
    ("", "gather", "exact"), ("", "sweep", "sweep"),
    ("exact", "sweep", "exact"), ("sweep", "gather", "sweep"),
    ("Sweep", "gather", ValueError), ("scatter", "sweep", ValueError)])
def test_count_form_is_chosen_as_jax_chooses_it(monkeypatch, form,
                                                query_mode, want):
    """``DVGO_COUNT_FORM`` overrides ``query_mode``; any other value than
    'sweep' and 'exact' raises ``ValueError`` in both packages."""
    ro, rd, imsz, kw = _count_views_case()
    kw = dict(kw, query_mode=query_mode)
    monkeypatch.setenv("DVGO_COUNT_FORM", form)
    tm = TorchDVGO(**kw, device="cpu")
    taken = []
    monkeypatch.setattr(TorchDVGO, "_voxel_count_views_exact",
                        lambda self, *a, **k: taken.append("exact")
                        or torch.zeros(self.world_size))
    ckw = dict(rays_o_tr=ro[:576], rays_d_tr=rd[:576], imsz=imsz[:1],
               near=0.5, far=6.0, stepsize=0.5)
    if want is ValueError:
        with pytest.raises(ValueError):
            tm.voxel_count_views(**ckw)
        with pytest.raises(ValueError):
            JaxDVGO(**kw).voxel_count_views(**ckw)
        return
    tm.voxel_count_views(**ckw)
    assert taken == (["exact"] if want == "exact" else [])


# ----------------------------------------------------------- the draws

@pytest.mark.parametrize("sampler,n_pool", [("flatten", 5000),
                                            ("in_maskcache", 3000),
                                            ("random", 5000),
                                            ("flatten", 700)])
def test_gather_draws_match_the_jax_engine(sampler, n_pool):
    """A gather model's chunks draw from the whole pool as the JAX engine
    does: ``batch_indices_generator(n_pool, N_rand, rng)`` for the flatten
    and in_maskcache pools that hold a batch, ``rng.integers`` otherwise;
    bit for bit from one seed, axis None, no window key."""
    n_rand = 1024
    model = types.SimpleNamespace(query_mode="gather", world_size=(8, 8, 8))
    cfg = ConfigDict(N_rand=n_rand, ray_sampler=sampler)
    rays = np.zeros((n_pool, 3), np.float32)
    draws = draws_lib.Draws(model, cfg, None, rays, rays, 0.5, 6.0,
                            np.random.default_rng(9), {}, "cpu", "fine")
    draws.set_grid()
    rng = np.random.default_rng(9)
    if sampler != "random" and n_pool >= n_rand:
        gen = jax_rays.batch_indices_generator(n_pool, n_rand, rng=rng)
        want = [np.asarray(next(gen)) for _ in range(11)]
    else:
        want = [rng.integers(0, n_pool, n_rand) for _ in range(11)]
    got = []
    for n_sub in (8, 1, 2):
        sels, axis, key, offs = draws.next_chunk(n_sub, False)
        assert axis is None and key is None and offs is None
        assert sels.shape == (n_sub, n_rand)
        got += list(sels)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------ the checkpoints

@pytest.mark.parametrize("variant", ["fine", "liif"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_gather_checkpoints_render_alike_in_both_packages(tmp_path, variant,
                                                          writer):
    """A gather model's checkpoint written by one package and rendered
    by both (per ray, through the gather forward): at least 45 dB per view
    between them."""
    kw = (dict(rgbnet_dim=12, k_density=60, k_color=16) if variant == "fine"
          else dict(rgbnet_dim=4, implicit_voxel_feat=True,
                    feat_unfold=True, k_color=8))
    jm, tm = _dvgo_pair(8, **kw)
    path = str(tmp_path / "fine_last.tar")
    if writer == "jax":
        jax_ckpt.save_model_checkpoint(path, jm, 7)
        jax_ckpt.wait_for_pending_saves()
        tm = torch_ckpt.load_model(TorchDVGO, path, device="cpu")
    else:
        torch_ckpt.save_model_checkpoint(path, tm, 7)
        jm = jax_ckpt.load_model(JaxDVGO, path)
    assert tm.query_mode == jm.query_mode == "gather"
    K = np.array([[30.0, 0, 12.0], [0, 30.0, 12.0], [0, 0, 1]], np.float32)
    poses = []
    for ang in (0.3, 1.9):
        cam = np.array([3.0 * np.cos(ang), 3.0 * np.sin(ang), 0.8])
        fwd = -cam / np.linalg.norm(cam)
        right = np.cross(fwd, [0.0, 0.0, 1.0])
        right /= np.linalg.norm(right)
        up = np.cross(right, fwd)
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, :3] = np.stack([right, up, -fwd], 1)
        c2w[:3, 3] = cam
        poses.append(c2w)
    poses = np.stack(poses)
    HW, Ks = np.array([[24, 24]] * 2), np.stack([K, K])
    rk = dict(RK, inverse_y=False, render_depth=True)
    j_rgb, _, _ = jax_render.render_viewpoints(
        jm, poses, HW, Ks, False, rk, chunk=256, verbose=False)
    t_rgb, _, stats = torch_render.render_viewpoints(
        tm, poses, HW, Ks, False, rk, chunk=256, verbose=False)
    assert stats["path"] == ["rays", "rays"]
    for a, b in zip(t_rgb, j_rgb):
        mse = float(np.mean((a - np.asarray(b)) ** 2))
        assert mse == 0.0 or -10 * np.log10(mse) >= 45.0
    assert float(np.abs(np.asarray(j_rgb) - 1.0).max()) > 0.05


# ----------------------------------------------------- clamped boxes (C3)

@pytest.mark.parametrize("perm", [(0, 1, 2), (1, 2, 0)])
def test_device_box_clamps_offsets_as_dynamic_slice(perm):
    """``DeviceBox.take`` and ``put`` at starts past each edge (negative,
    and beyond ``dim - size``) read and write the box that
    ``jax.lax.dynamic_slice`` and ``dynamic_update_slice`` clamp to. One
    box reads its offsets at every call of a step (the int32 tensor
    rewritten in place between two calls, as a CUDA graph's replays find
    it): both calls clamp."""
    rng = np.random.default_rng(sum(perm))
    dims, sizes = (7, 9, 8), (3, 4, 5)
    grid = rng.normal(size=dims + (2,)).astype(np.float32)
    starts = [(-2, 0, 0), (6, 0, 0), (0, -1, 7), (0, 8, -3), (5, 6, 4),
              (-9, 20, 11)]
    for start in starts:
        off = torch.tensor([start[a] for a in perm], dtype=torch.int32)
        box = torch_grid.DeviceBox(off, sizes, dims, perm)
        want = jax.lax.dynamic_slice(jnp.asarray(grid), (*start, 0),
                                     (*sizes, 2))
        np.testing.assert_array_equal(box.take(_t(grid)).numpy(),
                                      np.asarray(want))
        vals = rng.normal(size=sizes + (2,)).astype(np.float32)
        dst = _t(grid).clone()
        box.put(dst, _t(vals))
        np.testing.assert_array_equal(dst.numpy(), np.asarray(
            jax.lax.dynamic_update_slice(jnp.asarray(grid),
                                         jnp.asarray(vals), (*start, 0))))

    # offsets read at every call: one tensor, rewritten in place
    off = torch.tensor([0, 0, 0], dtype=torch.int32)

    def step(t):
        return torch_grid.DeviceBox(off, sizes, dims, perm).take(t)

    for start in ((1, 2, 3), (9, -4, 6)):
        off.copy_(torch.tensor([start[a] for a in perm], dtype=torch.int32))
        np.testing.assert_array_equal(step(_t(grid)).numpy(), np.asarray(
            jax.lax.dynamic_slice(jnp.asarray(grid), (*start, 0),
                                  (*sizes, 2))))
