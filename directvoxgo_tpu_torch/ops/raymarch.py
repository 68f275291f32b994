"""Ray-marching primitives: AABB clipping, dense and NDC point sampling,
raw2alpha, front-to-back compositing with early termination (with its
closed-form backward) and the fixed-capacity compaction of the gather
forward.

The samplers compute their points as the JAX package's compiler does:
it contracts ``a * b + c`` into fused multiply-adds (on the CPU as on the
accelerators) and divides by a constant as a product with its f32
reciprocal, and a one-ulp change in a sample point can flip its bbox
test, its occupancy voxel or its trilinear corner. A fused multiply-add is computed exactly as
an f64 product and sum rounded once to f32 (:func:`fma`)."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# Transmittance epsilon inside the product and the termination threshold.
T_EPS = 1e-10
T_TERMINATE = 1e-3


def ray_aabb_tminmax(rays_o, rays_d, xyz_min, xyz_max, near, far):
    """Per-ray AABB slab intersection -> (t_min, t_max) clamped to
    [near, far]; zero direction components become 1e-6."""
    vec = torch.where(rays_d == 0, torch.full_like(rays_d, 1e-6), rays_d)
    rate_a = (xyz_max - rays_o) / vec
    rate_b = (xyz_min - rays_o) / vec
    t_min = torch.clamp(torch.minimum(rate_a, rate_b).amax(-1), near, far)
    t_max = torch.clamp(torch.maximum(rate_a, rate_b).amin(-1), near, far)
    return t_min, t_max


def ray_aabb_tminmax_parts(o, d, xyz_min, xyz_max, near, far):
    """Component form of :func:`ray_aabb_tminmax`: ``o``/``d`` are 3-tuples
    of [N] tensors, the bbox python floats."""
    t_lo = t_hi = None
    for ov, dv, lo, hi in zip(o, d, xyz_min, xyz_max):
        vec = torch.where(dv == 0, torch.full_like(dv, 1e-6), dv)
        a = (float(hi) - ov) / vec
        b = (float(lo) - ov) / vec
        lo_t, hi_t = torch.minimum(a, b), torch.maximum(a, b)
        t_lo = lo_t if t_lo is None else torch.maximum(t_lo, lo_t)
        t_hi = hi_t if t_hi is None else torch.minimum(t_hi, hi_t)
    return torch.clamp(t_lo, near, far), torch.clamp(t_hi, near, far)


def fma(a, b, c):
    """``a * b + c`` rounded once to f32, as a fused multiply-add: the f32
    product is exact in f64, so only the final rounding remains."""
    return (a.double() * b.double() + c.double()).float()


def reciprocal32(c):
    """``1 / c`` in f32, the factor by which the JAX package's compiler
    replaces a division by the constant ``c``."""
    return float(np.float32(1.0) / np.float32(c))


def sample_points_dense_parts(rays_o, rays_d, xyz_min, xyz_max, near, far,
                              stepdist, n_samples):
    """Up to ``n_samples`` equidistant points per ray inside the AABB:
    ``o + d*t_min + unit(d) * stepdist * step``. Returns ((px, py, pz) each
    [N, n_samples], valid [N, n_samples] (in segment and in bbox), step_id
    [n_samples]). The step count, the start, the ray's norm and the points
    as the JAX package's compiler computes them (``(t_max - t_min) *
    reciprocal32(stepdist)``, ``fma(dz, dz, fma(dx, dx, dy * dy))``,
    ``fma(d, t_min, o)``, ``fma(unit, dist, start)``)."""
    o = tuple(rays_o[:, i] for i in range(3))
    d = tuple(rays_d[:, i] for i in range(3))
    t_min, t_max = ray_aabb_tminmax_parts(o, d, xyz_min, xyz_max, near, far)
    n_steps = torch.clamp(
        torch.ceil((t_max - t_min) * reciprocal32(stepdist)), min=1.0)
    rnorm = torch.sqrt(fma(d[2], d[2], fma(d[0], d[0], d[1] * d[1])))
    step_id = torch.arange(n_samples, dtype=torch.int32,
                           device=rays_o.device)
    dist = stepdist * step_id.to(rays_o.dtype)
    pts = []
    in_bbox = None
    for ov, dv, lo, hi in zip(o, d, xyz_min, xyz_max):
        unit = dv / rnorm
        p = fma(unit[:, None], dist[None, :], fma(dv, t_min, ov)[:, None])
        ok = (p >= float(lo)) & (p <= float(hi))
        in_bbox = ok if in_bbox is None else (in_bbox & ok)
        pts.append(p)
    in_segment = step_id[None, :] < n_steps[:, None]
    return tuple(pts), in_segment & in_bbox, step_id


def sample_points_dense(rays_o, rays_d, xyz_min, xyz_max, near, far,
                        stepdist, n_samples):
    """:func:`sample_points_dense_parts` in the packed layout: (pts [N, n_samples, 3], valid, step_id); python-float
    bounds."""
    mn = [float(v) for v in np.asarray(xyz_min, np.float64)]
    mx = [float(v) for v in np.asarray(xyz_max, np.float64)]
    pts, valid, step_id = sample_points_dense_parts(
        rays_o, rays_d, mn, mx, near, far, stepdist, n_samples)
    return torch.stack(pts, -1), valid, step_id


def sample_points_ndc_parts(rays_o, rays_d, n_samples, xyz_min, xyz_max):
    """The regular NDC sampler in component form: ``n_samples`` points at
    ray fractions j / (n_samples - 1) (``j * reciprocal32(n_samples -
    1)``, then ``fma(d, frac, o)``), valid inside the box. Returns ((px,
    py, pz), valid)."""
    frac = torch.arange(n_samples, dtype=torch.float32,
                        device=rays_o.device) * reciprocal32(n_samples - 1)
    pts, valid = [], None
    for i, (lo, hi) in enumerate(zip(xyz_min, xyz_max)):
        p = fma(rays_d[:, i][:, None], frac[None, :], rays_o[:, i][:, None])
        ok = (p >= float(lo)) & (p <= float(hi))
        valid = ok if valid is None else (valid & ok)
        pts.append(p)
    return tuple(pts), valid


def sample_points_ndc(rays_o, rays_d, xyz_min, xyz_max, n_samples):
    """:func:`sample_points_ndc_parts` in the packed layout: (pts [N,
    n_samples, 3], valid, step_id)."""
    mn = [float(v) for v in np.asarray(xyz_min, np.float64)]
    mx = [float(v) for v in np.asarray(xyz_max, np.float64)]
    pts, valid = sample_points_ndc_parts(rays_o, rays_d, n_samples, mn, mx)
    step_id = torch.arange(n_samples, dtype=torch.int32,
                           device=rays_o.device)
    return torch.stack(pts, -1), valid, step_id


def max_samples_for_bbox(xyz_min, xyz_max, stepdist):
    """Static per-ray sample capacity: bbox diagonal / step distance."""
    diag = float(np.linalg.norm(np.asarray(xyz_max) - np.asarray(xyz_min)))
    return int(np.ceil(diag / stepdist)) + 1


def raw2alpha(density, shift, interval):
    """``alpha = 1 - exp(-softplus(density + shift) * interval)`` in the
    ``-expm1`` form (full precision at small alphas); differentiated by
    autograd."""
    return -torch.expm1(-F.softplus(density + shift) * interval)


class _Alpha2WeightBidir(torch.autograd.Function):
    """Forward by shifted cumprods (never ``cumprod / one_minus``, whose
    backward is inf*0 at a saturated alpha); backward in closed form:

      dL/da_k = keep_k * dw_k * T_k - valid_k * (S_k + live_k * dA * A) / om_k

    with ``S_k`` the sum of ``dw_i * w_i`` over samples after ``k`` in march
    order (two exclusive cumsums). The termination mask ``live`` is
    constant, as under autograd of the comparison."""

    @staticmethod
    def forward(ctx, alpha, valid, forward):
        alpha_m = torch.where(valid, alpha, torch.zeros_like(alpha))
        one_minus = torch.where(valid, 1.0 - alpha_m + T_EPS,
                                torch.ones_like(alpha))
        ones = torch.ones_like(one_minus[..., :1])
        t_excl = torch.cumprod(
            torch.cat([ones, one_minus[..., :-1]], -1), -1)
        if forward is not None:
            t_excl_b = torch.cumprod(torch.cat(
                [one_minus[..., 1:], ones], -1).flip(-1), -1).flip(-1)
            t_excl = torch.where(forward[:, None], t_excl, t_excl_b)
        live = t_excl >= T_TERMINATE
        weights = torch.where(valid & live, t_excl * alpha_m,
                              torch.zeros_like(alpha))
        alphainv_last = torch.where(live, one_minus,
                                    torch.ones_like(one_minus)).prod(-1)
        keep = live & valid
        ctx.save_for_backward(weights, alphainv_last, t_excl, one_minus,
                              live, valid)
        ctx.forward = forward
        ctx.mark_non_differentiable(keep)
        return weights, alphainv_last, keep

    @staticmethod
    def backward(ctx, d_w, d_inv, _d_keep):
        (weights, alphainv_last, t_excl, one_minus, live,
         valid) = ctx.saved_tensors
        forward = ctx.forward
        zero = torch.zeros_like(weights)
        if d_w is None:
            d_w = zero
        if d_inv is None:
            d_inv = torch.zeros_like(alphainv_last)
        keep = valid & live
        wd = d_w * weights
        csum = torch.cumsum(wd, -1)
        s_fwd = csum[..., -1:] - csum          # sum over i > k
        s_bwd = csum - wd                      # sum over i < k
        s = s_fwd if forward is None else torch.where(forward[:, None],
                                                      s_fwd, s_bwd)
        a_term = torch.where(live, (d_inv * alphainv_last)[:, None], zero)
        # re-clamped reciprocal: one_minus can round to 0 at a saturated
        # alpha
        inv_om = torch.where(valid, 1.0 / torch.clamp(one_minus, min=T_EPS),
                             zero)
        d_alpha = torch.where(keep, d_w * t_excl, zero) - (s + a_term) * inv_om
        return d_alpha, None, None


def alpha2weight_dense_bidir(alpha, valid, forward):
    """Compositing weights for rows that march in either direction.

    alpha, valid: [N, S] in slab order; forward: [N] bool (True = row
    marches left to right). A sample is live while the transmittance
    entering it is >= T_TERMINATE. Returns (weights [N, S], alphainv_last
    [N], live & valid [N, S]); differentiable in ``alpha``
    (:class:`_Alpha2WeightBidir`).
    """
    return _Alpha2WeightBidir.apply(alpha, valid, forward)


def alpha2weight_dense(alpha, valid):
    """Compositing weights of rows that all march left to right (the gather
    forward's step order): the JAX package's shifted exclusive cumprod,
    ``T_i = prod_{j<i} (1 - alpha_j + 1e-10)`` over valid samples, live
    while ``T_i >= T_TERMINATE``. Returns (weights [N, S], alphainv_last
    [N], live & valid [N, S]); its backward is the closed form of
    :class:`_Alpha2WeightBidir`, finite at a saturated alpha."""
    return _Alpha2WeightBidir.apply(alpha, valid, None)


def compact_by_key(key, k, *arrays):
    """Gather, per row, the ``k`` entries with the smallest ``key`` [N, S]
    in a stable order (ties keep their sample order, as the JAX package's
    stable ``lax.sort`` and ``argsort``): returns (sorted key [N, k],
    each of ``arrays`` ([N, S, ...]) gathered alike)."""
    order = torch.sort(key, dim=-1, stable=True).indices[:, :k]
    outs = []
    for arr in (key, *arrays):
        idx = order.reshape(order.shape + (1,) * (arr.dim() - 2)).expand(
            *order.shape, *arr.shape[2:])
        outs.append(torch.gather(arr, 1, idx))
    return tuple(outs)
