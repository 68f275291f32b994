"""Ray-marching primitives: AABB clipping, raw2alpha and front-to-back
compositing with early termination (forward only; the custom backward of
``alpha2weight_dense_bidir`` comes with training)."""

from __future__ import annotations

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


def raw2alpha(density, shift, interval):
    """``alpha = 1 - exp(-softplus(density + shift) * interval)`` in the
    ``-expm1`` form (full precision at small alphas)."""
    return -torch.expm1(-F.softplus(density + shift) * interval)


def alpha2weight_dense_bidir(alpha, valid, forward):
    """Compositing weights for rows that march in either direction.

    alpha, valid: [N, S] in slab order; forward: [N] bool (True = row
    marches left to right). A sample is live while the transmittance
    entering it is >= T_TERMINATE. Returns (weights [N, S], alphainv_last
    [N], live & valid [N, S]).
    """
    alpha_m = torch.where(valid, alpha, torch.zeros_like(alpha))
    one_minus = torch.where(valid, 1.0 - alpha_m + T_EPS,
                            torch.ones_like(alpha))
    ones = torch.ones_like(one_minus[..., :1])
    t_excl_f = torch.cumprod(torch.cat([ones, one_minus[..., :-1]], -1), -1)
    t_excl_b = torch.cumprod(
        torch.cat([one_minus[..., 1:], ones], -1).flip(-1), -1).flip(-1)
    t_excl = torch.where(forward[:, None], t_excl_f, t_excl_b)
    live = t_excl >= T_TERMINATE
    weights = torch.where(valid & live, t_excl * alpha_m,
                          torch.zeros_like(alpha))
    alphainv_last = torch.where(live, one_minus,
                                torch.ones_like(one_minus)).prod(-1)
    return weights, alphainv_last, live & valid
