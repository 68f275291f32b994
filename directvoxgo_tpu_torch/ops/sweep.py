"""Station-sweep grid queries (render subset, forward only).

Samples sit on *stations*: planes at axis coordinate ``s/k`` perpendicular
to a ray batch's dominant axis. A station between two grid slabs is the
linear blend of the two, so a bilinear tap of a station slab equals a
trilinear sample of the grid. The taps themselves are kernel K-A
(:mod:`.sweep_fwd`).
"""

from __future__ import annotations

import numpy as np
import torch

from .sweep_fwd import sweep_fwd

# Axis permutations: sweep axis first, remaining axes keep original order.
_PERMS = {0: (0, 1, 2), 1: (1, 0, 2), 2: (2, 0, 1)}


def substeps_for_stepsize(stepsize):
    """Stations per voxel along the sweep axis (stepsize 0.5 -> k=2)."""
    return max(int(round(1.0 / float(stepsize))), 1)


def permute_grid(grid, axis, dtype=torch.bfloat16):
    """[Gx, Gy, Gz, C] -> [Gp, Gu, Gv, C] slabs for a sweep along ``axis``
    (channel-minor; flattening the last two dims gives column v*C + c)."""
    perm = _PERMS[axis]
    return grid.permute(*perm, 3).to(dtype).contiguous()


def _station_slabs(grid_perm, k):
    """[Gp, ...] grid slabs -> [S, ...] station slabs, S = k*(Gp-1)+1:
    station z*k + j is ``(1-j/k)*slab[z] + (j/k)*slab[z+1]`` in the slab
    dtype."""
    gp = grid_perm.shape[0]
    if k == 1:
        return grid_perm
    parts = [grid_perm[:-1]]
    for j in range(1, k):
        f = j / k
        parts.append((1.0 - f) * grid_perm[:-1] + f * grid_perm[1:])
    inner = torch.stack(parts, 1).to(grid_perm.dtype)
    inner = inner.reshape((gp - 1) * k, *grid_perm.shape[1:])
    return torch.cat([inner, grid_perm[-1:]], 0)


def rays_to_voxel(rays_o, rays_d, xyz_min, xyz_max, world_size, axis):
    """World rays [N, 3] -> continuous voxel coordinates, permuted (p, u, v);
    the ray parameter t is unchanged."""
    perm = _PERMS[axis]
    o, d = [], []
    for ax in perm:
        scale = (world_size[ax] - 1.0) / (float(xyz_max[ax])
                                          - float(xyz_min[ax]))
        o.append((rays_o[:, ax] - float(xyz_min[ax])) * scale)
        d.append(rays_d[:, ax] * scale)
    return tuple(o), tuple(d)


def station_sweep(slabs, rays_pv, k):
    """Every station of every ray: contiguous station slabs [S, Gu, Gv, C]
    (:func:`_station_slabs`) -> (vals [C, N, S] f32 in slab order,
    t [N, S])."""
    (op, ou, ov), (dp, du, dv) = rays_pv
    dp_safe = torch.where(dp == 0, torch.full_like(dp, 1e-10), dp)
    rays = torch.stack([op, ou, ov, dp_safe, du, dv]).contiguous()
    vals = sweep_fwd(slabs, rays, k)                     # [S, C, N]
    s_total = slabs.shape[0]
    p_stations = torch.arange(s_total, dtype=torch.float32,
                              device=op.device) / k
    ts = (p_stations[None, :] - op[:, None]) / dp_safe[:, None]
    return vals.permute(1, 2, 0), ts


def sweep_samples(slabs, k, rays_o, rays_d, xyz_min, xyz_max, axis,
                  world_size, clip_offsets=None):
    """Density/mask/feature channels at every station of every ray.

    slabs: [S, Gu, Gv, C] station slabs of the grid's stacked channels
    permuted for ``axis`` (``_station_slabs(permute_grid(grid, axis), k)``),
    k stations per voxel. When the sweep is clipped to the occupancy bbox,
    the slabs cover only the box and ``clip_offsets`` is its start voxel
    ([3] ints, permuted order); ``world_size`` is the full grid's extents
    (for the world -> voxel scale).

    Returns dict: vals [C, N, S] (slab order), t [N, S], forward [N] (True
    where t ascends with the station index), interval [N] (world distance
    between consecutive stations).
    """
    o_pv, d_pv = rays_to_voxel(rays_o, rays_d, xyz_min, xyz_max,
                               world_size, axis)
    if clip_offsets is not None:
        o_pv = tuple(o - float(off)
                     for o, off in zip(o_pv, np.asarray(clip_offsets)))
    vals, t = station_sweep(slabs, (o_pv, d_pv), k)
    forward = d_pv[0] >= 0
    d_norm = torch.sqrt(torch.sum(rays_d * rays_d, -1))
    interval = d_norm / (k * torch.clamp(d_pv[0].abs(), min=1e-10))
    return {"vals": vals, "t": t, "forward": forward, "interval": interval}


def dominant_axis(rays_d, xyz_min, xyz_max, world_size):
    """Per-ray dominant axis in voxel space (host-side grouping helper)."""
    rays_d = np.asarray(rays_d)
    scale = (np.asarray(world_size) - 1.0) / (
        np.asarray(xyz_max, np.float64) - np.asarray(xyz_min, np.float64))
    return np.argmax(np.abs(rays_d * scale), axis=-1)


# Default gather style of topk_station_select. Both forms select exactly;
# "gather" avoids the [N, K, S] one-hot tensor (0.5 GB at an 8192-ray
# chunk of a 160^3 sweep).
COMPACT_GATHER = "gather"


def topk_station_select(w_eff, topk, gather_mode=None):
    """Per-ray top-K-by-weight station selectors (ties keep the lower
    station index first).

    Returns ``(idx [N, K], sel_nk, sel_cl)``: ``sel_nk`` maps [N, S] ->
    [N, K] and ``sel_cl`` maps channels-leading [C, N, S] -> [C, N, K].
    ``gather_mode`` "onehot" selects with one-hot [N, K, S] products,
    "gather" with index gathers; both are exact selections.
    """
    mode = gather_mode or COMPACT_GATHER
    s_total = w_eff.shape[1]
    idx = torch.sort(w_eff, dim=1, descending=True, stable=True)[1][:, :topk]
    if mode == "onehot":
        onehot = (idx[:, :, None] == torch.arange(
            s_total, device=w_eff.device)).to(torch.float32)

        def sel_nk(x):
            return torch.einsum("nks,ns->nk", onehot, x.float())

        def sel_cl(x):
            return torch.einsum("nks,cns->cnk", onehot, x.float())
    else:
        def sel_nk(x):
            return torch.gather(x, 1, idx)

        def sel_cl(x):
            return torch.gather(x, 2, idx[None].expand(x.shape[0], -1, -1))
    return idx, sel_nk, sel_cl
