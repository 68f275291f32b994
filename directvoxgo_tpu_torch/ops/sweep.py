"""Station-sweep grid queries, forward and backward.

Samples sit on *stations*: planes at axis coordinate ``s/k`` perpendicular
to a ray batch's dominant axis. A station between two grid slabs is the
linear blend of the two, so a bilinear tap of a station slab equals a
trilinear sample of the grid. The taps themselves are kernel K-A
(:mod:`.sweep_fwd`); their transpose onto the grid, the backward of
:func:`station_sweep`, is kernel K-C (:mod:`.sweep_bwd`).
"""

from __future__ import annotations

import numpy as np
import torch

from .grid import DeviceBox
from .sweep_bwd import sweep_bwd
from .sweep_fwd import TILE_N, sweep_fwd

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


def _pack_rays(rays_pv):
    """((op, ou, ov), (dp, du, dv)) -> (rays [6, N] with ``dp`` nonzero,
    op, dp_safe)."""
    (op, ou, ov), (dp, du, dv) = rays_pv
    dp_safe = torch.where(dp == 0, torch.full_like(dp, 1e-10), dp)
    return torch.stack([op, ou, ov, dp_safe, du, dv]).contiguous(), op, \
        dp_safe


def _station_t(op, dp_safe, s_total, k):
    p_stations = torch.arange(s_total, dtype=torch.float32,
                              device=op.device) / k
    return (p_stations[None, :] - op[:, None]) / dp_safe[:, None]


def station_sweep_slabs(slabs, rays_pv, k):
    """Every station of every ray from prebuilt station slabs (the render
    path: no gradient). slabs: contiguous [S, Gu, Gv, C]
    (:func:`_station_slabs`) -> (vals [C, N, S] f32 in slab order,
    t [N, S])."""
    rays, op, dp_safe = _pack_rays(rays_pv)
    vals = sweep_fwd(slabs, rays, k)                     # [S, C, N]
    return vals.permute(1, 2, 0), _station_t(op, dp_safe, slabs.shape[0], k)


class _StationSweep(torch.autograd.Function):
    """K-A forward, K-C backward, over the permuted grid. The backward
    hands the (1-f)/f split straight to the two grid slabs (it does not
    differentiate through the rounding of the blended station slab) and
    returns the cotangent in the grid's dtype; rays and windows get no
    gradient."""

    @staticmethod
    def forward(ctx, grid_perm, rays, v_base, k, wv, grid_f32=None):
        slabs = _station_slabs(grid_perm, k).contiguous()
        n = rays.shape[1]
        # The forward kernel wants per-tile starts only; a trailing
        # batch-level entry (segment convention) is for the backward.
        fwd_vb = v_base[: -(-n // TILE_N)] if wv else None
        vals = sweep_fwd(slabs, rays, k, fwd_vb, wv)     # [S, C, N]
        ctx.save_for_backward(rays, v_base)
        ctx.sweep = (tuple(grid_perm.shape), grid_perm.dtype, k, wv,
                     grid_f32 is not None)
        return vals.permute(1, 2, 0)

    @staticmethod
    def backward(ctx, g_vals):
        rays, v_base = ctx.saved_tensors
        shape, dtype, k, wv, to_f32 = ctx.sweep
        # K-C reads the cotangent through its strides: autograd's [C, N, S]
        # layout goes to the kernel as it is, without a copy.
        g = g_vals.permute(2, 0, 1)
        d_grid = sweep_bwd(g, rays, k, shape, dtype, v_base, wv,
                           out_dtype=torch.float32 if to_f32 else None)
        if to_f32:
            return None, None, None, None, None, d_grid
        return d_grid, None, None, None, None, None


def station_sweep(grid_perm, rays_pv, k, v_base=None, wv=0, grid_f32=None):
    """Sample every station along each ray, differentiably in the grid.

    grid_perm: [Gp, Gu, Gv, C] permuted grid slabs (:func:`permute_grid`)
    in the sweep's interp dtype. ``v_base``/``wv``: per-ray-tile v-windows
    ([N // TILE_N] int32 starts; one more entry, the batch's window, in the
    segment convention) - exact when every ray of a tile keeps its v
    support inside the tile's window. ``grid_f32``: the same slabs in f32
    storage (a view); the cotangent then goes to it, unrounded, and not to
    ``grid_perm``. Returns (vals [C, N, S] f32 in slab order, t [N, S] (no
    gradient))."""
    rays, op, dp_safe = _pack_rays(rays_pv)
    if v_base is None or not wv:
        v_base, wv = torch.zeros(0, dtype=torch.int32, device=rays.device), 0
    vals = _StationSweep.apply(grid_perm, rays.detach(), v_base, int(k),
                               int(wv), grid_f32)
    s_total = k * (grid_perm.shape[0] - 1) + 1
    return vals, _station_t(op, dp_safe, s_total, k).detach()


def sweep_samples(grid, rays_o, rays_d, xyz_min, xyz_max, axis, k,
                  interp_dtype=torch.bfloat16, clip_sizes=None,
                  clip_offsets=None, pre_clipped=False, world_size=None,
                  tile_windows=None, slabs=None, f32_cot=False):
    """Density/mask/feature channels at every station of every ray, in slab
    order (the caller composites bidirectionally).

    grid: [Gx, Gy, Gz, C] channels-last stacked grids (density, mask as
    float, colour features), differentiable; ``k`` stations per voxel.
    ``clip_sizes`` ((p, u, v) extents, permuted order) and ``clip_offsets``
    ([3] ints, or an integer tensor on the rays' device) restrict the sweep to the occupancy box: samples outside it
    read zero, exact because the box bounds everything with interpolated
    mask > 0. ``pre_clipped``: ``grid`` is already the box (gradients stay
    box-sized); ``world_size`` is then the full grid's extents, for the
    world -> voxel scale. ``tile_windows`` (v_base, wv): per-ray-tile
    v-windows, only for unclipped sweeps whose ray count tiles.
    ``slabs``: prebuilt station slabs of the (clipped) grid - the render
    path's cache; no gradient flows and ``grid`` is not read.
    ``f32_cot``: ``grid``'s values are already rounded to ``interp_dtype``
    in f32 storage (:func:`.rounding.to_dtype`), and its cotangent comes
    back in f32, unrounded.

    Returns dict: vals [C, N, S], t [N, S], forward [N] (True where t
    ascends with the station index), interval [N] (world distance between
    consecutive stations), p_offset (the sweep-axis voxel of station 0, the
    clip box's start, a float; a 0-d tensor for tensor offsets; 0
    unclipped).
    """
    if world_size is None:
        world_size = grid.shape[:3]
    o_pv, d_pv = rays_to_voxel(rays_o, rays_d, xyz_min, xyz_max,
                               world_size, axis)
    p_offset = 0.0
    if clip_sizes is not None and torch.is_tensor(clip_offsets):
        # offsets as device data (a train step, whose CUDA graph must read
        # each replay's): the box through its flat voxel indices
        offs_f = clip_offsets.to(torch.float32)
        if slabs is None and not pre_clipped:
            inv = {ax: i for i, ax in enumerate(_PERMS[axis])}
            grid = DeviceBox(clip_offsets, tuple(
                int(clip_sizes[inv[a]]) for a in range(3)),
                grid.shape[:3], _PERMS[axis]).take(grid)
        o_pv = tuple(o - offs_f[i] for i, o in enumerate(o_pv))
        p_offset = offs_f[0]
    elif clip_sizes is not None:
        offs = [int(v) for v in np.asarray(clip_offsets)]
        if slabs is None and not pre_clipped:
            inv = {ax: i for i, ax in enumerate(_PERMS[axis])}
            grid = grid[tuple(slice(offs[inv[a]], offs[inv[a]]
                                    + int(clip_sizes[inv[a]]))
                              for a in range(3))]
        o_pv = tuple(o - float(off) for o, off in zip(o_pv, offs))
        p_offset = float(offs[0])
    if slabs is not None:
        vals, t = station_sweep_slabs(slabs, (o_pv, d_pv), k)
    else:
        grid_f32 = None
        if (f32_cot and grid.requires_grad
                and grid.dtype != interp_dtype):
            grid_f32 = grid.permute(*_PERMS[axis], 3)
            grid = grid.detach()
        grid_perm = permute_grid(grid, axis, dtype=interp_dtype)
        v_base, wv = None, 0
        if tile_windows is not None and clip_sizes is None:
            v_base, wv = tile_windows
            wv = int(wv)
            n = rays_o.shape[0]
            if (wv >= grid_perm.shape[2] or n % TILE_N
                    or v_base.shape[0] not in (n // TILE_N,
                                               n // TILE_N + 1)):
                v_base, wv = None, 0
        vals, t = station_sweep(grid_perm, (o_pv, d_pv), k, v_base, wv,
                                grid_f32)
    forward = d_pv[0] >= 0
    d_norm = torch.sqrt(torch.sum(rays_d * rays_d, -1))
    interval = d_norm / (k * torch.clamp(d_pv[0].abs(), min=1e-10))
    return {"vals": vals, "t": t, "forward": forward, "interval": interval,
            "p_offset": p_offset}


def sweep_samples_blocked(grid, rays_o, rays_d, xyz_min, xyz_max, axis, k,
                          block_sizes, u_off, v_off,
                          interp_dtype=torch.bfloat16, f32_cot=False):
    """Blocked sweep: B composed clip-box sub-sweeps, concatenated along S.

    The station range is split into the p-blocks of
    :func:`blocked_p_rows`; block b sweeps only the (rows_b + 1, Wu, Wv)
    sub-box at its (u, v) offsets ``u_off[b]``, ``v_off[b]`` (ints, from
    :func:`build_ray_segments_blocked`, or integer tensors on the rays'
    device, read as device data), one K-A launch forward and one
    K-C launch backward each. ``block_sizes`` = (B, wu, wv); 0 means the
    full extent. Returns the dict of :func:`sweep_samples`, with each
    non-final block's boundary station dropped, so that the stations tile
    [0, Gp-1] exactly once.
    """
    n_blocks, wu_w, wv_w = (int(x) for x in block_sizes)
    perm = _PERMS[axis]
    gp, gu, gv = (int(grid.shape[a]) for a in perm)
    eu, ev = wu_w or gu, wv_w or gv
    rows = blocked_p_rows(gp, n_blocks)
    vals, ts = [], []
    for b, (r0, r1) in enumerate(rows):
        if torch.is_tensor(u_off):
            offs = torch.stack([torch.full_like(u_off[b], r0), u_off[b],
                                v_off[b]])
        else:
            offs = (r0, int(u_off[b]), int(v_off[b]))
        out = sweep_samples(
            grid, rays_o, rays_d, xyz_min, xyz_max, axis, k,
            interp_dtype=interp_dtype, clip_sizes=(r1 - r0 + 1, eu, ev),
            clip_offsets=offs, f32_cot=f32_cot)
        last = b == len(rows) - 1
        vals.append(out["vals"] if last else out["vals"][:, :, :-1])
        ts.append(out["t"] if last else out["t"][:, :-1])
    return {"vals": torch.cat(vals, 2), "t": torch.cat(ts, 1),
            "forward": out["forward"], "interval": out["interval"],
            "p_offset": 0.0}


def dominant_axis(rays_d, xyz_min, xyz_max, world_size):
    """Per-ray dominant axis in voxel space (host-side grouping helper)."""
    rays_d = np.asarray(rays_d)
    scale = (np.asarray(world_size) - 1.0) / (
        np.asarray(xyz_max, np.float64) - np.asarray(xyz_min, np.float64))
    return np.argmax(np.abs(rays_d * scale), axis=-1)


def sweep_axes(model, rays_d):
    """[N] sweep axis of each ray of ``model``: its ``forced_sweep_axis``
    for every ray (MPI grids: z), else each ray's dominant axis."""
    forced = getattr(model, "forced_sweep_axis", None)
    if forced is not None:
        return np.full(np.shape(rays_d)[0], forced, np.int64)
    return dominant_axis(rays_d, model.xyz_min, model.xyz_max,
                         model.world_size)


def _round_up(x, m):
    return (int(x) + m - 1) // m * m


# Guard band (voxels) added to host-computed segment supports before the
# floor: rays made on the device may differ from the host's in the last
# ulp, and a support sitting exactly on an integer would otherwise floor
# one voxel tighter than the device rays' true support.
SEG_GUARD = 1e-3


def _voxel_rays_np(rays_o, rays_d, xyz_min, xyz_max, world_size, axis):
    """:func:`rays_to_voxel` on numpy rays -> ((op, ou, ov), (dp, du, dv),
    (gp, gu, gv), dp with its near-zeros replaced by 1e-10)."""
    world_size = tuple(int(x) for x in world_size)
    o_pv, d_pv = rays_to_voxel(np.asarray(rays_o), np.asarray(rays_d),
                               xyz_min, xyz_max, world_size, axis)
    dp = d_pv[0]
    return (o_pv, d_pv, tuple(world_size[a] for a in _PERMS[axis]),
            np.where(np.abs(dp) < 1e-10, 1e-10, dp))


def _quant(x, g):
    return np.clip((x / max(g, 1) * 1024).astype(np.int64), 0, 1023)


def _spread_bits(stride):
    """[1024] int64: bit b of each 10-bit key moved to bit ``stride * b``."""
    keys = np.arange(1024, dtype=np.int64)
    out = np.zeros(1024, np.int64)
    for b in range(10):
        out |= ((keys >> b) & 1) << (b * stride)
    return out


_SPREAD2, _SPREAD4 = _spread_bits(2), _spread_bits(4)


def _morton4(keys):
    """Interleave four 10-bit keys into one int64 Morton code: bit b of
    ``keys[d]`` goes to bit 4b + d (by table, one lookup per key)."""
    code = _SPREAD4[keys[0]]
    for d_i, kk in enumerate(keys[1:], 1):
        code = code | (_SPREAD4[kk] << d_i)
    return code


def _support(ends, g, idx):
    """Inclusive voxel rows [r0, r1] that cover every interp row of the
    rays ``idx`` [n_seg, n] (per segment) whose coordinate runs between
    the two ``ends``."""
    lo = np.maximum(0, np.floor(np.minimum(ends[0], ends[1]) - SEG_GUARD))
    hi = np.minimum(g - 1, np.floor(np.maximum(ends[0], ends[1])
                                    + SEG_GUARD) + 1)
    return (lo[idx].min(1).astype(np.int64),
            hi[idx].max(1).astype(np.int64))


def _window_classes(idx, u0, u1, v0, v1, gu, gv, widths, max_classes):
    """Class the segments ``idx`` [n_seg, n] by the (wu, wv) window their
    support [u0, u1] x [v0, v1] needs (per segment, or per segment and
    block when the bounds are [n_seg, B]): the narrowest of ``widths``
    below the extent, 0 for the full extent. The ``max_classes`` most
    populous classes are kept; each segment goes to the tightest kept
    class that covers it, the rest to the ``(0, 0)`` key. Returns
    ``{(wu, wv): (idx, u_off, v_off)}``, offsets int32 and clamped to
    [0, G - W]."""
    def fit(need, g):
        out = np.zeros(need.shape, np.int64)
        for w in sorted((w for w in widths if w < g), reverse=True):
            out = np.where(need <= w, w, out)
        return out

    need_u, need_v = u1 - u0 + 1, v1 - v0 + 1
    if need_u.ndim == 2:                       # the widest block decides
        need_u, need_v = need_u.max(1), need_v.max(1)
    wu_min, wv_min = fit(need_u, gu), fit(need_v, gv)
    pairs = {}
    for s in range(idx.shape[0]):
        if wu_min[s] or wv_min[s]:
            key = (int(wu_min[s]), int(wv_min[s]))
            pairs[key] = pairs.get(key, 0) + 1
    kept = sorted(pairs, key=lambda p: -pairs[p])[:max_classes]
    out = {}
    assigned = np.zeros(idx.shape[0], bool)
    # tightest covers claim their segments first
    for wu, wv in sorted(kept, key=lambda p: ((p[0] or 1 << 20)
                                              * (p[1] or 1 << 20))):
        ok = ~assigned
        if wu:
            ok &= (wu_min != 0) & (wu_min <= wu)
        if wv:
            ok &= (wv_min != 0) & (wv_min <= wv)
        sel = np.flatnonzero(ok)
        if not sel.size:
            continue
        assigned[sel] = True
        offs = [np.zeros(lo[sel].shape, np.int32) if w == 0
                else np.minimum(lo[sel], g - w).astype(np.int32)
                for lo, w, g in ((u0, wu, gu), (v0, wv, gv))]
        out[(int(wu), int(wv))] = (idx[sel], *offs)
    rest = np.flatnonzero(~assigned)
    if rest.size:
        zeros = np.zeros(u0[rest].shape, np.int32)
        out[(0, 0)] = (idx[rest], zeros, zeros.copy())
    return out


def _box_bounds(clip_box, gp, gu, gv):
    """(p_lo, p_hi, u_lo, u_hi, v_lo, v_hi) of a ``clip_box`` (p_lo, p_hi)
    or (p_lo, p_hi, u_lo, u_hi, v_lo, v_hi), inclusive voxel bounds in
    permuted order; unbounded dims get the interp support [-1, G]."""
    p_lo, p_hi = (0.0, gp - 1.0) if clip_box is None \
        else (float(clip_box[0]), float(clip_box[1]))
    u_lo, u_hi, v_lo, v_hi = (-1.0, float(gu), -1.0, float(gv)) \
        if clip_box is None or len(clip_box) < 6 \
        else tuple(float(x) for x in clip_box[2:6])
    return p_lo, p_hi, u_lo, u_hi, v_lo, v_hi


def build_tile_buckets(rays_o, rays_d, xyz_min, xyz_max, world_size, axis,
                       tile_n=TILE_N, widths=(32, 64, 96)):
    """Spatially bucketed ``tile_n``-ray tiles for per-tile v-windows.

    The rays, sorted by a 4D Morton key of their (u, v) at the first and
    last sweep planes, are cut into tiles; a tile's v-window covers its
    rays' support at every station (u and v are linear in the plane
    coordinate, so the clipped end planes bound it) plus 7 rows for the
    8-alignment of the window start.

    Returns ``{W: (idx [n_b, tile_n] int64, vlo [n_b] int32)}`` per width
    class, ``0`` for tiles no class covers; ``idx`` indexes these rays.
    """
    n_tiles = rays_o.shape[0] // tile_n
    if n_tiles == 0:
        return {}
    (op, ou, ov), (dp, du, dv), (gp, gu, gv), dp_s = _voxel_rays_np(
        rays_o, rays_d, xyz_min, xyz_max, world_size, axis)
    t0 = (0.0 - op) / dp_s
    t1 = (gp - 1.0 - op) / dp_s
    u_ends = np.clip(np.stack([ou + t0 * du, ou + t1 * du]), -1.0, gu)
    v_ends = np.clip(np.stack([ov + t0 * dv, ov + t1 * dv]), -1.0, gv)
    code = _morton4([_quant(u_ends[0], gu), _quant(v_ends[0], gv),
                     _quant(u_ends[1], gu), _quant(v_ends[1], gv)])
    order = np.argsort(code, kind="stable")
    idx = order[: n_tiles * tile_n].reshape(n_tiles, tile_n)
    r0, r1 = _support(v_ends, gv, idx)
    needed = (r1 - r0 + 1) + 7
    gv_p8 = _round_up(gv, 8)
    out = {}
    assigned = np.full(n_tiles, -1, np.int64)
    for w in sorted(widths):
        if w >= gv:
            continue
        sel_t = np.flatnonzero((assigned < 0) & (needed <= w))
        if len(sel_t) == 0:
            continue
        assigned[sel_t] = w
        vlo = np.minimum((r0[sel_t] // 8 * 8).astype(np.int32),
                         gv_p8 - w).astype(np.int32)
        out[int(w)] = (idx[sel_t], vlo)
    rest = np.flatnonzero(assigned < 0)
    if len(rest):
        out[0] = (idx[rest], np.zeros(len(rest), np.int32))
    return out


def build_ray_segments(rays_o, rays_d, xyz_min, xyz_max, world_size, axis,
                       n_rand=8192, tile_n=TILE_N,
                       widths=(32, 48, 64, 96), clip_box=None):
    """Spatially sorted ray segments with a v-window each.

    Each draw unit is one batch, ``n_rand`` consecutive rays of a
    v-endpoint-major Morton order (u bits as a low tiebreak), so all of a
    batch's tiles share one segment-level v-window. ``clip_box`` ((p_lo,
    p_hi, v_lo, v_hi), inclusive voxel bounds in permuted order) measures
    the supports over the occupancy box: outside it every contribution is
    zero, so a window that covers support and box stays exact.

    Returns ``{W: (idx [n_seg, n_rand], seg_vlo [n_seg] int32, tile_vlo
    [n_seg, n_rand // tile_n] int32)}``; ``W = 0`` is the full sweep.
    """
    n = rays_o.shape[0]
    n_seg = n // n_rand
    if n_seg == 0:
        return {}
    n_tile = n_rand // tile_n
    (op, ou, ov), (dp, du, dv), (gp, gu, gv), dp_s = _voxel_rays_np(
        rays_o, rays_d, xyz_min, xyz_max, world_size, axis)
    p_lo, p_hi, v_lo, v_hi = (0.0, gp - 1.0, -1.0, float(gv)) \
        if clip_box is None else tuple(float(x) for x in clip_box)
    t0 = (p_lo - op) / dp_s
    t1 = (p_hi - op) / dp_s
    v_ends = np.clip(np.stack([ov + t0 * dv, ov + t1 * dv]), v_lo, v_hi)
    u_ends = np.clip(np.stack([ou + t0 * du, ou + t1 * du]), -1.0, gu)
    code = _SPREAD2[_quant(v_ends[0], gv)] \
        | (_SPREAD2[_quant(v_ends[1], gv)] << 1)
    code = (code << 10) | ((_quant(u_ends[0], gu) >> 5) << 5) \
        | (_quant(u_ends[1], gu) >> 5)
    order = np.argsort(code, kind="stable")
    idx = order[: n_seg * n_rand].reshape(n_seg, n_rand)
    r0_t, r1_t = _support(v_ends, gv, idx.reshape(n_seg * n_tile, tile_n))
    r0_t, r1_t = r0_t.reshape(n_seg, n_tile), r1_t.reshape(n_seg, n_tile)
    r0_s, r1_s = r0_t.min(1), r1_t.max(1)
    needed = (r1_s - r0_s + 1) + 7     # forward window starts are 8-aligned
    gv_p8 = _round_up(gv, 8)
    out = {}
    assigned = np.full(n_seg, -1, np.int64)
    for w in sorted(widths):
        if w >= gv:
            continue
        sel_s = np.flatnonzero((assigned < 0) & (needed <= w))
        if len(sel_s) == 0:
            continue
        assigned[sel_s] = w
        seg_vlo = np.minimum(r0_s[sel_s] // 8 * 8, gv_p8 - w).astype(np.int32)
        tile_vlo = np.minimum(r0_t[sel_s] // 8 * 8,
                              gv_p8 - w).astype(np.int32)
        out[int(w)] = (idx[sel_s], seg_vlo, tile_vlo)
    rest = np.flatnonzero(assigned < 0)
    if len(rest):
        out[0] = (idx[rest], np.zeros(len(rest), np.int32),
                  np.zeros((len(rest), n_tile), np.int32))
    return out


def build_ray_segments_2d(rays_o, rays_d, xyz_min, xyz_max, world_size,
                          axis, n_rand=4096, widths=(32, 64, 96, 128),
                          max_classes=4, clip_box=None):
    """Spatially sorted ray segments with both in-plane dims windowed.

    A segment is ``n_rand`` consecutive rays of a 4-endpoint Morton order
    ((u, v) at both clip planes: endpoint agreement is direction
    agreement), so forward-facing segments are image tiles and
    perspective ones per-view bundles, with compact (u, v) footprints
    across every station. A segment trains as the composed clip box (gp,
    Wu, Wv) at its offsets: every interp row of its rays lies inside
    (endpoint-bounded supports, one voxel of interp margin). ``clip_box``:
    (p_lo, p_hi) or (p_lo, p_hi, u_lo, u_hi, v_lo, v_hi), inclusive voxel
    bounds in permuted order; supports are measured inside it (outside,
    the interpolated mask is zero).

    Returns ``{(wu, wv): (idx [n_seg, n_rand], seg_ulo [n_seg], seg_vlo
    [n_seg])}``: a 0 slot means the full extent of that dim, ``(0, 0)`` is
    the full-sweep fallback; at most ``max_classes`` window classes.
    """
    n_seg = rays_o.shape[0] // n_rand
    if n_seg == 0:
        return {}
    (op, ou, ov), (dp, du, dv), (gp, gu, gv), dp_s = _voxel_rays_np(
        rays_o, rays_d, xyz_min, xyz_max, world_size, axis)
    p_lo, p_hi, u_lo, u_hi, v_lo, v_hi = _box_bounds(clip_box, gp, gu, gv)
    t0 = (p_lo - op) / dp_s
    t1 = (p_hi - op) / dp_s
    u_ends = np.clip(np.stack([ou + t0 * du, ou + t1 * du]), u_lo, u_hi)
    v_ends = np.clip(np.stack([ov + t0 * dv, ov + t1 * dv]), v_lo, v_hi)
    code = _morton4([_quant(u_ends[0], gu), _quant(v_ends[0], gv),
                     _quant(u_ends[1], gu), _quant(v_ends[1], gv)])
    order = np.argsort(code, kind="stable")
    idx = order[: n_seg * n_rand].reshape(n_seg, n_rand)
    u0, u1 = _support(u_ends, gu, idx)
    v0, v1 = _support(v_ends, gv, idx)
    return _window_classes(idx, u0, u1, v0, v1, gu, gv, widths, max_classes)


def blocked_p_rows(gp, n_blocks):
    """Slab-row ranges of a blocked sweep: block b covers rows [b*pb,
    min((b+1)*pb, gp-1)] inclusive, pb = ceil((gp-1)/B). Neighbouring
    blocks share their boundary row; the sweep drops each non-final
    block's last station, so the stations tile [0, gp-1] exactly once."""
    pb = max(1, -(-(gp - 1) // max(1, n_blocks)))
    rows = []
    r = 0
    while r < gp - 1:
        rows.append((r, min(r + pb, gp - 1)))
        r += pb
    return rows


def build_ray_segments_blocked(rays_o, rays_d, xyz_min, xyz_max, world_size,
                               axis, n_rand=8192, n_blocks=6,
                               widths=(32, 48, 64, 96), max_classes=6,
                               clip_box=None):
    """Spatially sorted ray segments with one (u, v) window per p-block.

    As :func:`build_ray_segments_2d`, but the traversal is split into the
    p-blocks of :func:`blocked_p_rows`: a perspective ray drifts across
    the plane over the whole traversal, much less within a block. Each
    segment trains as B composed clip boxes concatenated along the station
    axis (:func:`sweep_samples_blocked`); per block, a ray's range is
    bounded by its values at the block's edge planes (clamped to the
    interp support and, with ``clip_box``, the occupancy box).

    Returns ``{(wu, wv): (idx [n_seg, n_rand], u_off [n_seg, B] int32,
    v_off [n_seg, B] int32)}``: (wu, wv) are the per-block window extents
    (0 = full extent; ``(0, 0)`` = the unblocked fallback, zero offsets).
    """
    n_seg = rays_o.shape[0] // n_rand
    if n_seg == 0:
        return {}
    (op, ou, ov), (dp, du, dv), (gp, gu, gv), dp_s = _voxel_rays_np(
        rays_o, rays_d, xyz_min, xyz_max, world_size, axis)
    p_lo, p_hi, u_lo, u_hi, v_lo, v_hi = _box_bounds(clip_box, gp, gu, gv)

    def ends_at(p_a, p_b):
        ta, tb = (p_a - op) / dp_s, (p_b - op) / dp_s
        return (np.clip(np.stack([ou + ta * du, ou + tb * du]), u_lo, u_hi),
                np.clip(np.stack([ov + ta * dv, ov + tb * dv]), v_lo, v_hi))

    u_ends, v_ends = ends_at(p_lo, p_hi)
    code = _morton4([_quant(u_ends[0], gu), _quant(v_ends[0], gv),
                     _quant(u_ends[1], gu), _quant(v_ends[1], gv)])
    order = np.argsort(code, kind="stable")
    idx = order[: n_seg * n_rand].reshape(n_seg, n_rand)
    bounds = [[], [], [], []]
    for r0, r1 in blocked_p_rows(gp, n_blocks):
        ub, vb = ends_at(float(r0), float(r1))
        for lst, x in zip(bounds, (*_support(ub, gu, idx),
                                   *_support(vb, gv, idx))):
            lst.append(x)
    u0, u1, v0, v1 = (np.stack(b, 1) for b in bounds)    # [n_seg, B]
    return _window_classes(idx, u0, u1, v0, v1, gu, gv, widths, max_classes)


def build_ray_tiles_blocktile(rays_o, rays_d, xyz_min, xyz_max,
                              world_size, axis, near, far, stepsize,
                              nt=512, s_blk=8,
                              widths_u=(32, 48, 64, 80, 96, 112, 128),
                              widths_v=(16, 24, 32, 40, 48, 56, 64, 80,
                                        96),
                              max_classes=4, clip_box=None, margin=0.5):
    """Direction-uniform ``nt``-ray tiles, classed by the (u, v) window
    that the fused train kernels (:mod:`.train_fused`) need per cell.

    A cell is one (``s_blk``-station block, ray tile) pair; the fused step
    reads, per cell, only a ``(wu, wv)`` window of the station slabs
    (:func:`.train_fused.blocktile_uv_bases`). One wide tile would widen
    the window of a whole batch, so batches regroup tiles of one class: the
    pool, sorted by the Morton code of each ray's two end points on the
    box, is cut into tiles; a tile's class is the widest support any of
    its cells needs; the engine draws a batch as ``N_rand / nt`` rows of
    one class and one sweep direction.

    The arithmetic mirrors :func:`.train_fused.blocktile_uv_bases` (bases
    aligned to 16 in u and 8 in v, one voxel of hat support, the [t_lo,
    t_hi] clamp, the grid clip) with ``margin`` voxels of slack, so that
    f32 rounding on the device never makes a drawn cell exceed its class.
    t_lo/t_hi follow :func:`.raymarch.ray_aabb_tminmax`. ``clip_box``:
    inclusive (p_lo, p_hi[, u_lo, u_hi, v_lo, v_hi]) voxel bounds of the
    occupancy box the step's grids are sliced to.

    Returns ``{(wu, wv, sg): idx [n_tiles, nt] int64}`` with ``sg`` the
    sweep direction's sign (+1/-1) plus a ``(0, 0, 0)`` key for tiles that
    no kept class covers (the engine trains those through the unfused
    step). At most ``max_classes`` (wu, wv) pairs are kept; narrower
    classes fold into the kept ones that cover them.
    """
    n = rays_o.shape[0]
    if n < nt:
        return {}
    perm = _PERMS[axis]
    rays_o = np.asarray(rays_o, np.float64)
    rays_d = np.asarray(rays_d, np.float64)
    k = substeps_for_stepsize(stepsize)

    # t range per ray: numpy mirror of raymarch.ray_aabb_tminmax
    vec = np.where(rays_d == 0, 1e-6, rays_d)
    rate_a = (np.asarray(xyz_max, np.float64) - rays_o) / vec
    rate_b = (np.asarray(xyz_min, np.float64) - rays_o) / vec
    tlo = np.clip(np.minimum(rate_a, rate_b).max(-1), near, far)
    thi = np.clip(np.maximum(rate_a, rate_b).min(-1), near, far)

    opv, dpv = [], []
    for ax in perm:
        scale = (float(world_size[ax]) - 1.0) / (float(xyz_max[ax])
                                                 - float(xyz_min[ax]))
        opv.append((rays_o[:, ax] - float(xyz_min[ax])) * scale)
        dpv.append(rays_d[:, ax] * scale)
    op, ou, ov = opv
    dp, du, dv = dpv
    gu = int(world_size[perm[1]])
    gv = int(world_size[perm[2]])
    if clip_box is None:
        bp = int(world_size[perm[0]])
        off_p = off_u = off_v = 0.0
        u_hi_c, v_hi_c = float(gu), float(gv)
    else:
        off_p, p_hi = float(clip_box[0]), float(clip_box[1])
        bp = int(round(p_hi - off_p)) + 1
        if len(clip_box) >= 6:
            off_u, u_hi_c = float(clip_box[2]), float(clip_box[3]) + 1.0
            off_v, v_hi_c = float(clip_box[4]), float(clip_box[5]) + 1.0
        else:
            off_u = off_v = 0.0
            u_hi_c, v_hi_c = float(gu), float(gv)
    # box frame (the fused path's grids arrive pre-clipped; rays shifted)
    op = op - off_p
    ou = ou - off_u
    ov = ov - off_v
    bu = int(round(u_hi_c - off_u))
    bv = int(round(v_hi_c - off_v))
    gu_p = _round_up(bu, 16)
    gv_p = _round_up(bv, 8)
    dp_s = np.where(np.abs(dp) < 1e-10, 1e-10, dp)

    # 4-endpoint Morton sort per direction sign (fused batches must be
    # direction-uniform: the kernels march with one (p0, pstep))
    t0e = (0.0 - op) / dp_s
    t1e = (bp - 1.0 - op) / dp_s
    u_ends = np.clip(np.stack([ou + t0e * du, ou + t1e * du]), 0, bu)
    v_ends = np.clip(np.stack([ov + t0e * dv, ov + t1e * dv]), 0, bv)

    code = _morton4([_quant(u_ends[0], bu), _quant(v_ends[0], bv),
                     _quant(u_ends[1], bu), _quant(v_ends[1], bv)])

    s_total = k * (bp - 1) + 1
    s_pad = _round_up(s_total, s_blk)
    nsb = s_pad // s_blk
    inv_k = 1.0 / k
    p_a = (np.arange(nsb, dtype=np.float64) * s_blk * inv_k)[:, None]
    p_b = p_a + (s_blk - 1) * inv_k

    tiles_by = {}
    for sg in (1, -1):
        pool = np.flatnonzero((dp >= 0) if sg > 0 else (dp < 0))
        if pool.size < nt:
            continue
        order = pool[np.argsort(code[pool], kind="stable")]
        n_tiles = order.size // nt
        idx = order[: n_tiles * nt].reshape(n_tiles, nt)
        # per-(block, tile) cell needs; loop tiles in chunks to bound mem
        need_u = np.zeros(n_tiles, np.int64)
        need_v = np.zeros(n_tiles, np.int64)
        chunk = max(1, (1 << 22) // (nsb * nt))
        for c0 in range(0, n_tiles, chunk):
            sel = idx[c0: c0 + chunk].ravel()
            ta = (p_a - op[sel][None, :]) / dp_s[sel][None, :]
            tb = (p_b - op[sel][None, :]) / dp_s[sel][None, :]
            lo_t = np.maximum(np.minimum(ta, tb), tlo[sel][None, :])
            hi_t = np.minimum(np.maximum(ta, tb), thi[sel][None, :])
            act = hi_t >= lo_t - 1e-4     # conservative vs the f32 kernel

            def cell_need(o_c, d_c, g_pad, align):
                a = o_c[sel][None, :] + lo_t * d_c[sel][None, :]
                b2 = o_c[sel][None, :] + hi_t * d_c[sel][None, :]
                lo = np.where(act, np.minimum(a, b2) - 1.0 - margin,
                              np.inf)
                hi = np.where(act, np.maximum(a, b2) + 1.0 + margin,
                              -np.inf)
                lo = np.clip(lo, 0.0, float(g_pad))
                hi = np.clip(hi, 0.0, float(g_pad))
                nc = lo.shape[1] // nt
                lo = lo.reshape(nsb, nc, nt).min(-1)
                hi = hi.reshape(nsb, nc, nt).max(-1)
                need = np.ceil(hi) - (np.floor(lo).astype(np.int64)
                                      // align) * align
                return need.max(0).astype(np.int64)  # max over blocks

            nc_ = sel.size // nt
            need_u[c0: c0 + nc_] = cell_need(ou, du, gu_p, 16)
            need_v[c0: c0 + nc_] = cell_need(ov, dv, gv_p, 8)
        tiles_by[sg] = (idx, need_u, need_v)

    def fit(need, widths, g_pad):
        # g_pad itself is the terminal class: full extent in THIS axis is
        # still a valid fused window when the other axis stays narrow
        # (the kernel treats w >= extent as unwindowed for that dim,
        # train_fused._window_plan), and need <= g_pad always (the
        # cell ranges are grid-clipped), so nothing is left classless.
        ws = [w for w in sorted(widths) if w < g_pad] + [g_pad]
        out = np.zeros(len(need), np.int64)
        for i, nd in enumerate(need):
            out[i] = next(w for w in ws if nd <= w)
        return out

    # candidate classes from both sign pools, kept by ray count, tiles
    # assigned smallest-fitting-kept-cover first
    pair_count = {}
    fitted = {}
    for sg, (idx, nu, nv) in tiles_by.items():
        wu_min = fit(nu, widths_u, gu_p)
        wv_min = fit(nv, widths_v, gv_p)
        fitted[sg] = (wu_min, wv_min)
        for i in range(len(nu)):
            if wu_min[i] and wv_min[i]:
                key = (int(wu_min[i]), int(wv_min[i]))
                pair_count[key] = pair_count.get(key, 0) + 1
    kept = sorted(pair_count, key=lambda p: -pair_count[p])[:max_classes]
    out = {}
    rest_rows = []
    for sg, (idx, nu, nv) in tiles_by.items():
        wu_min, wv_min = fitted[sg]
        assigned = np.full(len(nu), False)
        for wu, wv in sorted(kept, key=lambda p: p[0] * p[1]):
            sel = np.flatnonzero(~assigned & (wu_min != 0)
                                 & (wu_min <= wu) & (wv_min != 0)
                                 & (wv_min <= wv))
            if sel.size == 0:
                continue
            assigned[sel] = True
            out[(int(wu), int(wv), sg)] = idx[sel]
        rest = np.flatnonzero(~assigned)
        if rest.size:
            rest_rows.append(idx[rest])
    if rest_rows:
        out[(0, 0, 0)] = np.concatenate(rest_rows, axis=0)
    return out


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
