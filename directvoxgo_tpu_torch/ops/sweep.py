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
    def forward(ctx, grid_perm, rays, v_base, k, wv):
        slabs = _station_slabs(grid_perm, k).contiguous()
        n = rays.shape[1]
        # The forward kernel wants per-tile starts only; a trailing
        # batch-level entry (segment convention) is for the backward.
        fwd_vb = v_base[: -(-n // TILE_N)] if wv else None
        vals = sweep_fwd(slabs, rays, k, fwd_vb, wv)     # [S, C, N]
        ctx.save_for_backward(rays, v_base)
        ctx.sweep = (tuple(grid_perm.shape), grid_perm.dtype, k, wv)
        return vals.permute(1, 2, 0)

    @staticmethod
    def backward(ctx, g_vals):
        rays, v_base = ctx.saved_tensors
        shape, dtype, k, wv = ctx.sweep
        # One layout for the kernel: [S, C, N] contiguous, as K-A writes
        # (a copy of the cotangent whatever strides autograd gave it).
        g = g_vals.permute(2, 0, 1).contiguous()
        d_grid = sweep_bwd(g, rays, k, shape, dtype, v_base, wv)
        return d_grid, None, None, None, None


def station_sweep(grid_perm, rays_pv, k, v_base=None, wv=0):
    """Sample every station along each ray, differentiably in the grid.

    grid_perm: [Gp, Gu, Gv, C] permuted grid slabs (:func:`permute_grid`)
    in the sweep's interp dtype. ``v_base``/``wv``: per-ray-tile v-windows
    ([N // TILE_N] int32 starts; one more entry, the batch's window, in the
    segment convention) - exact when every ray of a tile keeps its v
    support inside the tile's window. Returns (vals [C, N, S] f32 in slab
    order, t [N, S] (no gradient))."""
    rays, op, dp_safe = _pack_rays(rays_pv)
    if v_base is None or not wv:
        v_base, wv = torch.zeros(0, dtype=torch.int32, device=rays.device), 0
    vals = _StationSweep.apply(grid_perm, rays.detach(), v_base, int(k),
                               int(wv))
    s_total = k * (grid_perm.shape[0] - 1) + 1
    return vals, _station_t(op, dp_safe, s_total, k).detach()


def sweep_samples(grid, rays_o, rays_d, xyz_min, xyz_max, axis, k,
                  interp_dtype=torch.bfloat16, clip_sizes=None,
                  clip_offsets=None, pre_clipped=False, world_size=None,
                  tile_windows=None, slabs=None):
    """Density/mask/feature channels at every station of every ray, in slab
    order (the caller composites bidirectionally).

    grid: [Gx, Gy, Gz, C] channels-last stacked grids (density, mask as
    float, colour features), differentiable; ``k`` stations per voxel.
    ``clip_sizes`` ((p, u, v) extents, permuted order) and ``clip_offsets``
    ([3] ints) restrict the sweep to the occupancy box: samples outside it
    read zero, exact because the box bounds everything with interpolated
    mask > 0. ``pre_clipped``: ``grid`` is already the box (gradients stay
    box-sized); ``world_size`` is then the full grid's extents, for the
    world -> voxel scale. ``tile_windows`` (v_base, wv): per-ray-tile
    v-windows, only for unclipped sweeps whose ray count tiles.
    ``slabs``: prebuilt station slabs of the (clipped) grid - the render
    path's cache; no gradient flows and ``grid`` is not read.

    Returns dict: vals [C, N, S], t [N, S], forward [N] (True where t
    ascends with the station index), interval [N] (world distance between
    consecutive stations), p_offset (float: the sweep-axis voxel of station
    0, the clip box's start; 0 unclipped).
    """
    if world_size is None:
        world_size = grid.shape[:3]
    o_pv, d_pv = rays_to_voxel(rays_o, rays_d, xyz_min, xyz_max,
                               world_size, axis)
    p_offset = 0.0
    if clip_sizes is not None:
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
        vals, t = station_sweep(grid_perm, (o_pv, d_pv), k, v_base, wv)
    forward = d_pv[0] >= 0
    d_norm = torch.sqrt(torch.sum(rays_d * rays_d, -1))
    interval = d_norm / (k * torch.clamp(d_pv[0].abs(), min=1e-10))
    return {"vals": vals, "t": t, "forward": forward, "interval": interval,
            "p_offset": p_offset}


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

    def quant(x, g):
        return np.clip((x / max(g, 1) * 1024).astype(np.int64), 0, 1023)

    keys = [quant(u_ends[0], bu), quant(v_ends[0], bv),
            quant(u_ends[1], bu), quant(v_ends[1], bv)]
    code = np.zeros(n, np.int64)
    for b in range(10):
        for d_i, kk in enumerate(keys):
            code |= ((kk >> b) & 1) << (b * 4 + d_i)

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
