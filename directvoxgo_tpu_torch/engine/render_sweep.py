"""Camera-frame station-sweep renderer (separable shear-warp).

All rays of a camera frame share one centre of projection, so they are
parameterized by where they cross a reference plane perpendicular to the
frame's dominant voxel axis: a regular grid there is the *intermediate
image*, one ray per intermediate pixel. At station p_s the whole grid lands
on the slab by an axis-aligned scale and shift, which kernel K-B
(:mod:`..ops.render_frame`) exploits while it composites the stations front
to back. The composited intermediate image is then warped to the screen by
the single homography between the reference plane and the image plane.

Cameras whose rays disagree on the dominant axis, or whose corner rays run
too flat to it, are rejected by :func:`plan_camera_sweep`; the caller then
renders the view per ray (``engine/render.render_rays_chunked``).

A frame leaves as f32 numpy arrays, as device tensors, or shrunk on the
device for a display or encoder (:func:`frame_outputs`): uint8 rgb with
f16 depth, or a planar I420 buffer.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import mlp as mlp_lib
from ..ops import grid as grid_ops
from ..ops import sweep as sweep_ops
from ..ops.render_frame import S_BLK, TILE, render_frame

# Intermediate-image oversampling vs the screen pixel density, and the
# intermediate-shape quantum. Both set the intermediate image's size and
# pixel spacing, so changing either changes the picture.
OVERSAMPLE = 1.1
SHAPE_QUANTUM = 128
# Station-count quantum (padded with inert mask=0 slabs).
S_QUANTUM = 64
# Minimum |unit_d_axis| over the frame's corner rays: station spacing along
# a ray is stepsize/|unit_d_axis| voxels; flatter frames fall back to the
# per-ray path.
MIN_CORNER_UNIT_DP = 0.25


def _round_up(x, m):
    return int(np.ceil(x / m)) * m


def _active_bbox_vox(model):
    """Voxel bbox (padded by 1) of the occupancy mask, cached per mask."""
    cache = getattr(model, "_active_bbox_cache", None)
    if cache is not None and cache[0] is model.mask:
        return cache[1]
    box = grid_ops.mask_bbox_vox(model.mask)
    model._active_bbox_cache = (model.mask, box)
    return box


def _rays_at_pixels(H, W, K, c2w, pix_ji, inverse_y, flip_x, flip_y):
    """Ray directions (float64) at selected (row, col) pixel centres."""
    c2w = np.asarray(c2w, np.float64)
    K = np.asarray(K, np.float64)
    jj = np.asarray([p[0] for p in pix_ji], np.float64) + 0.5
    ii = np.asarray([p[1] for p in pix_ji], np.float64) + 0.5
    if flip_x:
        ii = W - ii
    if flip_y:
        jj = H - jj
    if inverse_y:
        dirs = np.stack([(ii - K[0][2]) / K[0][0],
                         (jj - K[1][2]) / K[1][1], np.ones_like(ii)], -1)
    else:
        dirs = np.stack([(ii - K[0][2]) / K[0][0],
                         -(jj - K[1][2]) / K[1][1], -np.ones_like(ii)], -1)
    return dirs @ c2w[:3, :3].T


def plan_camera_sweep(model, H, W, K, c2w, near, far, inverse_y=False,
                      flip_x=False, flip_y=False, stepsize=0.5):
    """Host-side geometry for one camera, or None when the separable sweep
    does not apply (rays disagree on the dominant axis or run too flat)."""
    pix = [(0, 0), (0, W - 1), (H - 1, 0), (H - 1, W - 1),
           (H // 2, W // 2), (H // 2, W // 2 + 1), (H // 2 + 1, W // 2)]
    d7 = _rays_at_pixels(H, W, K, c2w, pix, inverse_y, flip_x, flip_y)
    rays_o00 = np.asarray(c2w, np.float64)[:3, 3]
    ws = np.asarray(model.world_size, np.float64)
    scale = (ws - 1.0) / (np.asarray(model.xyz_max, np.float64)
                          - np.asarray(model.xyz_min, np.float64))
    d_vox_corners = d7[:4] * scale
    d_vox_center = d7[4] * scale
    axis = int(np.argmax(np.abs(d_vox_center)))
    dp = np.concatenate([d_vox_corners[:, axis:axis + 1].ravel(),
                         d_vox_center[axis:axis + 1]])
    if not ((dp > 1e-6).all() or (dp < -1e-6).all()):
        return None
    unit_dp = np.abs(d_vox_corners[:, axis]) / np.linalg.norm(
        d_vox_corners, axis=1)
    if unit_dp.min() < MIN_CORNER_UNIT_DP:
        return None

    perm = sweep_ops._PERMS[axis]
    o_vox = (rays_o00 - np.asarray(model.xyz_min)) * scale
    gp = int(ws[axis])
    sign = 1.0 if dp[0] > 0 else -1.0
    # reference plane: the slab plane farthest from the camera
    p_ref = float(gp - 1) if sign > 0 else 0.0

    # Footprint of the occupied bbox on the reference plane.
    act_lo, act_hi = _active_bbox_vox(model)
    corners = np.stack(np.meshgrid(
        *[(act_lo[a], act_hi[a]) for a in perm], indexing="ij"),
        -1).reshape(-1, 3)
    o_pv = o_vox[list(perm)]
    denom = corners[:, 0] - o_pv[0]
    ok = np.abs(denom) > 1e-9
    lam = np.clip((p_ref - o_pv[0]) / denom[ok], 0.0, 1e6)
    ur = o_pv[1] + lam * (corners[ok, 1] - o_pv[1])
    vr = o_pv[2] + lam * (corners[ok, 2] - o_pv[2])
    gu, gv = ws[perm[1]], ws[perm[2]]
    ur_lo, ur_hi = max(ur.min(), -gu), min(ur.max(), 2 * gu)
    vr_lo, vr_hi = max(vr.min(), -gv), min(vr.max(), 2 * gv)

    # Screen-pixel density on the reference plane (centre pixel spacing).
    d_pv = (d7[4] * scale)[list(perm)]
    t_ref = (p_ref - o_pv[0]) / d_pv[0]
    du_px = (d7[5] - d7[4]) * scale
    dv_px = (d7[6] - d7[4]) * scale
    spacing = min(
        np.linalg.norm((du_px[list(perm)] * t_ref)[1:]),
        np.linalg.norm((dv_px[list(perm)] * t_ref)[1:]))
    spacing = max(spacing / OVERSAMPLE, 1e-3)
    hi = _round_up(min((ur_hi - ur_lo) / spacing + 2, 4 * max(H, W)),
                   SHAPE_QUANTUM)
    wi = _round_up(min((vr_hi - vr_lo) / spacing + 2, 4 * max(H, W)),
                   SHAPE_QUANTUM)
    return {
        "axis": axis, "perm": perm, "sign": sign, "p_ref": p_ref,
        "o_pv": tuple(float(v) for v in o_pv),
        "ur_range": (float(ur_lo), float(ur_hi)),
        "vr_range": (float(vr_lo), float(vr_hi)),
        "hi": int(hi), "wi": int(wi), "gp": gp,
        "gu": int(gu), "gv": int(gv),
        "p_active": (float(act_lo[axis]), float(act_hi[axis])),
    }


def _build_slabs(density, mask, k0, *, axis, sign, k, s_lo, s_hi, s_pad):
    """Station slabs for K-B in march order, padded with ``s_pad`` zero
    slabs: d_geo [S, Gu, Gv, 2] (density, mask) and d_k0 [S, Gu, Gv, F]
    (or None), bf16."""
    sdt = torch.bfloat16
    geo = torch.stack([density.to(sdt), mask.to(sdt)], -1)
    d_geo = sweep_ops._station_slabs(
        sweep_ops.permute_grid(geo, axis, dtype=sdt), k)[s_lo:s_hi + 1]
    d_k0 = None
    if k0 is not None:
        d_k0 = sweep_ops._station_slabs(
            sweep_ops.permute_grid(k0, axis, dtype=sdt), k)[s_lo:s_hi + 1]
    out = []
    for d in (d_geo, d_k0):
        if d is None:
            out.append(None)
            continue
        if sign < 0:
            d = d.flip(0)
        if s_pad:
            d = torch.cat([d, d.new_zeros((s_pad, *d.shape[1:]))], 0)
        out.append(d.contiguous())
    return tuple(out)


def _get_render_slabs(model, axis, sign, k, s_lo, s_hi, s_pad):
    """Slabs cached per (axis, sign, station range) until the model's grids
    or mask change."""
    key = (axis, float(sign), k, s_lo, s_hi, s_pad)
    cache = model.grid_cache("render_slabs")
    if key not in cache:
        with torch.no_grad():
            cache[key] = _build_slabs(
                model.density, model.mask,
                model.k0 if model.k0_dim > 0 else None, axis=axis,
                sign=sign, k=k, s_lo=s_lo, s_hi=s_hi, s_pad=s_pad)
    return cache[key]


def _tile_boxes(nsb, ur_grid, vr_grid, sc, gu, gv):
    """Slab footprint of each intermediate tile in each station block,
    padded by the 1-voxel interpolation support: the half-open slab rows
    [u0, u1) of each tile row ([Hi/TILE, nsb] each) and columns [v0, v1)
    of each tile column ([Wi/TILE, nsb] each)."""
    dev = ur_grid.device
    nti, ntj = ur_grid.shape[0] // TILE, vr_grid.shape[0] // TILE
    op, ou, ov = sc[0], sc[1], sc[2]
    inv_span, p_first, p_step = sc[3], sc[4], sc[5]
    s0 = torch.arange(nsb, dtype=torch.float32, device=dev) * S_BLK
    lam_a = (p_first + p_step * s0 - op) * inv_span
    lam_b = (p_first + p_step * (s0 + (S_BLK - 1)) - op) * inv_span
    urt = ur_grid.reshape(nti, TILE)
    vrt = vr_grid.reshape(ntj, TILE)

    def axis_range(o, r_lo, r_hi):
        cs = torch.stack([o + lam[None, :] * (r[:, None] - o)
                          for lam in (lam_a, lam_b) for r in (r_lo, r_hi)])
        return cs.amin(0), cs.amax(0)                  # [n_tiles, nsb]

    u_lo, u_hi = axis_range(ou, urt.amin(1), urt.amax(1))
    v_lo, v_hi = axis_range(ov, vrt.amin(1), vrt.amax(1))
    u0 = torch.clamp(torch.ceil(u_lo - 1.0), 0, gu).long()
    u1 = torch.clamp(torch.floor(u_hi + 1.0) + 1, 0, gu).long()
    v0 = torch.clamp(torch.ceil(v_lo - 1.0), 0, gv).long()
    v1 = torch.clamp(torch.floor(v_hi + 1.0) + 1, 0, gv).long()
    return u0, torch.maximum(u1, u0), v0, torch.maximum(v1, v0)


def _tile_activity(d_geo, ur_grid, vr_grid, sc, gu, gv):
    """Per-(intermediate tile, station block) conservative occupancy test:
    1 where the tile's footprint (:func:`_tile_boxes`) touches an occupied
    voxel of the block (2D integral image of the slab mask). Inactive
    blocks contribute exactly zero, so K-B skips them. Returns int32
    [Hi/TILE, Wi/TILE, S/S_BLK]."""
    nsb = d_geo.shape[0] // S_BLK
    occ = (d_geo[..., 1] > 0).reshape(nsb, S_BLK, gu, gv).any(1)
    integ = torch.cumsum(torch.cumsum(occ.to(torch.int32), 1), 2)
    integ = torch.nn.functional.pad(integ, (1, 0, 1, 0))
    u0, u1, v0, v1 = _tile_boxes(nsb, ur_grid, vr_grid, sc, gu, gv)
    s_idx = torch.arange(nsb, device=d_geo.device)[None, None, :]
    U0, U1 = u0[:, None, :], u1[:, None, :]
    V0, V1 = v0[None, :, :], v1[None, :, :]
    cnt = (integ[s_idx, U1, V1] - integ[s_idx, U0, V1]
           - integ[s_idx, U1, V0] + integ[s_idx, U0, V0])
    return (cnt > 0).to(torch.int32).contiguous()


def _frame_scalars(model, plan, k, s_lo, s_hi, hi, wi, near, far, bg):
    """The 23 pose/model scalars of a frame, computed in float64 and
    rounded to f32 (a float32 tensor on the host)."""
    perm = plan["perm"]
    op, ou, ov = plan["o_pv"]
    p_ref = plan["p_ref"]
    if plan["sign"] > 0:
        p_first, p_step = s_lo / k, 1.0 / k
    else:
        p_first, p_step = s_hi / k, -1.0 / k
    inv_span = 1.0 / (p_ref - op)
    ws = np.asarray(model.world_size, np.float64)
    ext = (np.asarray(model.xyz_max, np.float64)
           - np.asarray(model.xyz_min, np.float64))
    inv_scale = ext / (ws - 1.0)  # voxel -> world per axis
    scale = (ws - 1.0) / ext
    ur_lo, ur_hi = plan["ur_range"]
    vr_lo, vr_hi = plan["vr_range"]
    return torch.tensor([
        op, ou, ov, inv_span, p_first, p_step, model.act_shift,
        abs(p_step * inv_span) / model.voxel_size_base,
        model.fast_color_thres, near, far, bg,
        ur_lo, (ur_hi - ur_lo) / (hi - 1),
        vr_lo, (vr_hi - vr_lo) / (wi - 1),
        (p_ref - op) * inv_scale[plan["axis"]],
        inv_scale[perm[1]], inv_scale[perm[2]],
        p_ref, scale[0], scale[1], scale[2]], dtype=torch.float32)


def _render_frame_fused(model, d_geo, d_k0, K, c2w, sc, *, hw, hiwi, guv,
                        perm, rgb_mode, inverse_y, flip_x, flip_y):
    """Intermediate grids, view embeddings, K-B and the homography warp to
    the screen. ``sc`` is the f32 scalar vector of :func:`_frame_scalars`
    (on the device); returns (rgb [H, W, 3], depth [H, W]) tensors."""
    dev = d_geo.device
    f32 = torch.float32
    h_px, w_px = hw
    hi, wi = hiwi
    axis = perm[0]
    op, ou, ov = sc[0], sc[1], sc[2]
    ur0, dur, vr0, dvr = sc[12], sc[13], sc[14], sc[15]
    w_dp, inv_su, inv_sv = sc[16], sc[17], sc[18]
    p_ref, bg = sc[19], sc[11]

    ur_grid = ur0 + dur * torch.arange(hi, dtype=f32, device=dev)
    vr_grid = vr0 + dvr * torch.arange(wi, dtype=f32, device=dev)
    du = (ur_grid - ou) * inv_su
    dv = (vr_grid - ov) * inv_sv
    dnorm = torch.sqrt(w_dp ** 2 + du[:, None] ** 2 + dv[None, :] ** 2)
    # |d . f_cam|: lam * dclip is the ray parameter t of the unnormalized
    # pixel direction, in which near/far clip (as on the per-ray path).
    fwd_axis = c2w[:3, 2]
    dclip = torch.abs(w_dp * fwd_axis[axis] + du[:, None] * fwd_axis[perm[1]]
                      + dv[None, :] * fwd_axis[perm[2]])

    layers = vd_emb = None
    if model.has_rgbnet:
        comps = [None, None, None]
        comps[axis] = w_dp.expand(hi, wi)
        comps[perm[1]] = du[:, None].expand(hi, wi)
        comps[perm[2]] = dv[None, :].expand(hi, wi)
        viewdirs = torch.stack(comps, -1) / torch.clamp(dnorm[..., None],
                                                        min=1e-12)
        vd_emb = mlp_lib.positional_encoding(
            viewdirs, model.viewbase_pe).to(torch.bfloat16).contiguous()
        layers = [(layer.weight.detach().t(), layer.bias.detach())
                  for layer in model.rgbnet.layers]

    activity = _tile_activity(d_geo, ur_grid, vr_grid, sc, guv[0], guv[1])
    scalars = [float(x) for x in sc[:12].cpu()]
    rgb_cl, inter_depth, inter_ainv = render_frame(
        d_geo, d_k0, vd_emb, dnorm.contiguous(), dclip.contiguous(),
        ur_grid.contiguous(), vr_grid.contiguous(), layers, scalars,
        activity, has_mlp=model.has_rgbnet, rgb_mode=rgb_mode)
    inter_rgb = rgb_cl.permute(1, 2, 0)

    # Homography warp to the screen (ray convention of rays.get_rays).
    ii = torch.arange(w_px, dtype=f32, device=dev) + 0.5
    jj = torch.arange(h_px, dtype=f32, device=dev) + 0.5
    if flip_x:
        ii = ii.flip(0)
    if flip_y:
        jj = jj.flip(0)
    i2 = ii[None, :].expand(h_px, w_px)
    j2 = jj[:, None].expand(h_px, w_px)
    if inverse_y:
        dirs = torch.stack([(i2 - K[0, 2]) / K[0, 0],
                            (j2 - K[1, 2]) / K[1, 1],
                            torch.ones_like(i2)], -1)
    else:
        dirs = torch.stack([(i2 - K[0, 2]) / K[0, 0],
                            -(j2 - K[1, 2]) / K[1, 1],
                            -torch.ones_like(i2)], -1)
    rays_d = dirs @ c2w[:3, :3].T
    d_pv = rays_d * sc[20:23]
    dp_px = d_pv[..., axis]
    dp_safe = torch.where(dp_px.abs() < 1e-12,
                          torch.full_like(dp_px, 1e-12), dp_px)
    t_ref = (p_ref - op) / dp_safe
    ur_px = ou + t_ref * d_pv[..., perm[1]]
    vr_px = ov + t_ref * d_pv[..., perm[2]]
    valid = ((t_ref > 0) & (ur_px >= ur_grid[0]) & (ur_px <= ur_grid[-1])
             & (vr_px >= vr_grid[0]) & (vr_px <= vr_grid[-1]))
    ur_l = (ur_px - ur0) / torch.clamp(dur, min=1e-12)
    vr_l = (vr_px - vr0) / torch.clamp(dvr, min=1e-12)
    packed = torch.cat([inter_rgb, inter_depth[..., None],
                        inter_ainv[..., None]], -1)
    out = grid_ops.bilinear_sample_parts(packed, ur_l, vr_l)
    rgb = torch.where(valid[..., None], out[..., :3], bg)
    depth = torch.where(valid, out[..., 3], torch.zeros_like(out[..., 3]))
    return rgb, depth


OUTPUTS = ("numpy", "device", "device_compact", "device_yuv420")


def to_u8(x):
    """``round(clip(x, 0, 1) * 255)`` as uint8 (ties to even)."""
    return torch.round(torch.clamp(x, 0.0, 1.0) * 255.0).to(torch.uint8)


def _lin3(c, x):
    """``c[0] * x[0] + c[1] * x[1] + c[2] * x[2]`` with f32 constants, as
    the JAX package's CPU compiler contracts it: the middle term first,
    then the first and last as fused multiply-adds (the f32 products are
    exact in f64, so each rounds once)."""
    c = [float(np.float32(v)) for v in c]
    acc = x[1] * c[1]
    acc = (x[0].double() * c[0] + acc.double()).float()
    return (x[2].double() * c[2] + acc.double()).float()


def _box2x2(p):
    """The mean of each 2x2 block of ``p [H, W]``, over the pixels that
    exist: ``[ceil(H/2), ceil(W/2)]``, summed row by row as the JAX
    package's ``mean`` sums a whole block."""
    h, w = p.shape
    ph, pw = h % 2, w % 2
    p = torch.nn.functional.pad(p, (0, pw, 0, ph))
    n = torch.nn.functional.pad(torch.ones(h, w, dtype=p.dtype,
                                           device=p.device), (0, pw, 0, ph))
    s = ((p[0::2, 0::2] + p[0::2, 1::2]) + p[1::2, 0::2]) + p[1::2, 1::2]
    cnt = ((n[0::2, 0::2] + n[0::2, 1::2]) + n[1::2, 0::2]) + n[1::2, 1::2]
    return s / cnt


def yuv420(rgb):
    """Planar I420 ``[Y | U | V]`` uint8 buffer of ``rgb [H, W, 3]``:
    full-range BT.601 luma, 2x2 box-filtered chroma of ``ceil(H/2) x
    ceil(W/2)`` (an odd last row or column averages the pixels it has),
    ``H*W + 2*ceil(H/2)*ceil(W/2)`` bytes."""
    x = rgb.unbind(-1)
    y = _lin3((0.299, 0.587, 0.114), x)
    u = _lin3((-0.168736, -0.331264, 0.5), x) + 0.5
    v = _lin3((0.5, -0.418688, -0.081312), x) + 0.5
    return torch.cat([to_u8(y).reshape(-1), to_u8(_box2x2(u)).reshape(-1),
                      to_u8(_box2x2(v)).reshape(-1)])


def frame_outputs(rgb, depth, output="numpy"):
    """A frame's (rgb [H, W, 3], depth [H, W]) f32 tensors as ``output``
    asks: "numpy" (f32 arrays on the host), "device" (the tensors),
    "device_compact" (uint8 rgb, f16 depth, on the device) or
    "device_yuv420" (an I420 uint8 buffer, :func:`yuv420`, and f16
    depth)."""
    if output == "numpy":
        return rgb.cpu().numpy(), depth.cpu().numpy()
    if output == "device":
        return rgb, depth
    if output == "device_compact":
        return to_u8(rgb), depth.to(torch.float16)
    if output == "device_yuv420":
        return yuv420(rgb), depth.to(torch.float16)
    raise ValueError(f"output {output!r} is none of {OUTPUTS}")


def render_frame_sweep(model, H, W, K, c2w, render_kwargs, output="numpy"):
    """Render one camera frame with the separable station sweep.

    Returns (rgb [H, W, 3], depth [H, W]) in the form ``output`` names
    (:func:`frame_outputs`; numpy f32 arrays by default), or None when the
    camera geometry (or a model variant the frame kernel does not cover)
    rules the sweep out and the caller must render per ray.
    """
    if output not in OUTPUTS:
        raise ValueError(f"output {output!r} is none of {OUTPUTS}")
    near = float(render_kwargs["near"])
    far = float(render_kwargs["far"])
    bg = float(render_kwargs["bg"])
    stepsize = float(render_kwargs["stepsize"])
    inverse_y = bool(render_kwargs.get("inverse_y", False))
    flip_x = bool(render_kwargs.get("flip_x", False))
    flip_y = bool(render_kwargs.get("flip_y", False))
    plan = plan_camera_sweep(model, H, W, K, c2w, near, far,
                             inverse_y=inverse_y, flip_x=flip_x,
                             flip_y=flip_y, stepsize=stepsize)
    if plan is None:
        return None

    k = sweep_ops.substeps_for_stepsize(stepsize)
    hi, wi = plan["hi"], plan["wi"]
    rgb_mode = "direct"
    if model.has_rgbnet and not model.rgbnet_direct:
        rgb_mode = "logit_plus_k0"
    p_lo, p_hi = plan["p_active"]
    s_lo = int(np.floor(p_lo * k))
    s_hi = int(np.ceil(p_hi * k))
    s_pad = (-(s_hi - s_lo + 1)) % max(S_QUANTUM, S_BLK)
    d_geo, d_k0 = _get_render_slabs(model, plan["axis"], plan["sign"], k,
                                    s_lo, s_hi, s_pad)
    dev = d_geo.device
    sc = _frame_scalars(model, plan, k, s_lo, s_hi, hi, wi, near, far,
                        bg).to(dev)
    with torch.no_grad():
        rgb, depth = _render_frame_fused(
            model, d_geo, d_k0,
            torch.as_tensor(np.asarray(K, np.float32), device=dev),
            torch.as_tensor(np.asarray(c2w, np.float32), device=dev), sc,
            hw=(int(H), int(W)), hiwi=(hi, wi),
            guv=(plan["gu"], plan["gv"]), perm=plan["perm"],
            rgb_mode=rgb_mode, inverse_y=inverse_y, flip_x=flip_x,
            flip_y=flip_y)
        return frame_outputs(rgb, depth, output)
