"""Viewpoint rendering and evaluation.

``render_viewpoints`` renders a list of poses: each perspective view first
tries the whole-frame camera sweep (:mod:`.render_sweep`, kernel K-B) and
falls back to per-ray rendering (:func:`render_rays_chunked` over
``DirectVoxGO.forward_sweep``, kernel K-A) when the sweep plan rejects the
camera. NDC (forward-facing) views render along the model's forced sweep
axis (``DirectMPIGO.forward_sweep``, kernel K-A): as pixel tiles, each a
composed (bp, eu, ev) window of the clip box (:func:`render_frame_ndc_tiles`),
else per ray in Morton-segment windows (:func:`_render_rays_windowed_2d`),
else in chunks over the clip box. A gather model (``query_mode='gather'``)
renders every view per ray, through its gather ``forward``, in chunks of
the whole ray list in order (the JAX package takes the frame sweep and the
NDC tiles only for sweep models).

Each pull of rendered pixels to the host runs under the opt-in watchdog of
:mod:`.fetchguard`: the pull alone, never the rendering before it, whose
first call may build a kernel.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from . import metrics as metrics_lib
from . import render_sweep as render_sweep_lib
from .. import rays as ray_lib
from ..data.image_io import write_png
from ..ops import sweep as sweep_ops
from ..parallel import all_gather_rays, shard_batch_tree
from .fetchguard import guarded, timeout_default


def _round_up(x, m):
    return ((int(x) + m - 1) // m) * m


# Least station-plane area (voxels) for the windowed NDC renders; below it
# the windows' bookkeeping does not pay. Tests lower it to force them.
WINDOWED_RENDER_MIN_PLANE = 128 * 128


def make_render_fn(model, render_kwargs, group=None):
    """Render one ray chunk -> (rgb [N, 3], depth [N]) tensors: along a
    sweep ``axis`` the chunk's rays share, or through the gather forward
    for ``axis`` None. ``render_chunk.use_sweep`` says whether the model
    renders through the sweep. ``group`` (a :class:`..parallel.DataMesh`)
    splits each chunk over the ranks, every rank rendering its contiguous
    block with its replica of the model, and gathers the blocks back: each
    rank returns the whole chunk's result (N must split over the
    ranks)."""
    kwargs = {k: v for k, v in render_kwargs.items()
              if k in ("near", "far", "bg", "stepsize")}

    @torch.no_grad()
    def render_chunk(ro, rd, vd, axis, clip_sizes, clip_off):
        if group is not None:
            ro, rd, vd = shard_batch_tree(group, (ro, rd, vd))
            rgb, depth = render_local(ro, rd, vd, axis, clip_sizes,
                                      clip_off)
            return (all_gather_rays(group, rgb),
                    all_gather_rays(group, depth))
        return render_local(ro, rd, vd, axis, clip_sizes, clip_off)

    def render_local(ro, rd, vd, axis, clip_sizes, clip_off):
        if axis is None:
            ret = model(ro, rd, vd, render_depth=True, **kwargs)
        else:
            ret = model.forward_sweep(ro, rd, vd, axis, render_depth=True,
                                      clip_sizes=clip_sizes,
                                      clip_offsets=clip_off, **kwargs)
        return ret["rgb_marched"], ret["depth"]

    render_chunk.use_sweep = getattr(model, "query_mode", "sweep") == "sweep"
    return render_chunk


def render_rays_chunked(render_fn, model, rays_o, rays_d, viewdirs, chunk):
    """Render a flat numpy ray list in fixed-size padded chunks, grouped by
    dominant axis (each chunk must share one; a model's
    ``forced_sweep_axis`` takes every ray, through the 2D windows of
    :func:`_render_rays_windowed_2d` where they engage), or for a gather
    model as one part of every ray (axis None); results return in input
    order as numpy arrays."""
    n = rays_o.shape[0]
    if not getattr(render_fn, "use_sweep", True):
        parts = [(None, np.arange(n))]
    else:
        forced = getattr(model, "forced_sweep_axis", None)
        if forced is not None:
            out = _render_rays_windowed_2d(render_fn, model, rays_o, rays_d,
                                           viewdirs, chunk, int(forced))
            if out is not None:
                return out
        groups = sweep_ops.sweep_axes(model, rays_d)
        parts = [(axis, np.flatnonzero(groups == axis)) for axis in range(3)]
    dev = model.device
    rgb_out = np.empty((n, 3), np.float32)
    dep_out = np.empty((n,), np.float32)
    for axis, idx in parts:
        if not len(idx):
            continue
        clip_sizes, clip_off = (model.sweep_clip_for_axis(axis)
                                if axis is not None else (None, None))
        n_g = len(idx)
        n_pad = _round_up(max(n_g, 1), chunk)
        pad = n_pad - n_g
        ro = np.concatenate([rays_o[idx], np.zeros((pad, 3), np.float32)])
        rd = np.concatenate([rays_d[idx], np.ones((pad, 3), np.float32)])
        vd = np.concatenate([viewdirs[idx], np.ones((pad, 3), np.float32)])
        outs = []
        for i in range(0, n_pad, chunk):
            t = lambda a: torch.as_tensor(a[i:i + chunk], device=dev)  # noqa
            outs.append(render_fn(t(ro), t(rd), t(vd), axis, clip_sizes,
                                  clip_off))
        with guarded("eval chunks", timeout=4 * timeout_default()):
            rgb_out[idx] = torch.cat([o[0] for o in outs]).cpu().numpy()[:n_g]
            dep_out[idx] = torch.cat([o[1] for o in outs]).cpu().numpy()[:n_g]
    return rgb_out, dep_out


def _clip_box(model, axis):
    """((bp, bu, bv), (bpo, buo, bvo), clipped?) of the model's clip box
    along ``axis``, or the whole grid."""
    csz, coff = model.sweep_clip_for_axis(axis)
    if csz is not None:
        return (tuple(int(x) for x in csz),
                tuple(int(x) for x in np.asarray(coff)), True)
    return (tuple(int(model.world_size[a]) for a in sweep_ops._PERMS[axis]),
            (0, 0, 0), False)


def _window_offsets(box, offs, eu, ev, ulo, vlo):
    """[p, u, v] offsets of an (eu, ev) window at (ulo, vlo), shifted into
    the clip box: the rows it then leaves out have an interpolated mask of
    0, so the window stays exact."""
    (bp, bu, bv), (bpo, buo, bvo) = box, offs
    return np.asarray([bpo, min(max(int(ulo), buo), buo + bu - eu),
                       min(max(int(vlo), bvo), bvo + bv - ev)], np.int32)


def _render_rays_windowed_2d(render_fn, model, rays_o, rays_d, viewdirs,
                             chunk, axis):
    """Per-ray rendering of a forced-axis (MPI) model in 2D (u, v) windows.

    A station of an MPI grid is a whole image plane, while the rays of one
    Morton segment (:func:`..ops.sweep.build_ray_segments_2d` at
    ``n_rand = chunk``) form an image tile with a compact footprint at
    every depth: each segment renders as a composed (bp, Wu, Wv) window of
    the clip box (exact: every interp row of its rays lies inside). The
    rays are padded to whole chunks with copies of ray 0, which classify
    like real rays. Returns ``(rgb, depth)`` numpy arrays, or None when the
    plane is below ``WINDOWED_RENDER_MIN_PLANE`` or no segment gets a
    window (the caller renders plain chunks).
    """
    perm = sweep_ops._PERMS[axis]
    gu = int(model.world_size[perm[1]])
    gv = int(model.world_size[perm[2]])
    if gu * gv < WINDOWED_RENDER_MIN_PLANE:
        return None
    n = rays_o.shape[0]
    pad = _round_up(max(n, 1), chunk) - n
    ro, rd, vd = (np.concatenate([a, np.repeat(a[:1], pad, 0)]).astype(
        np.float32) for a in (rays_o, rays_d, viewdirs))
    box, offs, clipped = _clip_box(model, axis)
    (bp, bu, bv), (bpo, buo, bvo) = box, offs
    buckets = sweep_ops.build_ray_segments_2d(
        ro, rd, model.xyz_min, model.xyz_max, model.world_size, axis,
        n_rand=chunk, clip_box=(bpo, bpo + bp - 1, buo, buo + bu - 1,
                                bvo, bvo + bv - 1) if clipped else None)

    def eff(k):
        return (k[0] if 0 < k[0] < bu else bu, k[1] if 0 < k[1] < bv else bv)

    if all(k == (0, 0) or eff(k) == (bu, bv) for k in buckets):
        return None
    dev = model.device
    outs = []
    for key in sorted(buckets):
        idx, ulo, vlo = buckets[key]
        eu, ev = eff(key)
        windowed = key != (0, 0) and (eu, ev) != (bu, bv)
        for s in range(idx.shape[0]):
            if windowed:
                sizes = (bp, eu, ev)
                off = _window_offsets(box, offs, eu, ev, ulo[s], vlo[s])
            else:
                sizes = box if clipped else None
                off = np.asarray(offs, np.int32)
            t = lambda a: torch.as_tensor(a[idx[s]], device=dev)  # noqa
            outs.append((idx[s], render_fn(t(ro), t(rd), t(vd), axis, sizes,
                                           off)))
    rgb_out = np.empty((len(ro), 3), np.float32)
    dep_out = np.empty((len(ro),), np.float32)
    with guarded("eval frame chunks", timeout=4 * timeout_default()):
        for sel, (rgb, dep) in outs:    # one sync, after every launch
            rgb_out[sel] = rgb.cpu().numpy()
            dep_out[sel] = dep.cpu().numpy()
    return rgb_out[:n], dep_out[:n]


def rays_of_view_ndc(K, c2w, H, W, inverse_y, flip_x, flip_y, device):
    """The NDC rays of a view, made on ``device`` in f32 with the formulas
    of :func:`..rays.get_rays_of_a_view` (center pixels): (rays_o, rays_d,
    viewdirs), each [H * W, 3]."""
    K = torch.as_tensor(np.asarray(K, np.float32), device=device)
    c2w = torch.as_tensor(np.asarray(c2w, np.float32), device=device)
    j, i = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=device),
        torch.arange(W, dtype=torch.float32, device=device), indexing="ij")
    i, j = i + 0.5, j + 0.5
    if flip_x:
        i = i.flip(1)
    if flip_y:
        j = j.flip(0)
    if inverse_y:
        dirs = torch.stack([(i - K[0, 2]) / K[0, 0], (j - K[1, 2]) / K[1, 1],
                            torch.ones_like(i)], -1)
    else:
        dirs = torch.stack([(i - K[0, 2]) / K[0, 0],
                            -(j - K[1, 2]) / K[1, 1], -torch.ones_like(i)],
                           -1)
    rays_d = dirs @ c2w[:3, :3].T
    rays_o = c2w[:3, 3].expand(rays_d.shape)
    viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    focal, near = K[0, 0], 1.0
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    ro = rays_o + t[..., None] * rays_d
    o0 = -1.0 / (W / (2.0 * focal)) * ro[..., 0] / ro[..., 2]
    o1 = -1.0 / (H / (2.0 * focal)) * ro[..., 1] / ro[..., 2]
    o2 = 1.0 + 2.0 * near / ro[..., 2]
    d0 = -1.0 / (W / (2.0 * focal)) * (rays_d[..., 0] / rays_d[..., 2]
                                       - ro[..., 0] / ro[..., 2])
    d1 = -1.0 / (H / (2.0 * focal)) * (rays_d[..., 1] / rays_d[..., 2]
                                       - ro[..., 1] / ro[..., 2])
    d2 = -2.0 * near / ro[..., 2]
    return (torch.stack([o0, o1, o2], -1).reshape(-1, 3),
            torch.stack([d0, d1, d2], -1).reshape(-1, 3),
            viewdirs.reshape(-1, 3))


def render_frame_ndc_tiles(render_fn, model, H, W, K, c2w, rk, chunk=8192,
                           tile_hw=(64, 128),
                           widths=(32, 48, 64, 96, 128)):
    """Whole-frame NDC (forced-axis MPI) render as pixel tiles.

    The rays are made on the device (:func:`rays_of_view_ndc`) and cut
    into ``tile_hw`` tiles (the frame edge-padded to whole tiles); each
    tile renders through ``render_fn`` as a composed (bp, eu, ev) window
    of the clip box. A tile's window comes from its extreme pixel-centre
    rays: along a tile edge the plane coordinate is a Moebius function of
    the pixel index (NDC rays are projective in (i, j)), so the extremes
    sit at the four corners, and along a ray it is linear in t, so they
    sit at the clip box's p faces: 4 corners x 2 faces bound every interp
    row (with the margins of :func:`..ops.sweep.build_ray_segments_2d`).
    Window extents snap up to ``widths`` (else the box's extent). Every
    tile's result stays on the device until one copy at the end.

    Returns flat ``(rgb [H*W, 3], depth [H*W])`` numpy arrays, or None
    when the model has no forced sweep axis or its plane is below
    ``WINDOWED_RENDER_MIN_PLANE``.
    """
    axis = getattr(model, "forced_sweep_axis", None)
    if axis is None:
        return None
    perm = sweep_ops._PERMS[axis]
    gu = int(model.world_size[perm[1]])
    gv = int(model.world_size[perm[2]])
    if gu * gv < WINDOWED_RENDER_MIN_PLANE:
        return None
    th, tw = tile_hw
    assert th * tw == chunk
    nth, ntw = -(-H // th), -(-W // tw)
    hp, wp = nth * th, ntw * tw
    box, offs, clipped = _clip_box(model, axis)
    (bp, bu, bv), (bpo, buo, bvo) = box, offs

    # host: per-tile windows from the 4 corner pixel-centre rays (edge
    # tiles clamp their pixel indices, as the padding does)
    r0 = np.arange(nth) * th
    r1 = np.minimum(r0 + th - 1, H - 1)
    c0 = np.arange(ntw) * tw
    c1 = np.minimum(c0 + tw - 1, W - 1)
    jj = np.broadcast_to(
        np.stack([r0, r1], 1)[:, None, :, None].astype(np.float64),
        (nth, ntw, 2, 2)) + 0.5
    ii = np.broadcast_to(
        np.stack([c0, c1], 1)[None, :, None, :].astype(np.float64),
        (nth, ntw, 2, 2)) + 0.5
    inverse_y = bool(rk.get("inverse_y", False))
    flip_x = bool(rk.get("flip_x", False))
    flip_y = bool(rk.get("flip_y", False))
    if flip_x:
        ii = W - ii
    if flip_y:
        jj = H - jj
    Kh = np.asarray(K, np.float64)
    c2wh = np.asarray(c2w, np.float64)
    if inverse_y:
        dirs = np.stack([(ii - Kh[0, 2]) / Kh[0, 0],
                         (jj - Kh[1, 2]) / Kh[1, 1], np.ones_like(ii)], -1)
    else:
        dirs = np.stack([(ii - Kh[0, 2]) / Kh[0, 0],
                         -(jj - Kh[1, 2]) / Kh[1, 1], -np.ones_like(ii)], -1)
    rd = dirs @ c2wh[:3, :3].T
    ro = np.broadcast_to(c2wh[:3, 3], rd.shape)
    focal = Kh[0, 0]
    t_sh = -(1.0 + ro[..., 2]) / rd[..., 2]
    ros = ro + t_sh[..., None] * rd
    o_ndc = np.stack([-1.0 / (W / (2.0 * focal)) * ros[..., 0] / ros[..., 2],
                      -1.0 / (H / (2.0 * focal)) * ros[..., 1] / ros[..., 2],
                      1.0 + 2.0 / ros[..., 2]], -1)
    d_ndc = np.stack([
        -1.0 / (W / (2.0 * focal)) * (rd[..., 0] / rd[..., 2]
                                      - ros[..., 0] / ros[..., 2]),
        -1.0 / (H / (2.0 * focal)) * (rd[..., 1] / rd[..., 2]
                                      - ros[..., 1] / ros[..., 2]),
        -2.0 / ros[..., 2]], -1)
    xyz_min = np.asarray(model.xyz_min, np.float64)
    xyz_max = np.asarray(model.xyz_max, np.float64)
    ws = np.asarray(model.world_size, np.float64)
    scale = [(ws[a] - 1.0) / (xyz_max[a] - xyz_min[a]) for a in perm]
    op_, ou_, ov_ = ((o_ndc[..., a] - xyz_min[a]) * sc
                     for a, sc in zip(perm, scale))
    dp_, du_, dv_ = (d_ndc[..., a] * sc for a, sc in zip(perm, scale))
    dp_ = np.where(np.abs(dp_) < 1e-10, 1e-10, dp_)
    t0 = (float(bpo) - op_) / dp_
    t1 = (float(bpo + bp - 1) - op_) / dp_
    guard = sweep_ops.SEG_GUARD
    u_ends = np.clip(np.stack([ou_ + t0 * du_, ou_ + t1 * du_]),
                     buo - 1.0, float(buo + bu))
    v_ends = np.clip(np.stack([ov_ + t0 * dv_, ov_ + t1 * dv_]),
                     bvo - 1.0, float(bvo + bv))
    red = (0, 3, 4)        # the two faces, the four corners
    u0t = np.maximum(0, np.floor(u_ends.min(axis=red) - guard))
    u1t = np.minimum(gu - 1, np.floor(u_ends.max(axis=red) + guard) + 1)
    v0t = np.maximum(0, np.floor(v_ends.min(axis=red) - guard))
    v1t = np.minimum(gv - 1, np.floor(v_ends.max(axis=red) + guard) + 1)

    def snap(need, extent):
        out = np.full(need.shape, extent, np.int64)
        for w in sorted((w for w in widths if w < extent), reverse=True):
            out = np.where(need <= w, w, out)
        return out

    eu_t = snap((u1t - u0t + 1).astype(np.int64), bu)
    ev_t = snap((v1t - v0t + 1).astype(np.int64), bv)

    # device: rays once, cut into tiles by index (edge rows and columns
    # repeat into the padding)
    dev = model.device
    rays = rays_of_view_ndc(K, c2w, H, W, inverse_y, flip_x, flip_y, dev)
    rows = torch.clamp(torch.arange(hp, device=dev), max=H - 1)
    cols = torch.clamp(torch.arange(wp, device=dev), max=W - 1)
    pix = (rows[:, None] * W + cols[None, :]).reshape(
        nth, th, ntw, tw).permute(0, 2, 1, 3).reshape(nth * ntw, chunk)
    ro_t, rd_t, vd_t = (a[pix] for a in rays)
    rgbs, deps = [], []
    for k in range(nth * ntw):
        ti, tj = divmod(k, ntw)
        eu, ev = int(eu_t[ti, tj]), int(ev_t[ti, tj])
        if (eu, ev) == (bu, bv):
            sizes = box if clipped else None
            off = np.asarray(offs, np.int32)
        else:
            sizes = (bp, eu, ev)
            off = _window_offsets(box, offs, eu, ev, u0t[ti, tj],
                                  v0t[ti, tj])
        rgb, dep = render_fn(ro_t[k], rd_t[k], vd_t[k], axis, sizes, off)
        rgbs.append(rgb)
        deps.append(dep)
    rgb = torch.stack(rgbs).reshape(nth, ntw, th, tw, 3).permute(
        0, 2, 1, 3, 4).reshape(hp, wp, 3)[:H, :W]
    dep = torch.stack(deps).reshape(nth, ntw, th, tw).permute(
        0, 2, 1, 3).reshape(hp, wp)[:H, :W]
    with guarded("eval tiles", timeout=4 * timeout_default()):
        return (rgb.reshape(-1, 3).cpu().numpy(),
                dep.reshape(-1).cpu().numpy())


def render_viewpoints(model, render_poses, HW, Ks, ndc, render_kwargs,
                      gt_imgs=None, savedir=None, render_factor=0,
                      eval_ssim=False, eval_lpips_alex=False,
                      eval_lpips_vgg=False, chunk=8192, flip_x=False,
                      flip_y=False, verbose=True):
    """Render a list of poses; compute PSNR (and SSIM, LPIPS) against
    ``gt_imgs`` when given; write PNGs to ``savedir``. Returns (rgbs,
    depths, stats), the views stacked by :func:`stack_views`; ``stats["path"]`` names each view's path: "frame" (the
    camera sweep), "tiles" (an NDC view as windowed pixel tiles) or "rays"
    (per ray: the fallback of both, and every view of a gather model).
    LPIPS without the ``lpips`` package raises before any view renders.
    """
    assert len(render_poses) == len(HW) and len(HW) == len(Ks)
    if eval_lpips_alex or eval_lpips_vgg:
        metrics_lib.require_lpips()
    if render_factor != 0:
        HW = np.copy(HW) // render_factor
        Ks = np.copy(Ks)
        Ks[:, :2, :3] = Ks[:, :2, :3] / render_factor

    render_fn = make_render_fn(model, render_kwargs)
    rgbs, depths, psnrs, ssims, paths = [], [], [], [], []
    lp_alex, lp_vgg = [], []
    for i, c2w in enumerate(render_poses):
        H, W = (int(x) for x in HW[i])
        K = Ks[i]
        if not render_fn.use_sweep:
            out = None
        elif ndc:
            out = render_frame_ndc_tiles(
                render_fn, model, H, W, np.asarray(K), np.asarray(c2w),
                {**render_kwargs, "flip_x": flip_x, "flip_y": flip_y})
        else:
            out = render_sweep_lib.render_frame_sweep(
                model, H, W, np.asarray(K), np.asarray(c2w), render_kwargs,
                output="device")
            if out is not None:
                with guarded(f"eval view {i}", timeout=4 * timeout_default()):
                    out = tuple(x.cpu().numpy() for x in out)
        if out is not None:
            rgb, depth = out
            paths.append("tiles" if ndc else "frame")
        else:
            rays_o, rays_d, viewdirs = ray_lib.get_rays_of_a_view(
                H, W, K, c2w, ndc, inverse_y=render_kwargs["inverse_y"],
                flip_x=flip_x, flip_y=flip_y)
            rgb, depth = render_rays_chunked(
                render_fn, model, rays_o.reshape(-1, 3),
                rays_d.reshape(-1, 3), viewdirs.reshape(-1, 3), chunk)
            paths.append("rays")
        rgb = rgb.reshape(H, W, 3)
        depth = depth.reshape(H, W, 1)
        rgbs.append(rgb)
        depths.append(depth)
        if i == 0 and verbose:
            print("Testing", rgb.shape)
        if gt_imgs is not None and render_factor == 0:
            gt = np.asarray(gt_imgs[i], np.float32)
            psnrs.append(metrics_lib.psnr(rgb, gt))
            if eval_ssim:
                ssims.append(metrics_lib.rgb_ssim(rgb, gt, max_val=1))
            if eval_lpips_alex:
                lp_alex.append(metrics_lib.rgb_lpips(gt, rgb, "alex"))
            if eval_lpips_vgg:
                lp_vgg.append(metrics_lib.rgb_lpips(gt, rgb, "vgg"))

    if len(psnrs) and verbose:
        print("Testing psnr", np.mean(psnrs), "(avg)")
        if eval_ssim:
            print("Testing ssim", np.mean(ssims), "(avg)")
        if eval_lpips_vgg:
            print("Testing lpips (vgg)", np.mean(lp_vgg), "(avg)")
        if eval_lpips_alex:
            print("Testing lpips (alex)", np.mean(lp_alex), "(avg)")
    if savedir is not None:
        print(f"Writing images to {savedir}")
        for i, rgb in enumerate(rgbs):
            write_png(os.path.join(savedir, f"{i:03d}.png"),
                      metrics_lib.to8b(rgb))
    stats = {"psnr": psnrs, "ssim": ssims, "lpips_alex": lp_alex,
             "lpips_vgg": lp_vgg, "path": paths}
    return stack_views(rgbs), stack_views(depths), stats


def stack_views(views):
    """Views as one array, or as a 1-D object array of them when their
    sizes differ (CO3D's views)."""
    if len({v.shape for v in views}) <= 1:
        return np.array(views)
    out = np.empty(len(views), dtype=object)
    out[:] = list(views)
    return out
