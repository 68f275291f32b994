"""Viewpoint rendering and evaluation.

``render_viewpoints`` renders a list of poses: each view first tries the
whole-frame camera sweep (:mod:`.render_sweep`, kernel K-B) and falls back
to per-ray rendering (:func:`render_rays_chunked` over
``DirectVoxGO.forward_sweep``, kernel K-A) when the sweep plan rejects the
camera. NDC (forward-facing) views render per ray, every ray along the
model's forced sweep axis (``DirectMPIGO.forward_sweep``, kernel K-A) in
chunks over the occupancy clip box; the JAX package's 2D (u, v) windowed
tiles are not ported (ROADMAP queue item 1).
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np
import torch

from . import metrics as metrics_lib
from . import render_sweep as render_sweep_lib
from .. import rays as ray_lib
from ..ops import sweep as sweep_ops


def _round_up(x, m):
    return ((int(x) + m - 1) // m) * m


def write_png(path, img):
    """Write an [H, W, 3] uint8 image as an 8-bit RGB PNG."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w, _ = img.shape
    raw = b"".join(b"\x00" + img[r].tobytes() for r in range(h))

    def chunk(tag, data):
        body = tag + data
        return (struct.pack(">I", len(data)) + body
                + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 6))
                + chunk(b"IEND", b""))


def make_render_fn(model, render_kwargs):
    """Render one ray chunk sharing a dominant ``axis`` ->
    (rgb [N, 3], depth [N]) tensors."""
    if getattr(model, "query_mode", "sweep") != "sweep":
        raise NotImplementedError(
            "only sweep-mode models render in this port (ROADMAP A: gather "
            "forward)")
    kwargs = {k: v for k, v in render_kwargs.items()
              if k in ("near", "far", "bg", "stepsize")}

    @torch.no_grad()
    def render_chunk(ro, rd, vd, axis, clip_sizes, clip_off):
        ret = model.forward_sweep(ro, rd, vd, axis, render_depth=True,
                                  clip_sizes=clip_sizes,
                                  clip_offsets=clip_off, **kwargs)
        return ret["rgb_marched"], ret["depth"]

    return render_chunk


def render_rays_chunked(render_fn, model, rays_o, rays_d, viewdirs, chunk):
    """Render a flat numpy ray list in fixed-size padded chunks, grouped by
    dominant axis (each chunk must share one; a model's
    ``forced_sweep_axis`` takes every ray); results return in input order
    as numpy arrays."""
    n = rays_o.shape[0]
    dev = model.device
    rgb_out = np.empty((n, 3), np.float32)
    dep_out = np.empty((n,), np.float32)
    groups = sweep_ops.sweep_axes(model, rays_d)
    for axis in range(3):
        idx = np.flatnonzero(groups == axis)
        if not len(idx):
            continue
        clip_sizes, clip_off = model.sweep_clip_for_axis(axis)
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
        rgb_out[idx] = torch.cat([o[0] for o in outs]).cpu().numpy()[:n_g]
        dep_out[idx] = torch.cat([o[1] for o in outs]).cpu().numpy()[:n_g]
    return rgb_out, dep_out


def render_viewpoints(model, render_poses, HW, Ks, ndc, render_kwargs,
                      gt_imgs=None, savedir=None, render_factor=0,
                      eval_ssim=False, chunk=8192, flip_x=False,
                      flip_y=False, verbose=True):
    """Render a list of poses; compute PSNR (and SSIM) against ``gt_imgs``
    when given; write PNGs to ``savedir``. Returns (rgbs, depths, stats);
    ``stats["path"]`` names each view's path: "frame" (the camera sweep)
    or "rays" (per ray: the fallback, and every NDC view).
    """
    assert len(render_poses) == len(HW) and len(HW) == len(Ks)
    if render_factor != 0:
        HW = np.copy(HW) // render_factor
        Ks = np.copy(Ks)
        Ks[:, :2, :3] = Ks[:, :2, :3] / render_factor

    render_fn = make_render_fn(model, render_kwargs)
    rgbs, depths, psnrs, ssims, paths = [], [], [], [], []
    for i, c2w in enumerate(render_poses):
        H, W = (int(x) for x in HW[i])
        K = Ks[i]
        out = None if ndc else render_sweep_lib.render_frame_sweep(
            model, H, W, np.asarray(K), np.asarray(c2w), render_kwargs)
        if out is not None:
            rgb, depth = out
            paths.append("frame")
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

    if len(psnrs) and verbose:
        print("Testing psnr", np.mean(psnrs), "(avg)")
        if eval_ssim:
            print("Testing ssim", np.mean(ssims), "(avg)")
    if savedir is not None:
        print(f"Writing images to {savedir}")
        for i, rgb in enumerate(rgbs):
            write_png(os.path.join(savedir, f"{i:03d}.png"),
                      metrics_lib.to8b(rgb))
    stats = {"psnr": psnrs, "ssim": ssims, "path": paths}
    return np.array(rgbs), np.array(depths), stats
