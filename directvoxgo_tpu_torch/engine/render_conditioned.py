"""Viewpoint rendering and evaluation of the image-conditioned models.

The conditioning features are encoded once (3 fixed train views for the
triplane and implicit models, the rendered view's own LR image for SR),
then each pose renders per ray in chunks through ``model.render(feats,
...)``, without gradients. ``feats_for_view`` maps a view index to its
(encoded, on-device) features.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import rays as ray_lib
from . import metrics as metrics_lib
from . import train_conditioned as cond_lib
from .render import write_png


def make_cond_render_fn(model, render_kwargs, scene_id=None):
    """``render_chunk(feats, ro, rd, vd) -> (rgb [n, 3], depth [n])``; a
    multi-scene model renders the scene ``scene_id``'s grids."""
    kwargs = {k: v for k, v in render_kwargs.items()
              if k in ("near", "far", "bg", "stepsize")}
    if scene_id is not None:
        kwargs["scene_id"] = scene_id

    @torch.no_grad()
    def render_chunk(feats, ro, rd, vd):
        ret = model.render(feats, ro, rd, vd, render_depth=True, **kwargs)
        return ret["rgb_marched"], ret["depth"]

    return render_chunk


@torch.no_grad()
def encode_conditioning(model, images, poses, HW, Ks, view_ids, cfg_data,
                        scene_id=None, down=1):
    """The features of fixed conditioning views, encoded once (the
    auxiliary losses of the multi-scene model dropped)."""
    rgb_lr, pose_lr = cond_lib.build_conditioning_batch(
        images, poses, HW, Ks, view_ids, cfg_data, down=down,
        device=model.device)
    if scene_id is not None:
        out = model.encode_feat(rgb_lr, pose_lr, scene_id=scene_id)
    else:
        out = model.encode_feat(rgb_lr, pose_lr)
    return out[0] if isinstance(out, tuple) else out


def render_viewpoints_conditioned(model, feats_for_view, render_poses, HW,
                                  Ks, render_kwargs, gt_imgs=None,
                                  savedir=None, render_factor=0,
                                  eval_ssim=False, eval_lpips_alex=False,
                                  eval_lpips_vgg=False, chunk=8192,
                                  scene_id=None, verbose=True):
    """Render ``render_poses`` with per-view conditioning features, with
    PSNR (and SSIM) against ``gt_imgs``; PNGs into ``savedir``. Returns
    (rgbs, depths, stats). ``render_kwargs`` carries ``inverse_y``/
    ``flip_x``/``flip_y`` for the rays."""
    if eval_lpips_alex or eval_lpips_vgg:
        metrics_lib.require_lpips()
    assert len(render_poses) == len(HW) and len(HW) == len(Ks)
    HW = np.asarray(HW)
    Ks = np.asarray(Ks, np.float32)
    if render_factor != 0:
        HW = np.copy(HW) // render_factor
        Ks = np.copy(Ks)
        Ks[:, :2, :3] = Ks[:, :2, :3] / render_factor
    render_fn = make_cond_render_fn(model, render_kwargs, scene_id=scene_id)
    dev = model.device
    rgbs, depths, psnrs, ssims, lp_alex, lp_vgg = [], [], [], [], [], []
    for i, c2w in enumerate(render_poses):
        H, W = int(HW[i][0]), int(HW[i][1])
        feats = feats_for_view(i)
        rays = ray_lib.get_rays_of_a_view(
            H, W, Ks[i], c2w, ndc=False,
            inverse_y=bool(render_kwargs.get("inverse_y", False)),
            flip_x=bool(render_kwargs.get("flip_x", False)),
            flip_y=bool(render_kwargs.get("flip_y", False)))
        ro, rd, vd = (torch.as_tensor(np.ascontiguousarray(
            r.reshape(-1, 3)), device=dev) for r in rays)
        outs = [render_fn(feats, ro[s:s + chunk], rd[s:s + chunk],
                          vd[s:s + chunk])
                for s in range(0, ro.shape[0], chunk)]
        rgb = torch.cat([o[0] for o in outs]).cpu().numpy().reshape(H, W, 3)
        dep = torch.cat([o[1] for o in outs]).cpu().numpy().reshape(H, W, 1)
        rgbs.append(rgb)
        depths.append(dep)
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
    if psnrs and verbose:
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
             "lpips_vgg": lp_vgg}
    return np.array(rgbs), np.array(depths), stats


def eval_view_ids(cfg_train, i_train, k=3, render=False):
    """Conditioning views of an evaluation: ``fixed_lr_idx`` (or
    ``fixed_lr_idx_render`` when rendering) when set, else the first ``k``
    train views."""
    key = "fixed_lr_idx_render" if render else "fixed_lr_idx"
    idx = cfg_train.get(key) or cfg_train.get("fixed_lr_idx")
    if idx:
        return list(idx)[:k]
    return list(range(min(k, len(i_train))))


def save_videos(savedir, rgbs, depths, fps=30):
    """rgb and inverted-depth mp4s, when an mp4 writer is installed; else
    skipped with a message."""
    try:
        import imageio.v2 as imageio
        imageio.mimwrite(os.path.join(savedir, "video.rgb.mp4"),
                         metrics_lib.to8b(rgbs), fps=fps, quality=8)
        dmax = max(float(np.max(depths)), 1e-9)
        imageio.mimwrite(os.path.join(savedir, "video.depth.mp4"),
                         metrics_lib.to8b(1.0 - depths / dmax), fps=fps,
                         quality=8)
    except (ImportError, ValueError, RuntimeError) as e:
        print(f"video export skipped: {e}")
