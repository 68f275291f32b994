"""Single-scene triplane-conditioned driver: a DirectVoxGO coarse stage
(the station sweep, kernels K-A and K-C, with the per-voxel learning
rate), then :class:`.models.tri_dvgo.TriDVGO` whose colour comes from 3
random conditioning views (rgb + rays_o + rays_d) per step, each at a
``down`` drawn from [2, ``dynamic_down``) whenever ``dynamic_down > 2``
(as the JAX driver, whatever ``dynamic_downsampling`` says), or fixed
views (``fixed_lr_idx``). ``--render_test`` renders the test views with 3
fixed conditioning views encoded once.

  python -m directvoxgo_tpu_torch.run_tri --config configs/nerf/tri_lego.py \\
      [--render_test] [--device cpu]

The JAX driver's flags, plus ``--device`` (default: CUDA, which must be
there; ``cpu`` runs everything on the CPU). LPIPS raises until it is
ported.
"""

from __future__ import annotations

import argparse
import os
import random

import numpy as np
import torch

from .config import Config
from .data import load_everything
from .device import resolve_device
from .engine import checkpoint as ckpt_lib
from .engine import render_conditioned as rc
from .engine import train as train_lib
from .engine import train_conditioned as cond_lib
from .models.dvgo import DirectVoxGO
from .models.tri_dvgo import TriDVGO

# fine-stage config keys that are not model keyword arguments
NOT_MODEL_KEYS = ('num_voxels', 'maskout_near_cam_vox', 'world_bound_scale',
                  'stepsize', 'use_coarse_geo', 'bbox_thres')


def config_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument('--config', required=True)
    parser.add_argument('--seed', type=int, default=777)
    parser.add_argument('--no_reload', action='store_true')
    parser.add_argument('--no_reload_optimizer', action='store_true')
    parser.add_argument('--ft_path', type=str, default='')
    parser.add_argument('--render_only', action='store_true')
    parser.add_argument('--render_test', action='store_true')
    parser.add_argument('--render_train', action='store_true')
    parser.add_argument('--render_video', action='store_true')
    parser.add_argument('--render_video_factor', type=int, default=0)
    parser.add_argument('--eval_ssim', action='store_true')
    parser.add_argument('--eval_lpips_alex', action='store_true')
    parser.add_argument('--eval_lpips_vgg', action='store_true')
    parser.add_argument('--i_print', type=int, default=500)
    parser.add_argument('--i_weights', type=int, default=100000)
    parser.add_argument('--device', type=str, default=None,
                        help='torch device (default: cuda; "cpu" runs on '
                             'the CPU)')
    return parser


def setup(args):
    """The device (CUDA unless ``--device`` says otherwise; never a
    fallback), seeds, and the precision the drivers train with: f32
    matrix products (the MLPs), TF32 convolutions (the encoders, cuDNN's
    default)."""
    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    np.random.seed(args.seed)
    random.seed(args.seed)
    torch.manual_seed(args.seed)
    return device


def model_kwargs_of(cfg_model):
    return {k: v for k, v in dict(cfg_model).items()
            if k not in NOT_MODEL_KEYS}


def render_kwargs_of(cfg, near, far, with_rays=False):
    rk = {'near': float(near), 'far': float(far),
          'bg': 1 if cfg.data.white_bkgd else 0,
          'stepsize': cfg.fine_model_and_render.stepsize}
    if with_rays:
        rk.update(inverse_y=cfg.data.inverse_y, flip_x=cfg.data.flip_x,
                  flip_y=cfg.data.flip_y)
    return rk


def train_scene(data_dict, idx):
    """The views ``idx`` as a scene bundle (images, poses, HW, Ks)."""
    return {'images': [data_dict['images'][i] for i in idx],
            'poses': data_dict['poses'][idx],
            'HW': data_dict['HW'][idx], 'Ks': data_dict['Ks'][idx]}


def images_on(scene, device):
    """A scene's images as one ``[n, H, W, 3]`` tensor on ``device``."""
    return torch.as_tensor(np.stack([np.asarray(im, np.float32)
                                     for im in scene['images']]),
                           device=device)


def coarse_stage(args, cfg, data_dict, device):
    """DirectVoxGO coarse geometry through the port's engine; returns the
    checkpoint path (None without a coarse stage)."""
    if cfg.coarse_train.N_iters <= 0:
        return None
    os.makedirs(os.path.join(cfg.basedir, cfg.expname), exist_ok=True)
    xyz_min, xyz_max = train_lib.compute_bbox_by_cam_frustrm(
        cfg=cfg, **data_dict)
    train_lib.scene_rep_reconstruction(
        args=args, cfg=cfg, cfg_model=cfg.coarse_model_and_render,
        cfg_train=cfg.coarse_train, xyz_min=xyz_min, xyz_max=xyz_max,
        data_dict=data_dict, stage='coarse', device=device)
    return os.path.join(cfg.basedir, cfg.expname, 'coarse_last.tar')


def fine_stage(args, cfg, data_dict, coarse_ckpt_path, device):
    cfg_model = cfg.fine_model_and_render
    cfg_train = cfg.fine_train
    xyz_min, xyz_max = train_lib.compute_bbox_by_cam_frustrm(
        cfg=cfg, **data_dict)
    if cfg_model.get('use_coarse_geo', True) and coarse_ckpt_path:
        xyz_min, xyz_max = train_lib.compute_bbox_by_coarse_geo(
            model_class=DirectVoxGO, model_path=coarse_ckpt_path,
            thres=cfg_model.bbox_thres, device=device)
    model = TriDVGO(xyz_min=xyz_min, xyz_max=xyz_max,
                    num_voxels=cond_lib.initial_num_voxels(
                        args, cfg, cfg_model, cfg_train, 'fine'),
                    mask_cache_path=coarse_ckpt_path, device=device,
                    **model_kwargs_of(cfg_model))
    optimizer = train_lib.create_optimizer_or_freeze_model(model, cfg_train)
    render_kwargs = render_kwargs_of(cfg, data_dict['near'],
                                     data_dict['far'])
    i_train = data_dict['i_train']
    scene = train_scene(data_dict, i_train)
    pool = cond_lib.gather_scene_ray_pool(
        model, cfg, cfg_train, scene,
        render_kwargs_of(cfg, data_dict['near'], data_dict['far'], True))
    images = images_on(scene, device)
    dynamic_down = int(cfg_train.get('dynamic_down', 1))
    fixed_idx = cfg_train.get('fixed_lr_idx')

    def cond_source(rng, scene_id):
        views = cond_lib.pick_conditioning_views(
            rng, len(i_train), k=3, fixed_idx=fixed_idx)
        down = int(rng.integers(2, dynamic_down)) if dynamic_down > 2 else 1
        return cond_lib.build_conditioning_batch(
            images, scene['poses'], scene['HW'], scene['Ks'], views,
            cfg.data, down=down)

    model, _ = cond_lib.train_conditioned_stage(
        args, cfg, cfg_train, model, optimizer, [pool], cond_source,
        render_kwargs, stage='fine')
    return model


def eval_splits(args, cfg, data_dict, model, feats_for_view, ckpt_name,
                scene_id=None):
    """``--render_train``/``--render_test``/``--render_video`` of a trained
    conditioned model; returns {split: stats}."""
    rk = render_kwargs_of(cfg, data_dict['near'], data_dict['far'], True)
    splits = []
    if args.render_train:
        splits.append(('train', data_dict['i_train'], 0, True))
    if args.render_test:
        splits.append(('test', data_dict['i_test'], 0, True))
    if args.render_video:
        splits.append(('video', data_dict['i_test'],
                       args.render_video_factor, False))
    out = {}
    for name, idx, factor, gt in splits:
        savedir = os.path.join(cfg.basedir, cfg.expname,
                               f'render_{name}_{ckpt_name}')
        os.makedirs(savedir, exist_ok=True)
        rgbs, depths, stats = rc.render_viewpoints_conditioned(
            model, lambda i, idx=idx: feats_for_view(idx[i]),
            render_poses=data_dict['poses'][idx], HW=data_dict['HW'][idx],
            Ks=data_dict['Ks'][idx], render_kwargs=rk,
            gt_imgs=[np.asarray(data_dict['images'][i]) for i in idx]
            if gt else None,
            savedir=savedir, render_factor=factor, eval_ssim=args.eval_ssim,
            eval_lpips_alex=args.eval_lpips_alex,
            eval_lpips_vgg=args.eval_lpips_vgg, scene_id=scene_id)
        rc.save_videos(savedir, rgbs, depths)
        out[name] = stats
    return out


def eval_stage(args, cfg, data_dict, device, model_class=TriDVGO):
    """Render the asked splits with 3 fixed conditioning views (train
    views) encoded once."""
    ckpt_path = args.ft_path or os.path.join(cfg.basedir, cfg.expname,
                                             'fine_last.tar')
    model = ckpt_lib.load_model(model_class, ckpt_path, device=device)
    i_train = data_dict['i_train']
    view_ids = rc.eval_view_ids(cfg.fine_train, i_train, render=True)
    cond = train_scene(data_dict, [i_train[v] for v in view_ids])
    feats = rc.encode_conditioning(
        model, cond['images'], cond['poses'], cond['HW'], cond['Ks'],
        list(range(len(view_ids))), cfg.data)
    return eval_splits(args, cfg, data_dict, model, lambda i: feats,
                       os.path.basename(ckpt_path)[:-4])


def main(argv=None):
    args = config_parser().parse_args(argv)
    cfg = Config.fromfile(args.config)
    device = setup(args)
    data_dict = load_everything(args=args, cfg=cfg)
    os.makedirs(os.path.join(cfg.basedir, cfg.expname), exist_ok=True)
    if not args.render_only:
        coarse = coarse_stage(args, cfg, data_dict, device)
        fine_stage(args, cfg, data_dict, coarse, device)
    if args.render_test or args.render_train or args.render_video:
        eval_stage(args, cfg, data_dict, device)
    print('Done')


if __name__ == '__main__':
    main()
