"""Command line of the port: trains a scene coarse then fine and
renders the result, or renders a trained checkpoint.

Takes the same flags as the JAX package's ``run.py``. Training
(``--no_reload``, ``--no_reload_optimizer``, ``--ft_path``, ``--i_print``,
``--i_weights``, ``--seed``) and rendering (``--render_only``,
``--render_test``, ``--render_train``, ``--render_video``, ``--eval_ssim``)
work; the export, LPIPS, profiling and ``--data_parallel`` flags raise
until their slice is ported. Usage::

  python -m directvoxgo_tpu_torch.run \\
      --config configs/synthetic/fixture_lego_sparse.py --render_test
  python -m directvoxgo_tpu_torch.run --config configs/nerf/lego.py \\
      --render_only --render_test [--ft_path ckpt.tar] [--device cuda]
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
from .engine import metrics as metrics_lib
from .engine import train as train_lib
from .engine.render import render_viewpoints, write_png
from .models.dvgo import DirectVoxGO

# flag -> the ROADMAP item that ports it
_NOT_PORTED = {
    "export_bbox_and_cams_only": "ROADMAP A7: export flags",
    "export_coarse_only": "ROADMAP A7: export flags",
    "export_fine_only": "ROADMAP A7: export flags",
    "eval_lpips_alex": "ROADMAP A1: gated LPIPS",
    "eval_lpips_vgg": "ROADMAP A1: gated LPIPS",
    "data_parallel": "ROADMAP A13: parallel",
    "profile_dir": "ROADMAP A7: profiler trace of training",
}


def config_parser():
    """CLI flags of the JAX package's run.py, plus ``--device``."""
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument('--config', required=True, help='config file path')
    parser.add_argument('--seed', type=int, default=777, help='random seed')
    parser.add_argument('--data_parallel', action='store_true',
                        help='shard ray batches over all devices')
    parser.add_argument('--no_reload', action='store_true',
                        help='do not reload weights from saved ckpt')
    parser.add_argument('--no_reload_optimizer', action='store_true',
                        help='do not reload optimizer state from saved ckpt')
    parser.add_argument('--ft_path', type=str, default='',
                        help='specific weights file to reload')
    parser.add_argument('--export_bbox_and_cams_only', type=str, default='',
                        help='export scene bbox and camera poses for 3d debug')
    parser.add_argument('--export_coarse_only', type=str, default='')
    parser.add_argument('--export_fine_only', type=str, default='')
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
    parser.add_argument('--profile_dir', type=str, default='',
                        help='capture a profiler trace of training')
    parser.add_argument('--device', type=str, default=None,
                        help='torch device (default: cuda; "cpu" runs the '
                             'kernels\' plain versions)')
    return parser


def _check_supported(args, cfg):
    for flag, item in _NOT_PORTED.items():
        if getattr(args, flag):
            raise NotImplementedError(
                f"--{flag} is not ported yet ({item})")
    if cfg.data.ndc:
        raise NotImplementedError(
            "ndc configs (DMPIGO) are not ported yet (ROADMAP A9: DMPIGO "
            "and NDC)")


def _write_frames(savedir, rgbs, depths):
    """Depth PNGs beside the rgb ones, and an mp4 where imageio can."""
    for i, d in enumerate(depths):
        write_png(os.path.join(savedir, f"depth_{i:03d}.png"),
                  np.repeat(metrics_lib.to8b(1 - d / max(np.max(depths),
                                                         1e-8)), 3, -1))
    try:
        import imageio.v2 as imageio
        imageio.mimwrite(os.path.join(savedir, 'video.rgb.mp4'),
                         metrics_lib.to8b(rgbs), fps=30, quality=8)
    except (ImportError, ValueError) as e:
        print(f'video export skipped: {e}')


def main(argv=None):
    args = config_parser().parse_args(argv)
    cfg = Config.fromfile(args.config)
    _check_supported(args, cfg)
    device = resolve_device(args.device)
    np.random.seed(args.seed)
    random.seed(args.seed)
    torch.manual_seed(args.seed)

    data_dict = load_everything(args=args, cfg=cfg)
    if not args.render_only:
        train_lib.train(args, cfg, data_dict, device=device)
    if not (args.render_test or args.render_train or args.render_video):
        print('Done')
        return
    if args.ft_path and args.render_only:
        ckpt_path = args.ft_path
    else:
        ckpt_path = os.path.join(cfg.basedir, cfg.expname, 'fine_last.tar')
    ckpt_name = os.path.basename(ckpt_path)[:-4]
    model = ckpt_lib.load_model(DirectVoxGO, ckpt_path, device=device)
    common = {
        'model': model,
        'ndc': cfg.data.ndc,
        'render_kwargs': {
            'near': data_dict['near'], 'far': data_dict['far'],
            'bg': 1 if cfg.data.white_bkgd else 0,
            'stepsize': cfg.fine_model_and_render.stepsize,
            'inverse_y': cfg.data.inverse_y,
            'flip_x': cfg.data.flip_x, 'flip_y': cfg.data.flip_y,
            'render_depth': True,
        },
        'flip_x': cfg.data.flip_x, 'flip_y': cfg.data.flip_y,
    }
    splits = []
    if args.render_train:
        splits.append(('train', data_dict['i_train']))
    if args.render_test:
        splits.append(('test', data_dict['i_test']))
    for split, idx in splits:
        savedir = os.path.join(cfg.basedir, cfg.expname,
                               f'render_{split}_{ckpt_name}')
        os.makedirs(savedir, exist_ok=True)
        rgbs, depths, stats = render_viewpoints(
            render_poses=data_dict['poses'][idx],
            HW=data_dict['HW'][idx], Ks=data_dict['Ks'][idx],
            gt_imgs=[np.asarray(data_dict['images'][i]) for i in idx],
            savedir=savedir, eval_ssim=args.eval_ssim, **common)
        print(f'render_{split}: views rendered by path {stats["path"]}')
        _write_frames(savedir, rgbs, depths)
    if args.render_video:
        savedir = os.path.join(cfg.basedir, cfg.expname,
                               f'render_video_{ckpt_name}')
        os.makedirs(savedir, exist_ok=True)
        n = len(data_dict['render_poses'])
        i0 = data_dict['i_test'][[0]]
        rgbs, depths, _ = render_viewpoints(
            render_poses=data_dict['render_poses'],
            HW=data_dict['HW'][i0].repeat(n, 0),
            Ks=data_dict['Ks'][i0].repeat(n, 0),
            render_factor=args.render_video_factor, savedir=savedir,
            **common)
        _write_frames(savedir, rgbs, depths)
    print('Done')


if __name__ == '__main__':
    main()
