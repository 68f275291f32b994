"""Command line of the port: trains a scene coarse then fine and
renders the result, or renders a trained checkpoint. Forward-facing
(``data.ndc``) configs train and render DirectMPIGO, the others
DirectVoxGO.

Takes the same flags as the JAX package's ``run.py``: training
(``--no_reload``, ``--no_reload_optimizer``, ``--ft_path``, ``--i_print``,
``--i_weights``, ``--seed``, ``--profile_dir``: a ``torch.profiler`` trace
of training, CPU and CUDA activities, as ``trace.json`` in the directory),
rendering (``--render_only``, ``--render_test``, ``--render_train``,
``--render_video``, ``--eval_ssim``, ``--eval_lpips_alex``/``_vgg``, which
need the ``lpips`` package and raise before rendering without it) and the
exports (``--export_bbox_and_cams_only``, ``--export_coarse_only``,
``--export_fine_only``: the JAX driver's npz files, from checkpoints of
either package, then exit) and ``--data_parallel``: training split over
one rank per card (under ``torchrun`` this process is one; otherwise one
process is spawned per visible card; with one device it trains there); the
rendering that follows runs on rank 0 alone. Usage::

  python -m directvoxgo_tpu_torch.run \\
      --config configs/synthetic/fixture_lego_sparse.py --render_test
  python -m directvoxgo_tpu_torch.run --config configs/nerf/lego.py \\
      --render_only --render_test [--ft_path ckpt.tar] [--device cuda]
  python -m directvoxgo_tpu_torch.run \\
      --config configs/synthetic/fixture_ndc_tiny.py --device cpu --render_test
  python -m directvoxgo_tpu_torch.run --config configs/nerf/lego.py \\
      --data_parallel --render_test         # one rank per visible card
  torchrun --nproc_per_node 4 -m directvoxgo_tpu_torch.run \\
      --config configs/nerf/lego.py --data_parallel
"""

from __future__ import annotations

import argparse
import contextlib
import os
import random
import socket
import sys

import numpy as np
import torch

from . import rays as ray_lib
from .config import Config
from .data import load_everything
from .device import resolve_device
from .engine import checkpoint as ckpt_lib
from .engine import metrics as metrics_lib
from .engine import train as train_lib
from .engine.render import render_viewpoints, write_png
from .models.dvgo import DirectVoxGO
from .parallel import make_mesh


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
                        help='write a torch.profiler trace of training '
                             '(trace.json) into this directory')
    parser.add_argument('--device', type=str, default=None,
                        help='torch device (default: cuda; "cpu" runs the '
                             'kernels\' plain versions)')
    return parser


def train_profiled(args, cfg, data_dict, device, mesh=None):
    """Train under ``torch.profiler`` (CPU activities, and CUDA's on a CUDA
    device); the trace goes to ``<profile_dir>/trace.json``."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if device.type == 'cuda':
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(args.profile_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        train_lib.train(args, cfg, data_dict, device=device, mesh=mesh)
    path = os.path.join(args.profile_dir, 'trace.json')
    prof.export_chrome_trace(path)
    print(f'profile: trace written to {path}')


def _free_port():
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _rank_main(rank, argv, world, init_method):
    """One spawned rank of ``--data_parallel`` on the card ``rank``."""
    args = config_parser().parse_args(argv)
    cfg = Config.fromfile(args.config)
    mesh = make_mesh(torch.device("cuda", rank), init_method=init_method,
                     world_size=world, rank=rank)
    _run(args, cfg, mesh.device, mesh)


def _write_frames(savedir, rgbs, depths):
    """Depth PNGs beside the rgb ones, and an mp4 where imageio can (and
    the views share one size)."""
    dmax = max([float(np.max(d)) for d in depths] + [1e-8])
    for i, d in enumerate(depths):
        write_png(os.path.join(savedir, f"depth_{i:03d}.png"),
                  np.repeat(metrics_lib.to8b(1 - d / dmax), 3, -1))
    if rgbs.dtype == object:
        print('video export skipped: the views differ in size')
        return
    try:
        import imageio.v2 as imageio
        imageio.mimwrite(os.path.join(savedir, 'video.rgb.mp4'),
                         metrics_lib.to8b(rgbs), fps=30, quality=8)
    except (ImportError, ValueError) as e:
        print(f'video export skipped: {e}')


def export_bbox_and_cams(cfg, data_dict, out_path):
    """The train views' frustum bbox and each camera's centre and corner
    rays (out to ``max(near, far * 0.05)``), as the JAX driver writes
    them."""
    xyz_min, xyz_max = train_lib.compute_bbox_by_cam_frustrm(
        cfg=cfg, **data_dict)
    i_train = data_dict['i_train']
    near, far = data_dict['near'], data_dict['far']
    cam_lst = []
    for c2w, (H, W), K in zip(data_dict['poses'][i_train],
                              data_dict['HW'][i_train],
                              data_dict['Ks'][i_train]):
        rays_o, rays_d, _ = ray_lib.get_rays_of_a_view(
            H, W, K, c2w, cfg.data.ndc, inverse_y=cfg.data.inverse_y,
            flip_x=cfg.data.flip_x, flip_y=cfg.data.flip_y)
        cam_o = rays_o[0, 0]
        cam_d = rays_d[[0, 0, -1, -1], [0, -1, 0, -1]]
        cam_lst.append(np.array(
            [cam_o, *(cam_o + cam_d * max(near, far * 0.05))]))
    np.savez_compressed(out_path, xyz_min=xyz_min, xyz_max=xyz_max,
                        cam_lst=np.array(cam_lst))


def export_alpha_rgb(cfg, stage, out_path, device):
    """The ``{stage}_last.tar`` DirectVoxGO's alpha grid and its colour
    grid through a sigmoid, as the JAX driver writes them."""
    ckpt_path = os.path.join(cfg.basedir, cfg.expname, f'{stage}_last.tar')
    model = ckpt_lib.load_model(DirectVoxGO, ckpt_path, device=device)
    with torch.no_grad():
        alpha = model.activate_density(model.density).cpu().numpy()
    k0 = model.k0.detach().cpu().numpy()
    np.savez_compressed(out_path, alpha=alpha,
                        rgb=1.0 / (1.0 + np.exp(-k0)))


def main(argv=None):
    args = config_parser().parse_args(argv)
    cfg = Config.fromfile(args.config)
    device = resolve_device(args.device)
    mesh = None
    n_cards = torch.cuda.device_count() if device.type == 'cuda' else 1
    if args.data_parallel and 'WORLD_SIZE' in os.environ:
        # under torchrun: this process is one rank, on card LOCAL_RANK
        if device.type == 'cuda':
            device = torch.device('cuda', int(os.environ.get('LOCAL_RANK',
                                                             0)))
        mesh = make_mesh(device)
    elif args.data_parallel and n_cards > 1:
        import torch.multiprocessing as mp
        print(f'data_parallel: one rank per card, {n_cards} ranks')
        mp.spawn(_rank_main, nprocs=n_cards, join=True, args=(
            list(argv if argv is not None else sys.argv[1:]), n_cards,
            f'tcp://localhost:{_free_port()}'))
        return
    elif args.data_parallel:
        # as the JAX package does with one device
        print(f'data_parallel: one device ({device}); training on it')
    _run(args, cfg, device, mesh)


def _run(args, cfg, device, mesh=None):
    """The command line's work on ``device``; with a ``mesh``, as one
    rank of data-parallel training (only rank 0 prints, writes and
    renders)."""
    if mesh is None or mesh.rank == 0:
        return _run_rank(args, cfg, device, mesh, True)
    with open(os.devnull, 'w') as null, contextlib.redirect_stdout(null):
        return _run_rank(args, cfg, device, mesh, False)


def _run_rank(args, cfg, device, mesh, writer):
    # The gather forward's colour MLP computes in f32, as the JAX package's.
    torch.backends.cuda.matmul.allow_tf32 = False
    np.random.seed(args.seed)
    random.seed(args.seed)
    torch.manual_seed(args.seed)

    data_dict = load_everything(args=args, cfg=cfg)
    if not writer and (args.export_bbox_and_cams_only
                       or args.export_coarse_only or args.export_fine_only):
        return
    if args.export_bbox_and_cams_only:
        print('Export bbox and cameras...')
        export_bbox_and_cams(cfg, data_dict, args.export_bbox_and_cams_only)
        print('done')
        return
    for stage in ('coarse', 'fine'):
        out_path = getattr(args, f'export_{stage}_only')
        if out_path:
            print(f'Export {stage} visualization...')
            export_alpha_rgb(cfg, stage, out_path, device)
            print('done')
            return
    if args.eval_lpips_alex or args.eval_lpips_vgg:
        metrics_lib.require_lpips()
    if not args.render_only:
        if args.profile_dir:
            train_profiled(args, cfg, data_dict, device, mesh)
        else:
            train_lib.train(args, cfg, data_dict, device=device, mesh=mesh)
    if mesh is not None:
        import torch.distributed as dist
        dist.destroy_process_group()
        if not writer:
            return
    if not (args.render_test or args.render_train or args.render_video):
        print('Done')
        return
    if args.ft_path and args.render_only:
        ckpt_path = args.ft_path
    else:
        ckpt_path = os.path.join(cfg.basedir, cfg.expname, 'fine_last.tar')
    ckpt_name = os.path.basename(ckpt_path)[:-4]
    model = ckpt_lib.load_model(train_lib.model_class_for(cfg), ckpt_path,
                                device=device)
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
            savedir=savedir, eval_ssim=args.eval_ssim,
            eval_lpips_alex=args.eval_lpips_alex,
            eval_lpips_vgg=args.eval_lpips_vgg, **common)
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
