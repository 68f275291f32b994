"""Super-resolution driver: a DirectVoxGO coarse stage trained on the LR
images (``images_lr``, ``HW_lr``, ``Ks_lr`` of ``task='sr'`` data; kernels
K-A and K-C), then :class:`.models.sr_dvgo.SRDVGO` trained on HR rays, one
view per step, conditioned on that view's LR image shifted to [-1, 1].
Evaluation conditions each rendered view on its own LR image.

  python -m directvoxgo_tpu_torch.run_sr --config configs/nerf/sr_lego.py \\
      [--render_test] [--device cpu]
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .config import Config
from .data import load_everything
from .engine import checkpoint as ckpt_lib
from .engine import train as train_lib
from .engine import train_conditioned as cond_lib
from .models.dvgo import DirectVoxGO
from .models.sr_dvgo import SRDVGO
from .run_tri import (config_parser, eval_splits, model_kwargs_of,
                      render_kwargs_of, setup, train_scene)


def lr_image(data_dict, i, device):
    """View ``i``'s LR image, shifted to [-1, 1], ``[1, 3, h, w]``."""
    lr = torch.as_tensor(np.asarray(data_dict['images_lr'][i], np.float32),
                         device=device)
    return ((lr - 0.5) / 0.5).permute(2, 0, 1)[None]


def coarse_on_lr(args, cfg, data_dict, device):
    """Coarse geometry from the LR views."""
    os.makedirs(os.path.join(cfg.basedir, cfg.expname), exist_ok=True)
    lr_dict = dict(data_dict, images=data_dict['images_lr'],
                   HW=data_dict['HW_lr'], Ks=data_dict['Ks_lr'])
    xyz_min, xyz_max = train_lib.compute_bbox_by_cam_frustrm(
        cfg=cfg, **{k: lr_dict[k] for k in
                    ('HW', 'Ks', 'poses', 'i_train', 'near', 'far')})
    train_lib.scene_rep_reconstruction(
        args=args, cfg=cfg, cfg_model=cfg.coarse_model_and_render,
        cfg_train=cfg.coarse_train, xyz_min=xyz_min, xyz_max=xyz_max,
        data_dict=lr_dict, stage='coarse', device=device)
    return os.path.join(cfg.basedir, cfg.expname, 'coarse_last.tar')


def fine_stage(args, cfg, data_dict, coarse_ckpt_path, device):
    cfg_model = cfg.fine_model_and_render
    cfg_train = cfg.fine_train
    if coarse_ckpt_path:
        xyz_min, xyz_max = train_lib.compute_bbox_by_coarse_geo(
            model_class=DirectVoxGO, model_path=coarse_ckpt_path,
            thres=cfg_model.bbox_thres, device=device)
    else:
        xyz_min, xyz_max = train_lib.compute_bbox_by_cam_frustrm(
            cfg=cfg, **data_dict)
    model = SRDVGO(xyz_min=xyz_min, xyz_max=xyz_max,
                   num_voxels=cfg_model.num_voxels,
                   mask_cache_path=coarse_ckpt_path, device=device,
                   **model_kwargs_of(cfg_model))
    optimizer = train_lib.create_optimizer_or_freeze_model(model, cfg_train)
    render_kwargs = render_kwargs_of(cfg, data_dict['near'],
                                     data_dict['far'])
    hit_kwargs = render_kwargs_of(cfg, data_dict['near'], data_dict['far'],
                                  True)
    # one HR pool per view: a step's rays and conditioning share a view
    pools, lr_imgs = [], []
    for i in data_dict['i_train']:
        pools.append(cond_lib.gather_scene_ray_pool(
            model, cfg, cfg_train, train_scene(data_dict, [i]), hit_kwargs))
        lr_imgs.append(lr_image(data_dict, i, device))

    def cond_source(rng, view_id):
        return lr_imgs[view_id], None

    model, _ = cond_lib.train_conditioned_stage(
        args, cfg, cfg_train, model, optimizer, pools, cond_source,
        render_kwargs, stage='fine')
    return model


def eval_stage(args, cfg, data_dict, device):
    """Render the asked splits, each view conditioned on its LR image."""
    ckpt_path = args.ft_path or os.path.join(cfg.basedir, cfg.expname,
                                             'fine_last.tar')
    model = ckpt_lib.load_model(SRDVGO, ckpt_path, device=device)

    @torch.no_grad()
    def feats_for_view(i):
        return model.encode_feat(lr_image(data_dict, i, device))

    return eval_splits(args, cfg, data_dict, model, feats_for_view,
                       os.path.basename(ckpt_path)[:-4])


def main(argv=None):
    args = config_parser().parse_args(argv)
    cfg = Config.fromfile(args.config)
    device = setup(args)
    data_dict = load_everything(args=args, cfg=cfg)
    os.makedirs(os.path.join(cfg.basedir, cfg.expname), exist_ok=True)
    if not args.render_only:
        coarse = None
        if cfg.coarse_train.N_iters > 0:
            coarse = coarse_on_lr(args, cfg, data_dict, device)
        fine_stage(args, cfg, data_dict, coarse, device)
    if args.render_test or args.render_train or args.render_video:
        eval_stage(args, cfg, data_dict, device)
    print('Done')


if __name__ == '__main__':
    main()
