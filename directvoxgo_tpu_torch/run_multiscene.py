"""Implicit-conditioned driver: a DirectVoxGO coarse stage (kernels K-A and
K-C), then :class:`.models.multiscene_dvgo.MultiSceneImplicitDVGO`
(triplane features and a NeRF-MLP head, no density grid) conditioned on 3
random views per step; the coarse occupancy skips free space.

  python -m directvoxgo_tpu_torch.run_multiscene \\
      --config configs/nerf/multiscene_lego.py [--render_test] [--device cpu]
"""

from __future__ import annotations

import os

import torch

from .config import Config
from .data import load_everything
from .engine import train as train_lib
from .engine import train_conditioned as cond_lib
from .models.multiscene_dvgo import MultiSceneImplicitDVGO
from .run_tri import (coarse_stage, config_parser, eval_stage, images_on,
                      model_kwargs_of, render_kwargs_of, setup, train_scene)


def fine_stage(args, cfg, data_dict, coarse_ckpt_path, device):
    cfg_model = cfg.fine_model_and_render
    cfg_train = cfg.fine_train
    xyz_min, xyz_max = train_lib.compute_bbox_by_cam_frustrm(
        cfg=cfg, **data_dict)
    model = MultiSceneImplicitDVGO(
        xyz_min=xyz_min, xyz_max=xyz_max, num_voxels=cfg_model.num_voxels,
        mask_cache_path=coarse_ckpt_path, device=device,
        generator=torch.Generator().manual_seed(args.seed),
        **model_kwargs_of(cfg_model))
    optimizer = train_lib.create_optimizer_or_freeze_model(model, cfg_train)
    scene = train_scene(data_dict, data_dict['i_train'])
    pool = cond_lib.gather_scene_ray_pool(
        model, cfg, cfg_train, scene,
        render_kwargs_of(cfg, data_dict['near'], data_dict['far'], True))
    images = images_on(scene, device)

    def cond_source(rng, scene_id):
        views = cond_lib.pick_conditioning_views(rng, len(images), k=3)
        return cond_lib.build_conditioning_batch(
            images, scene['poses'], scene['HW'], scene['Ks'], views,
            cfg.data)

    model, _ = cond_lib.train_conditioned_stage(
        args, cfg, cfg_train, model, optimizer, [pool], cond_source,
        render_kwargs_of(cfg, data_dict['near'], data_dict['far']),
        stage='fine')
    return model


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
        eval_stage(args, cfg, data_dict, device,
                   model_class=MultiSceneImplicitDVGO)
    print('Done')


if __name__ == '__main__':
    main()
