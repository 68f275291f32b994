"""Joint multi-scene conditioned driver (v2, the maintained variant): a
joint coarse stage of :class:`.models.dvgo_multiscene.DirectVoxGOMultiScene`
over all scenes (the gather forward; no kernel), then
:class:`.models.tri_dvgo_multiscene.TriDVGOMultiScene` conditioned per step
on 3 random views of a randomly drawn scene, with the consistency, cosine
and distillation losses, per-scene occupancy and the union of the scenes'
camera bboxes. Every scene's ray pool is gathered on the device up front.

  python -m directvoxgo_tpu_torch.run_tri_multiscene_v2 \\
      --config configs/nerf/tri_multiscene.py [--render_test] [--device cpu]

The stage functions take a dataset object (``n_scene``, ``scenes``,
``scene_data(s)``), so a caller can drive them with scenes of its own.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from . import convert
from .config import Config
from .data.datasets import MultisceneBlenderDataset, MultisceneNSVFDataset
from .engine import checkpoint as ckpt_lib
from .engine import render_conditioned as rc
from .engine import train as train_lib
from .engine import train_conditioned as cond_lib
from .models.dvgo_multiscene import DirectVoxGOMultiScene
from .models.tri_dvgo_multiscene import TriDVGOMultiScene
from .run_tri import (config_parser, images_on, model_kwargs_of,
                      render_kwargs_of, setup)


def load_multiscene(cfg, split='train'):
    kind = cfg.data.get('multiscene_dataset', 'multiscene_blender')
    cls = (MultisceneNSVFDataset if kind == 'multiscene_nsvf'
           else MultisceneBlenderDataset)
    return cls(basedir=cfg.data.datadir, split=split,
               down=cfg.data.get('down', 1),
               test_scenes=tuple(cfg.data.get('test_scenes', ())),
               white_bkgd=cfg.data.white_bkgd)


def union_bbox(cfg, dataset):
    """Union of all scenes' camera-frustum bboxes."""
    xyz_min = np.full(3, np.inf, np.float32)
    xyz_max = -xyz_min
    for s in range(dataset.n_scene):
        sc = dataset.scene_data(s)
        mn, mx = train_lib.compute_bbox_by_cam_frustrm(
            cfg=cfg, HW=sc['HW'], Ks=sc['Ks'], poses=sc['poses'],
            i_train=np.arange(len(sc['poses'])), near=sc['near'],
            far=sc['far'])
        xyz_min = np.minimum(xyz_min, mn)
        xyz_max = np.maximum(xyz_max, mx)
    return xyz_min, xyz_max


def shared_near_far(scenes):
    return (min(s['near'] for s in scenes), max(s['far'] for s in scenes))


def coarse_stage(args, cfg, dataset, xyz_min, xyz_max, device):
    """Joint coarse training over all scenes; returns (checkpoint path,
    render kwargs)."""
    cfg_model = cfg.coarse_model_and_render
    cfg_train = cfg.coarse_train
    kw = {k: v for k, v in dict(cfg_model).items()
          if k not in ('num_voxels', 'maskout_near_cam_vox',
                       'world_bound_scale', 'stepsize', 'bbox_thres')}
    model = DirectVoxGOMultiScene(
        xyz_min=xyz_min, xyz_max=xyz_max, n_scene=dataset.n_scene,
        num_voxels=cfg_model.num_voxels, device=device, **kw)
    optimizer = train_lib.create_optimizer_or_freeze_model(model, cfg_train)
    scenes = [dataset.scene_data(s) for s in range(dataset.n_scene)]
    near, far = shared_near_far(scenes)
    render_kwargs = {'near': float(near), 'far': float(far),
                     'bg': 1 if cfg.data.white_bkgd else 0,
                     'stepsize': cfg_model.stepsize}
    if cfg_model.maskout_near_cam_vox:
        for s, sc in enumerate(scenes):
            model.maskout_near_cam_vox(sc['poses'][:, :3, 3], near, s)
    pools = [cond_lib.gather_scene_ray_pool(
        model, cfg, cfg_train, sc, render_kwargs, scene_id=s)
        for s, sc in enumerate(scenes)]
    groups = [n for n in optimizer.groups]
    params = [p for n in groups for p in optimizer.groups[n]['params']]

    def step(pool, sel, scene_id):
        ret = model(pool['rays_o'][sel], pool['rays_d'][sel],
                    pool['viewdirs'][sel], scene_id=scene_id,
                    **render_kwargs)
        loss, mse = cond_lib.conditioned_loss_terms(
            ret, pool['rgb'][sel], cfg_train, cfg_train.N_rand)
        grads = iter(torch.autograd.grad(loss, params))
        optimizer.step({n: [next(grads) for _ in optimizer.groups[n]
                            ['params']] for n in groups})
        return loss.detach(), mse.detach()

    rng = np.random.default_rng(args.seed)
    t0 = time.time()
    for it in range(1, 1 + cfg_train.N_iters):
        if (it + 500) % 1000 == 0:
            model.update_occupancy_cache()
        sid = int(rng.integers(dataset.n_scene))
        pool = pools[sid]
        sel = torch.as_tensor(rng.integers(0, pool['rgb'].shape[0],
                                           cfg_train.N_rand), device=device)
        loss, mse = step(pool, sel, sid)
        if it % args.i_print == 0:
            print(f"coarse joint: iter {it} / Loss {float(loss):.6f} / "
                  f"PSNR {-10 * np.log10(float(mse)):.2f} / "
                  f"Eps {time.time() - t0:.0f}s", flush=True)
    path = os.path.join(cfg.basedir, cfg.expname, 'coarse_last.tar')
    os.makedirs(os.path.dirname(path), exist_ok=True)
    ckpt_lib.save_model_checkpoint(
        path, model, cfg_train.N_iters, convert.opt_state_to_jax(optimizer))
    return path, render_kwargs


def fine_model(args, cfg, dataset, xyz_min, xyz_max, device):
    """TriDVGOMultiScene at the stage's starting resolution, and its
    optimizer."""
    cfg_model = cfg.fine_model_and_render
    cfg_train = cfg.fine_train
    model = TriDVGOMultiScene(
        xyz_min=xyz_min, xyz_max=xyz_max, n_scene=dataset.n_scene,
        num_voxels=cond_lib.initial_num_voxels(args, cfg, cfg_model,
                                               cfg_train, 'fine'),
        mask_cache_path=None, device=device,
        **model_kwargs_of(cfg_model))
    optimizer = train_lib.create_optimizer_or_freeze_model(model, cfg_train)
    return model, optimizer


def aux_weights_of(cfg_train):
    return dict(
        weight_consistency=cfg_train.get('weight_consistency', 0.0),
        weight_cosine=cfg_train.get('weight_cosine', 0.0),
        weight_distillation=cfg_train.get('weight_distillation', 0.0))


def make_cond_source(cfg, scene_of, device, max_on_device=4):
    """Per step: 3 random views of the scene, at a ``down`` drawn from [2,
    ``dynamic_down``) when ``dynamic_down > 2``. A scene's images move to
    the device on first use; the ``max_on_device`` last used stay there."""
    dynamic_down = int(cfg.fine_train.get('dynamic_down', 1))
    on_device = {}

    def cond_source(rng, scene_id):
        sc = scene_of(scene_id)
        views = cond_lib.pick_conditioning_views(rng, len(sc['poses']), k=3)
        down = int(rng.integers(2, dynamic_down)) if dynamic_down > 2 else 1
        images = on_device.pop(scene_id, None)
        if images is None:
            images = images_on(sc, device)
        on_device[scene_id] = images
        while len(on_device) > max_on_device:
            on_device.pop(next(iter(on_device)))
        return cond_lib.build_conditioning_batch(
            images, sc['poses'], sc['HW'], sc['Ks'], views, cfg.data,
            down=down)

    return cond_source


def fine_stage(args, cfg, dataset, xyz_min, xyz_max, device):
    """The conditioned multi-scene fine stage over pools gathered up
    front; returns the model."""
    model, optimizer = fine_model(args, cfg, dataset, xyz_min, xyz_max,
                                  device)
    scenes = [dataset.scene_data(s) for s in range(dataset.n_scene)]
    near, far = shared_near_far(scenes)
    render_kwargs = render_kwargs_of(cfg, near, far)
    pools = [cond_lib.gather_scene_ray_pool(
        model, cfg, cfg.fine_train, sc, render_kwargs, scene_id=s)
        for s, sc in enumerate(scenes)]
    cond_lib.train_conditioned_stage(
        args, cfg, cfg.fine_train, model, optimizer, pools,
        make_cond_source(cfg, scenes.__getitem__, device), render_kwargs,
        stage='fine', aux_weights=aux_weights_of(cfg.fine_train),
        multiscene=True)
    return model


def eval_stage(args, cfg, train_dataset, device, test_dataset=None):
    """Per scene: encode its fixed conditioning views once, then render its
    test views (``render_test_{ckpt}/{scene}``); returns {scene: stats}."""
    ckpt_path = args.ft_path or os.path.join(cfg.basedir, cfg.expname,
                                             'fine_last.tar')
    ckpt_name = os.path.basename(ckpt_path)[:-4]
    model = ckpt_lib.load_model(TriDVGOMultiScene, ckpt_path, device=device)
    if test_dataset is None:
        test_dataset = load_multiscene(cfg, split='test')
    out = {}
    for s in range(min(train_dataset.n_scene, test_dataset.n_scene)):
        tr = train_dataset.scene_data(s)
        te = test_dataset.scene_data(s)
        rk = dict(render_kwargs_of(cfg, te['near'], te['far'], True))
        view_ids = rc.eval_view_ids(cfg.fine_train,
                                    np.arange(len(tr['poses'])),
                                    render=True)
        feats = rc.encode_conditioning(
            model, tr['images'], tr['poses'], tr['HW'], tr['Ks'], view_ids,
            cfg.data, scene_id=s)
        name = str(train_dataset.scenes[s])
        savedir = os.path.join(cfg.basedir, cfg.expname,
                               f'render_test_{ckpt_name}', name)
        os.makedirs(savedir, exist_ok=True)
        rgbs, depths, stats = rc.render_viewpoints_conditioned(
            model, lambda i: feats, render_poses=te['poses'], HW=te['HW'],
            Ks=te['Ks'], render_kwargs=rk, gt_imgs=te['images'],
            savedir=savedir, scene_id=s, eval_ssim=args.eval_ssim,
            eval_lpips_alex=args.eval_lpips_alex,
            eval_lpips_vgg=args.eval_lpips_vgg)
        rc.save_videos(savedir, rgbs, depths)
        out[name] = stats
    return out


def main(argv=None, fine=fine_stage):
    args = config_parser().parse_args(argv)
    cfg = Config.fromfile(args.config)
    device = setup(args)
    os.makedirs(os.path.join(cfg.basedir, cfg.expname), exist_ok=True)
    dataset = load_multiscene(cfg)
    print(f"multiscene dataset: {dataset.n_scene} scenes: {dataset.scenes}")
    xyz_min, xyz_max = union_bbox(cfg, dataset)
    if not args.render_only:
        if cfg.coarse_train.N_iters > 0:
            coarse_stage(args, cfg, dataset, xyz_min, xyz_max, device)
        fine(args, cfg, dataset, xyz_min, xyz_max, device)
    if args.render_test:
        eval_stage(args, cfg, dataset, device)
    print('Done')


if __name__ == '__main__':
    main()
