"""Training engine of the image-conditioned variants (the drivers
``run_sr``, ``run_tri``, ``run_multiscene`` and ``run_tri_multiscene{,_v2}``):
one fine-stage loop parameterized by a conditioning source and the model's
forward.

* The conditioning input is rgb + rays_o + rays_d, 9 channels, the image
  shifted to [-1, 1] (3 channels for SR), NCHW; 3 random (or fixed)
  conditioning views per step, at a ``down`` drawn by the driver. It is
  built on the device from images held there: the rays are generated
  there and the resize is :func:`..ops.resize.area_resize` (OpenCV's
  ``INTER_AREA``), so no step goes through ``cv2``.
* The loss is main + entropy of ``alphainv_last`` + rgbper, plus the
  weighted consistency, cosine and distillation terms of the multi-scene
  model.
* Occupancy renewal at ``(step + 500) % 1000 == 0``; progressive scaling
  at the ``pg_scale`` steps with a fresh optimizer; auto-resume from the
  stage's newest checkpoint.

The random draws (scene, ray batch, views, ``down``) come from one numpy
generator in the JAX engine's order, so a run of either package draws the
same batches from the same seed. Steps run eagerly: every ``down`` gives
the encoder another input shape.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from .. import convert
from .. import rays as ray_lib
from ..device import resolve_device
from ..ops.resize import area_resize
from . import checkpoint as ckpt_lib
from .train import create_optimizer_or_freeze_model


def view_rays(H, W, K, c2w, cfg_data, device):
    """(rays_o, rays_d) ``[H, W, 3]`` of one view on ``device``, as
    :func:`..rays.get_rays` makes them on the host (pixel centres)."""
    if cfg_data.ndc:
        ro, rd, _ = ray_lib.get_rays_of_a_view(
            H, W, K, c2w, ndc=True, inverse_y=cfg_data.inverse_y,
            flip_x=cfg_data.flip_x, flip_y=cfg_data.flip_y)
        return (torch.as_tensor(ro, device=device),
                torch.as_tensor(rd, device=device))
    K = torch.as_tensor(np.asarray(K, np.float32), device=device)
    c2w = torch.as_tensor(np.asarray(c2w, np.float32), device=device)
    j, i = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=device),
                          torch.arange(W, dtype=torch.float32, device=device),
                          indexing="ij")
    i, j = i + 0.5, j + 0.5
    if cfg_data.flip_x:
        i = i.flip(1)
    if cfg_data.flip_y:
        j = j.flip(0)
    u = (i - K[0, 2]) / K[0, 0]
    v = (j - K[1, 2]) / K[1, 1]
    one = torch.ones_like(u)
    dirs = torch.stack([u, v, one] if cfg_data.inverse_y
                       else [u, -v, -one], -1)
    rays_d = dirs @ c2w[:3, :3].T
    return c2w[:3, 3].expand(rays_d.shape), rays_d


def make_conditioning_image(image, rays_o, rays_d, normalize=True):
    """rgb + rays_o + rays_d ``[H, W, 9]`` (the image shifted to [-1, 1])."""
    img = (image - 0.5) / 0.5 if normalize else image
    return torch.cat([img, rays_o, rays_d], -1)


def pick_conditioning_views(rng, n_views, k=3, fixed_idx=None):
    """3 random conditioning views, or the first ``k`` of ``fixed_idx``. An
    empty ``fixed_idx`` (``tri_default.py``'s ``fixed_lr_idx: []``) draws
    at random, as the reference does; the JAX package's drivers take it
    for fixed views and stack none."""
    if fixed_idx:
        return np.asarray(fixed_idx)[:k]
    return rng.choice(n_views, size=k, replace=False)


def build_conditioning_batch(images, poses, HW, Ks, view_ids, cfg_data,
                             down=1, device=None):
    """Stack conditioning views into ``[k, 9, H, W]`` (NCHW) and their poses
    ``[k, 4, 4]``, on the images' device (``images``: a tensor ``[n, H, W,
    3]`` there, or numpy images, uploaded to ``device``)."""
    dev = images.device if torch.is_tensor(images) \
        else resolve_device(device)
    rgb_ch, pose_ch = [], []
    for v in view_ids:
        H, W = (int(x) for x in HW[v])
        img = images[v] if torch.is_tensor(images) else torch.as_tensor(
            np.asarray(images[v], np.float32), device=dev)
        K = np.array(Ks[v], np.float32)
        if down > 1:
            H, W = H // down, W // down
            img = area_resize(img, H, W)
            K[:2] /= down
        rays_o, rays_d = view_rays(H, W, K, poses[v], cfg_data, dev)
        rgb_ch.append(make_conditioning_image(img, rays_o, rays_d)
                      .permute(2, 0, 1))
        pose4 = np.eye(4, dtype=np.float32)
        pose4[:3, :4] = np.asarray(poses[v], np.float32)[:3, :4]
        pose_ch.append(pose4)
    return (torch.stack(rgb_ch, 0),
            torch.as_tensor(np.stack(pose_ch, 0), device=dev))


def conditioned_loss_terms(ret, target, cfg_train, n_rand):
    """(main + entropy + rgbper loss, mse)."""
    mse = torch.mean((ret["rgb_marched"] - target) ** 2)
    loss = cfg_train.weight_main * mse
    if cfg_train.weight_entropy_last > 0:
        pout = torch.clamp(ret["alphainv_last"], 1e-6, 1 - 1e-6)
        ent = -torch.mean(pout * torch.log(pout)
                          + (1 - pout) * torch.log(1 - pout))
        loss = loss + cfg_train.weight_entropy_last * ent
    if cfg_train.weight_rgbper > 0:
        rgbper = torch.sum((ret["raw_rgb"] - target[:, None, :]) ** 2, -1)
        rl = torch.sum(rgbper * ret["weights"].detach()) / n_rand
        loss = loss + cfg_train.weight_rgbper * rl
    return loss, mse


# ------------------------------------------------------------------ resume

def find_resume_checkpoint(args, cfg, stage):
    """The checkpoint a resume loads, or None: ``--ft_path``, else
    ``{stage}_last.tar``, else the newest ``{stage}_*.tar``."""
    expdir = os.path.join(cfg.basedir, cfg.expname)
    path = None
    if getattr(args, "ft_path", ""):
        path = args.ft_path
    elif not getattr(args, "no_reload", False):
        last = os.path.join(expdir, f"{stage}_last.tar")
        if os.path.isfile(last):
            path = last
        elif os.path.isdir(expdir):
            cands = sorted(f for f in os.listdir(expdir)
                           if f.startswith(f"{stage}_")
                           and f.endswith(".tar"))
            if cands:
                path = os.path.join(expdir, cands[-1])
    if path is None or not os.path.isfile(path):
        return None
    return path


def initial_num_voxels(args, cfg, cfg_model, cfg_train, stage):
    """The grid's voxels at construction: a resumed checkpoint's own, else
    ``num_voxels / 2^len(pg_scale)``."""
    path = find_resume_checkpoint(args, cfg, stage)
    if path is not None:
        st = ckpt_lib.load_checkpoint_file(path)
        nv = st.get("model_kwargs", {}).get("num_voxels")
        if nv:
            return int(nv)
    pg = list(cfg_train.get("pg_scale", ()) or ())
    return int(cfg_model.num_voxels / (2 ** len(pg)))


def resume_latest_checkpoint(args, cfg, model, optimizer, stage):
    """Load the stage's checkpoint (:func:`find_resume_checkpoint`) into
    ``model`` and, unless ``--no_reload_optimizer``, ``optimizer``.
    Returns (whether the optimizer state was loaded, start step)."""
    path = find_resume_checkpoint(args, cfg, stage)
    if path is None:
        print(f"train_conditioned ({stage}): train from scratch")
        return False, 0
    st = ckpt_lib.load_checkpoint_file(path)
    state = dict(st["model_state_dict"])
    mask = state.pop("mask")
    model.load_state_dict(convert.params_from_jax(
        state, mask, device=model.device, model=model))
    start = int(st.get("global_step", 0))
    loaded = False
    if not getattr(args, "no_reload_optimizer", False) \
            and st.get("optimizer_state_dict") is not None:
        convert.opt_state_from_jax(st["optimizer_state_dict"], optimizer)
        loaded = True
    print(f"train_conditioned ({stage}): resumed {path} at step {start}")
    return loaded, start


# -------------------------------------------------------------------- loop

def make_cond_train_step(model, optimizer, cfg_train, render_kwargs,
                         aux_weights=None, multiscene=False):
    """One train step ``step(pool, sel, rgb_lr, pose_lr, scene_id) ->
    (loss, mse)`` (0-d tensors): forward on the batch ``sel`` of the pool,
    the loss, the gradient of the trained groups, MaskedAdam."""
    aux = aux_weights or {}
    w_cons = float(aux.get("weight_consistency", 0.0))
    w_cos = float(aux.get("weight_cosine", 0.0))
    w_dist = float(aux.get("weight_distillation", 0.0))
    n_rand = int(cfg_train.N_rand)
    trainable = list(optimizer.groups)
    params = [p for n in trainable for p in optimizer.groups[n]["params"]]

    def step(pool, sel, rgb_lr, pose_lr, scene_id):
        target = pool["rgb"][sel]
        rays = (pool["rays_o"][sel], pool["rays_d"][sel],
                pool["viewdirs"][sel])
        cons = cos = dist = 0.0
        if multiscene:
            ret, cons, cos, dist = model(rgb_lr, pose_lr, *rays,
                                         scene_id=scene_id, **render_kwargs)
        elif pose_lr is not None:
            ret = model(rgb_lr, pose_lr, *rays, **render_kwargs)
        else:
            ret = model(rgb_lr, *rays, **render_kwargs)
        loss, mse = conditioned_loss_terms(ret, target, cfg_train, n_rand)
        loss = loss + w_cons * cons + w_cos * cos + w_dist * dist
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = iter(torch.zeros_like(p) if g is None else g
                     for p, g in zip(params, grads))
        optimizer.step({n: [next(grads) for _ in optimizer.groups[n]
                            ["params"]] for n in trainable})
        return loss.detach(), mse.detach()

    return step


def train_conditioned_stage(args, cfg, cfg_train, model, optimizer,
                            scene_ray_pools, cond_source, render_kwargs,
                            stage, start=0, aux_weights=None,
                            multiscene=False, n_scene=None,
                            scene_sampler=None):
    """The fine-stage loop of a conditioned model; returns (model,
    optimizer).

    ``scene_ray_pools``: a list (per scene) of device pools (``rgb``,
    ``rays_o``, ``rays_d``, ``viewdirs`` [N, 3]), or a callable ``scene_id ->
    pool`` (lazy loading; pass ``n_scene``). ``cond_source(rng, scene_id)
    -> (rgb_lr, pose_lr or None)`` on the device. ``aux_weights``:
    ``weight_consistency``/``weight_cosine``/``weight_distillation`` of the
    multi-scene model. ``scene_sampler(rng, step) -> scene_id`` replaces the
    uniform scene draw (the v1 driver's shuffled epochs).
    """
    if callable(scene_ray_pools):
        get_pool = scene_ray_pools
        assert n_scene is not None, "n_scene required with a pool provider"
    else:
        get_pool = scene_ray_pools.__getitem__
        n_scene = len(scene_ray_pools)
    n_rand = int(cfg_train.N_rand)
    rng = np.random.default_rng(getattr(args, "seed", 777))
    aux = aux_weights or {}
    if float(aux.get("weight_distillation", 0.0)) > 0 \
            and not getattr(model, "use_anchor_liif", False):
        raise ValueError(
            "weight_distillation > 0 but the model has no anchor-LIIF "
            "teacher; set use_anchor_liif=True (+ liif_state_dict) in "
            "fine_model_and_render, or zero the weight")
    if start == 0:
        _, start = resume_latest_checkpoint(args, cfg, model, optimizer,
                                            stage)
    pg_scale = list(cfg_train.get("pg_scale", ()) or ())
    has_grid = getattr(model, "density", None) is not None
    step = make_cond_train_step(model, optimizer, cfg_train, render_kwargs,
                                aux_weights, multiscene)

    psnr_lst = []
    time0 = time.time()
    logdir = os.path.join(cfg.basedir, cfg.expname)
    os.makedirs(logdir, exist_ok=True)
    global_step = -1
    loss = None
    for global_step in range(1 + start, 1 + cfg_train.N_iters):
        if (global_step + 500) % 1000 == 0:
            model.update_occupancy_cache()
        if global_step in pg_scale and has_grid:
            n_rest = len(pg_scale) - pg_scale.index(global_step) - 1
            model.scale_volume_grid(int(
                cfg.fine_model_and_render.num_voxels / (2 ** n_rest)))
            optimizer = create_optimizer_or_freeze_model(model, cfg_train)
            step = make_cond_train_step(model, optimizer, cfg_train,
                                        render_kwargs, aux_weights,
                                        multiscene)

        if scene_sampler is not None:
            scene_id = int(scene_sampler(rng, global_step))
        else:
            scene_id = int(rng.integers(n_scene)) if n_scene > 1 else 0
        pool = get_pool(scene_id)
        sel = torch.as_tensor(rng.integers(0, pool["rgb"].shape[0], n_rand),
                              device=pool["rgb"].device)
        rgb_lr, pose_lr = cond_source(rng, scene_id)
        loss, mse = step(pool, sel, rgb_lr, pose_lr, scene_id)
        psnr_lst.append(-10.0 * torch.log10(mse))

        if global_step % args.i_print == 0:
            psnr_avg = float(torch.stack(psnr_lst).mean())
            print(f"train_conditioned ({stage}): iter {global_step:6d} / "
                  f"Loss: {float(loss):.9f} / PSNR: {psnr_avg:5.2f} / "
                  f"Eps: {time.time() - time0:.0f}s", flush=True)
            psnr_lst = []
        if global_step % args.i_weights == 0:
            ckpt_lib.save_model_checkpoint(
                os.path.join(logdir, f"{stage}_{global_step:06d}.tar"),
                model, global_step, convert.opt_state_to_jax(optimizer))

    if global_step != -1:
        ckpt_lib.save_model_checkpoint(
            os.path.join(logdir, f"{stage}_last.tar"), model, global_step,
            convert.opt_state_to_jax(optimizer))
    return model, optimizer


def gather_scene_ray_pool(model, cfg, cfg_train, scene, render_kwargs,
                          scene_id=None):
    """One scene's training rays (``in_maskcache``: those that hit the
    model's occupancy) flattened into a pool on the model's device."""
    chunks = {"rgb": [], "rays_o": [], "rays_d": [], "viewdirs": []}
    for img, c2w, (H, W), K in zip(scene["images"], scene["poses"],
                                   scene["HW"], scene["Ks"]):
        rays_o, rays_d, viewdirs = ray_lib.get_rays_of_a_view(
            H, W, K, c2w, ndc=cfg.data.ndc, inverse_y=cfg.data.inverse_y,
            flip_x=cfg.data.flip_x, flip_y=cfg.data.flip_y)
        if cfg_train.ray_sampler == "in_maskcache":
            kw = dict(render_kwargs)
            if scene_id is not None:
                kw["scene_id"] = scene_id
            mask = np.asarray(model.hit_coarse_geo(
                rays_o.reshape(-1, 3), rays_d.reshape(-1, 3),
                **{k: kw[k] for k in ("near", "far", "stepsize", "scene_id")
                   if k in kw})).reshape(H, W)
        else:
            mask = np.ones((H, W), bool)
        img = img.cpu().numpy() if torch.is_tensor(img) else img
        chunks["rgb"].append(np.asarray(img, np.float32)[mask])
        chunks["rays_o"].append(rays_o[mask])
        chunks["rays_d"].append(rays_d[mask])
        chunks["viewdirs"].append(viewdirs[mask])
    return {k: torch.as_tensor(np.concatenate(v), device=model.device)
            for k, v in chunks.items()}
