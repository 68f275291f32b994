"""Training engine: coarse -> fine per-scene optimisation.

One stage (:func:`scene_rep_reconstruction`) builds the model and its
MaskedAdam, gathers the training rays into a pool on the device, and runs
the step loop: every step draws an index batch of rays that share a sweep
axis (:mod:`.draws`), renders it through the station sweep (kernel K-A),
backpropagates (kernel K-C under ``station_sweep``'s backward) and updates
the parameters in place. Around the steps it keeps the schedule of the JAX
package's engine: per-voxel learning rates from the view count, the
occupancy clip box with its hysteresis, mask renewal, progressive scaling
with a fresh optimizer, TV state flips, progress lines and checkpoints.

Steps come in chunks, as the JAX engine dispatches them (its step
batching): :func:`chunk_len` cuts up to ``Draws.dispatch_width()`` steps
(8 on grids of up to 1.1 M voxels, else 1, re-evaluated at every
progressive rescale) that share one axis draw and cross no event. On a
CUDA device every unfused step key replays as a CUDA graph of its step
(:mod:`.graphs`), the port's counterpart of the JAX engine's one dispatch;
the CPU runs the same steps eagerly.

The draws are the JAX engine's default ones (:mod:`.draws`): on grids of
more than 1.1 M voxels (or with ``steps_per_dispatch`` 1) a batch is one
spatially sorted segment of one window class, trained as a composed clip
box (``(bp, eu, ev)``) or as per-p-block windows (``('blk', B, eu, ev)``).
PyTorch runs eagerly, so there is nothing to compile ahead of a step and no
remote dispatch to hide: the JAX engine's precompile queue, compile epochs
and background sorts have no counterpart here; every window class is
drawable from the first step.

With ``DVGO_FUSED_TRAIN`` set (:func:`..ops.train_fused.fused_enabled`) a
stage whose model supports it trains through the fused step (kernels K-D
and K-E) where windows engage, as the JAX engine does: each axis group is
cut into same-class, direction-uniform 512-ray tiles over the clip box
(:func:`..ops.sweep.build_ray_tiles_blocktile`), a batch is ``N_rand / 512``
tiles of one class, drawn in proportion to the class's ray count; tiles no
class covers train through the unfused step, re-bucketed into windows
where windows engage.

Forward-facing (NDC) configs train :class:`..models.dmpigo.DirectMPIGO`,
whose rays all sweep along z (``forced_sweep_axis``); its LLFF schedule
adds the TV gradient on every step (kernel K-F: dense over the whole grid,
sparse over the whole grid, or sparse over the drawn box).

A model with ``query_mode='gather'`` (the config's ``*_model_and_render``
key; grid-LIIF colour forces it) trains through the gather forward
(:meth:`..models.dvgo.DirectVoxGO.forward`), as the JAX engine does: every
batch is drawn from the whole pool (:class:`.Draws`' gather draws), the
step key is ``(None, None)`` (no sweep axis, no clip box), the TV gradient
and MaskedAdam cover whole grids, and the per-voxel lr takes the exact view
count. Its key replays as a CUDA graph like every unfused key.

With a :class:`..parallel.DataMesh` (``--data_parallel``) a stage trains
data-parallel over rays, one rank per card: each rank renders its block of
every batch and the gradients meet in one all-reduce a step
(:func:`make_train_step`'s ``group``). The fused step keys run eagerly:
their box offsets are host data into K-D and K-E.

The pulls from the device that the loop waits on (the mask's bbox, the
progress line's loss, the checkpoints) run under the opt-in watchdog of
:mod:`.fetchguard`.
"""

from __future__ import annotations

import copy
import os
import time

import numpy as np
import torch

from .. import convert
from .. import rays as ray_lib
from ..device import resolve_device
from ..models.dmpigo import DirectMPIGO
from ..models import mlp as mlp_lib
from ..models.dvgo import DirectVoxGO
from ..ops import grid as grid_ops
from ..ops import sweep as sweep_ops
from ..ops import tv as tv_ops
from ..optim import MaskedAdam
from ..parallel import (all_reduce_mean, replica_spread, replicate,
                        shard_rays)
from . import checkpoint as ckpt_lib
from . import fetchguard
from .draws import Draws
from .graphs import StepGraphs


def compute_bbox_by_cam_frustrm(cfg, HW, Ks, poses, i_train, near, far,
                                **kwargs):
    """Union of the train views' frustum corners at near and far."""
    xyz_min = np.full(3, np.inf, np.float32)
    xyz_max = -xyz_min
    for (H, W), K, c2w in zip(HW[i_train], Ks[i_train], poses[i_train]):
        rays_o, rays_d, viewdirs = ray_lib.get_rays_of_a_view(
            H=H, W=W, K=K, c2w=c2w, ndc=cfg.data.ndc,
            inverse_y=cfg.data.inverse_y,
            flip_x=cfg.data.flip_x, flip_y=cfg.data.flip_y)
        if cfg.data.ndc:
            pts_nf = np.stack([rays_o + rays_d * near, rays_o + rays_d * far])
        else:
            pts_nf = np.stack([rays_o + viewdirs * near,
                               rays_o + viewdirs * far])
        xyz_min = np.minimum(xyz_min, pts_nf.min(axis=(0, 1, 2)))
        xyz_max = np.maximum(xyz_max, pts_nf.max(axis=(0, 1, 2)))
    print("compute_bbox_by_cam_frustrm: xyz_min", xyz_min)
    print("compute_bbox_by_cam_frustrm: xyz_max", xyz_max)
    return xyz_min, xyz_max


def compute_bbox_by_coarse_geo(model_class, model_path, thres, device=None):
    """Shrink the fine bbox to the coarse ``alpha > thres`` region."""
    model = ckpt_lib.load_model(model_class, model_path, device=device)
    with torch.no_grad():
        alpha = model.activate_density(model.density).cpu().numpy()
        pts = model.grid_points().cpu().numpy()
    mask = alpha > thres
    if not mask.any():
        xyz_min, xyz_max = np.asarray(model.xyz_min), np.asarray(model.xyz_max)
    else:
        active = pts[mask]
        xyz_min, xyz_max = active.min(0), active.max(0)
        # a near-zero extent (very few voxels over the threshold) is padded
        # to at least one voxel per axis
        pad = np.maximum(model.voxel_size - (xyz_max - xyz_min), 0.0) / 2
        xyz_min, xyz_max = xyz_min - pad, xyz_max + pad
    print("compute_bbox_by_coarse_geo: xyz_min", xyz_min)
    print("compute_bbox_by_coarse_geo: xyz_max", xyz_max)
    return xyz_min, xyz_max


def model_class_for(cfg):
    """DirectMPIGO for forward-facing (NDC) configs, else DirectVoxGO."""
    return DirectMPIGO if cfg.data.ndc else DirectVoxGO


def _param_groups(model):
    """name -> the grid parameter or the module of each group, in the JAX
    pytree's names (the conditioned models list theirs in
    ``jax_groups()``)."""
    if hasattr(model, "jax_groups"):
        return model.jax_groups()
    groups = {"density": model.density, "k0": model.k0}
    if model.rgbnet is not None:
        groups["rgbnet"] = model.rgbnet
    return groups


def create_optimizer_or_freeze_model(model, cfg_train):
    """The ``lrate_<name>`` convention: keys with lr > 0 become parameter
    groups; lr == 0 freezes the parameter (no gradient, no update)."""
    params = _param_groups(model)
    groups = {}
    for key in list(cfg_train.keys()):
        if not key.startswith("lrate_"):
            continue
        name = key[len("lrate_"):]
        if name not in params:
            continue
        lr = float(cfg_train[key])
        if lr > 0:
            print(f"create_optimizer_or_freeze_model: param {name} lr {lr}")
            obj = params[name]
            module = obj if isinstance(obj, torch.nn.Module) else None
            groups[name] = {
                "params": [obj] if module is None else list(
                    module.parameters()),
                "module": module, "lr": lr,
                "skip_zero_grad": name in cfg_train.get(
                    "skip_zero_grad_fields", []),
            }
        else:
            print(f"create_optimizer_or_freeze_model: param {name} freeze")
    decay_steps = cfg_train.lrate_decay * 1000
    return MaskedAdam(groups, lr_decay_factor=0.1 ** (1.0 / decay_steps))


def make_train_step(model, optimizer, cfg_train, render_kwargs,
                    apply_tv, tv_dense, axis=None, clip_sizes=None, wv=0,
                    group=None):
    """Build the train step of the current phase:
    ``step(pool, sel, clip_off, v_base=None) -> (loss, psnr)`` (0-d
    tensors, not synchronised) gathers the batch ``sel`` from the device
    ray ``pool``, renders it along the static sweep ``axis``, adds the TV
    gradients when ``apply_tv``, and updates ``model`` and ``optimizer`` in
    place.

    ``clip_sizes`` (permuted order) bounds the sweep to the occupancy box
    whose start voxels arrive as ``clip_off``: host integers, or an int32
    tensor on the model's device. The step reads them as device data
    wherever it cuts a box (the grids' boxes through their flat voxel
    indices, the rays' shift, K-F's boxed TV, the Adam region), and reads
    no other value from the host, so that :mod:`.graphs` can capture it as
    a CUDA graph whose replays take each draw's offsets. Region mode: when
    every trainable grid is a ``skip_zero_grad`` group (and TV is off or
    sparse), the step differentiates with respect to the box slices of the
    grids, so gradients and the Adam update stay box-sized; exact because
    the sweep reads nothing outside the box and ``skip_zero_grad`` leaves
    untouched voxels alone. Plain Adam decays moments everywhere, so those
    steps keep full-size gradients (zero outside the box) and a full-grid
    update. A window draw is an ordinary ``clip_sizes`` box, ``(bp, eu,
    ev)`` at the drawn offsets. ``clip_sizes = ('blk', B, eu, ev)`` selects
    the blocked step: B per-p-block windowed sub-sweeps of the whole grid
    (:meth:`DirectVoxGO.forward_sweep`'s ``block_windows``) whose (u, v)
    starts arrive as ``clip_off`` [B, 2]; it keeps full-size gradients.
    ``wv > 0`` passes ``(v_base, wv)`` ray-tile windows to unclipped
    sweeps (no engine draw sets it; the window draws ride the clip box).

    ``clip_sizes = ('fblk', wu, wv, bp, bu, bv)`` selects the fused step
    (:meth:`DirectVoxGO.forward_sweep_fused`, kernels K-D and K-E) over the
    (bp, bu, bv) box with per-cell (wu, wv) windows, (0, 0) for none. Its
    batches must be same-class and direction-uniform
    (:func:`..ops.sweep.build_ray_tiles_blocktile`), and it needs region
    mode: the kernels take the box slices of the grids. Its offsets are
    host data (the fused keys run eagerly).

    ``axis=None`` (with ``clip_sizes`` None) selects the gather step: the
    batch through :meth:`..models.dvgo.DirectVoxGO.forward`, the per-point
    colour loss from its ``raw_rgb``, whole-grid TV and a whole-grid
    update; ``clip_off`` is ignored.

    ``group`` (a :class:`..parallel.DataMesh`, or None) makes the step
    data-parallel, the counterpart of the JAX step's ``mesh``: every rank
    is given the same ``sel`` (and ``v_base``) and takes its contiguous
    block of it, renders that, and normalises every loss term by its own
    ray count; the gradients, the loss and the MSE then go through one
    all-reduce (:func:`..parallel.all_reduce_mean`), before the TV term and
    the optimizer, which so see the full batch's gradient (TV's gate and
    ``skip_zero_grad`` included: a voxel only another rank's rays touched
    updates on every rank). Loss and PSNR are of the ranks' mean. The
    gradient sums that one card rounds to bf16 (the sweep's grid cotangent,
    the colour MLP's weights: :mod:`..ops.rounding`) cross the all-reduce
    in f32 and are rounded after it, so that a group of one rank steps bit
    for bit as no group does, and N ranks as one up to the order of f32
    sums. Under NCCL the collective can be captured with the step
    (:mod:`.graphs`).
    """
    gather = axis is None
    assert not gather or clip_sizes is None, \
        "the gather step takes no clip box"
    fused, fused_win, blocked = False, None, None
    if clip_sizes is not None and clip_sizes[0] == "blk":
        blocked = tuple(int(x) for x in clip_sizes[1:])     # (B, eu, ev)
        clip_sizes = None
    if clip_sizes is not None and clip_sizes[0] == "fblk":
        wu_f, wv_f = int(clip_sizes[1]), int(clip_sizes[2])
        fused_win = (wu_f, wv_f) if (wu_f or wv_f) else None
        clip_sizes = tuple(int(x) for x in clip_sizes[3:6])
        fused = True
    kwargs = {k: render_kwargs[k] for k in ("near", "far", "bg", "stepsize")}
    w_main = float(cfg_train.weight_main)
    w_entropy = float(cfg_train.weight_entropy_last)
    w_rgbper = float(cfg_train.weight_rgbper)
    w_tv_density = float(cfg_train.weight_tv_density)
    w_tv_k0 = float(cfg_train.weight_tv_k0)
    n_rand = int(cfg_train.N_rand)
    if group is not None:
        block = group.block(n_rand)
    # the rays of this rank's share of a batch: every loss term's count
    n_loc = n_rand if group is None else n_rand // group.world
    trainable = list(optimizer.groups)
    grid_names = [n for n in ("density", "k0") if n in trainable]
    all_skip = all(bool(optimizer.groups[n].get("skip_zero_grad", False))
                   for n in grid_names)
    tv_boxed = apply_tv and not tv_dense
    # A data-parallel sweep step reduces the ranks' unrounded f32 gradient
    # sums of the bf16 paths (grid cotangents, the MLP's weights) and rounds
    # their mean where one card rounds its batch's sum: group -> dtype (or
    # None) of each of its parameters' gradients.
    f32_cot = group is not None and not gather and not fused
    round_after = {}
    if f32_cot:
        sdt = getattr(model, "sweep_dtype", torch.float32)
        if sdt != torch.float32:
            round_after.update({n: [sdt] for n in grid_names})
        mdt = getattr(model, "mlp_dtype", None)
        if mdt is not None and "rgbnet" in trainable:
            rounded = {id(p) for p in mlp_lib.split_cl_rounded(model.rgbnet)}
            round_after["rgbnet"] = [
                mdt if id(p) in rounded else None
                for p in optimizer.groups["rgbnet"]["params"]]
    region_mode = (clip_sizes is not None and (not apply_tv or tv_boxed)
                   and all_skip and grid_names != [])
    assert not fused or region_mode, \
        "fused step keys require region mode (pre-clipped box grids)"
    dev = model.density.device
    if region_mode:
        inv = {ax: i for i, ax in enumerate(sweep_ops._PERMS[axis])}
        sizes_xyz = tuple(int(clip_sizes[inv[a]]) for a in range(3))
        # the permuted offsets' positions of x, y, z (made here, outside
        # any capture)
        inv_t = torch.as_tensor([inv[a] for a in range(3)], device=dev)

    def host_boxes(clip_off):
        """The fused step's box slices of the grids (host offsets)."""
        offs_xyz = tuple(int(clip_off[inv[a]]) for a in range(3))
        box = tuple(slice(o, o + s) for o, s in zip(offs_xyz, sizes_xyz))
        boxed = {n: getattr(model, n).detach()[box]
                 for n in ("density", "k0")}
        return boxed, model.mask[box], (offs_xyz, sizes_xyz)

    def train_step(pool, sel, clip_off, v_base=None):
        if group is not None:
            sel = sel[block[0]:block[1]]
            if v_base is not None:
                v_base = shard_rays(group, v_base)
        target = pool["rgb"][sel]
        rays_o, rays_d = pool["rays_o"][sel], pool["rays_d"][sel]
        viewdirs = pool["viewdirs"][sel]
        if fused:
            clip_off = np.asarray(clip_off.cpu() if torch.is_tensor(clip_off)
                                  else clip_off, np.int32)
        elif not torch.is_tensor(clip_off):
            clip_off = torch.as_tensor(np.asarray(clip_off, np.int32),
                                       device=dev)

        leaves = {n: list(optimizer.groups[n]["params"]) for n in trainable}
        grids = region = None
        if fused:
            boxed, mask_box, region = host_boxes(clip_off)
        elif region_mode:
            region = grid_ops.DeviceBox(clip_off, sizes_xyz,
                                        model.world_size,
                                        sweep_ops._PERMS[axis])
            boxed = {n: region.take(getattr(model, n).detach())
                     for n in ("density", "k0")}
            mask_box = region.take(model.mask)
        if region_mode:
            for n in grid_names:
                boxed[n].requires_grad_(True)
                leaves[n] = [boxed[n]]
            grids = (boxed["density"], boxed["k0"], mask_box)

        with torch.enable_grad():
            if gather:
                ret = model(rays_o, rays_d, viewdirs, **kwargs)
            elif fused:
                ret = model.forward_sweep_fused(
                    rays_o, rays_d, viewdirs, axis, target, grids=grids,
                    clip_offsets=clip_off, window=fused_win, **kwargs)
            elif blocked is not None:
                ret = model.forward_sweep(
                    rays_o, rays_d, viewdirs, axis, block_windows=(
                        blocked, (clip_off[:, 0], clip_off[:, 1])),
                    f32_cot=f32_cot, **kwargs)
            else:
                ret = model.forward_sweep(
                    rays_o, rays_d, viewdirs, axis, clip_sizes=clip_sizes,
                    clip_offsets=clip_off, grids_pre_clipped=region_mode,
                    tile_windows=((v_base, wv) if wv and v_base is not None
                                  else None),
                    grids=grids, f32_cot=f32_cot, **kwargs)
            mse = torch.mean((ret["rgb_marched"] - target) ** 2)
            loss = w_main * mse
            if w_entropy > 0:
                pout = torch.clamp(ret["alphainv_last"], 1e-6, 1 - 1e-6)
                entropy = -torch.mean(pout * torch.log(pout)
                                      + (1 - pout) * torch.log(1 - pout))
                loss = loss + w_entropy * entropy
            if w_rgbper > 0:
                if "rgbper_sum" in ret:   # fused step: reduced per ray
                    rgbper_loss = torch.sum(ret["rgbper_sum"]) / n_loc
                elif gather:              # raw_rgb [N, K, 3]
                    rgbper = torch.sum(
                        (ret["raw_rgb"] - target[:, None, :]) ** 2, -1)
                    rgbper_loss = torch.sum(
                        rgbper * ret["weights"].detach()) / n_loc
                else:
                    rgbper = torch.sum(
                        (ret["raw_rgb_cl"] - target.t()[:, :, None]) ** 2, 0)
                    rgbper_loss = torch.sum(
                        rgbper * ret["weights"].detach()) / n_loc
                loss = loss + w_rgbper * rgbper_loss
            flat = [p for n in trainable for p in leaves[n]]
            flat_grads = torch.autograd.grad(loss, flat, allow_unused=True)
        it = iter(flat_grads)
        grads = {n: [torch.zeros_like(p) if g is None else g
                     for p, g in zip(leaves[n], it)] for n in trainable}
        loss, mse = loss.detach(), mse.detach()
        if group is not None:
            # the full batch's gradient on every rank, before TV and Adam
            red = iter(all_reduce_mean(
                group, [g for n in trainable for g in grads[n]]
                + [loss.reshape(1), mse.reshape(1)]))
            grads = {n: [next(red) for _ in grads[n]] for n in trainable}
            loss, mse = next(red)[0], next(red)[0]
            for n, rnd in round_after.items():
                grads[n] = [g.to(rnd[i]).float() if rnd[i] else g
                            for i, g in enumerate(grads[n])]

        with torch.no_grad():
            if apply_tv and region_mode:
                # Boxed sparse TV: the term on the box, its neighbours read
                # from the full grid (edge voxels of the box need their
                # true neighbours), gated by the batch gradient.
                offs_xyz = (region[0] if fused else
                            clip_off.index_select(0, inv_t).contiguous())
                sx, sy, sz = model.tv_axis_scales()
                for name, wn in (("density", w_tv_density), ("k0", w_tv_k0)):
                    if wn <= 0 or name not in grads:
                        continue
                    grads[name] = [tv_ops.tv_add_grad_box(
                        getattr(model, name).detach(), grads[name][0],
                        offs_xyz, wn / n_rand * sx, wn / n_rand * sy,
                        wn / n_rand * sz)]
            elif apply_tv:
                if w_tv_density > 0 and "density" in grads:
                    grads["density"] = [model.density_total_variation_grad(
                        model.density, grads["density"][0],
                        w_tv_density / n_rand, tv_dense)]
                # (an empty k0, the fully implicit colour's, has no term)
                if w_tv_k0 > 0 and "k0" in grads and model.k0.numel():
                    grads["k0"] = [model.k0_total_variation_grad(
                        model.k0, grads["k0"][0], w_tv_k0 / n_rand,
                        tv_dense)]
            regions = ({n: region for n in grid_names}
                       if region_mode else None)
            optimizer.step(grads, regions=regions)
            psnr = -10.0 * torch.log10(mse)
        return loss, psnr

    return train_step


def chunk_len(i, n_dispatch, n_iters, pg_set, tv_state_of, i_print,
              i_weights):
    """Steps of the chunk that starts at step ``i`` (the JAX engine's
    ``chunk_len``): up to ``n_dispatch``, never crossing a progressive
    rescale, a mask renewal or a TV-state change, ending on ``i_print`` and
    ``i_weights`` steps and at ``n_iters``; quantised to {1,
    n_dispatch}."""
    length = 1
    while length < n_dispatch:
        j = i + length
        if (j > n_iters or j in pg_set or (j + 500) % 1000 == 0
                or tv_state_of(j) != tv_state_of(i)
                or (j - 1) % i_print == 0 or (j - 1) % i_weights == 0):
            break
        length += 1
    return length if length == n_dispatch else 1


def gather_training_rays(model, cfg, cfg_train, data_dict, render_kwargs):
    """Assemble the training ray pool (numpy) per the configured sampler."""
    images = data_dict["images"]
    HW, Ks, poses = data_dict["HW"], data_dict["Ks"], data_dict["poses"]
    i_train = data_dict["i_train"]
    if data_dict["irregular_shape"]:
        rgb_tr_ori = [np.asarray(images[i], np.float32) for i in i_train]
    else:
        rgb_tr_ori = np.asarray(images, np.float32)[i_train]
    common = dict(train_poses=poses[i_train], HW=HW[i_train], Ks=Ks[i_train],
                  ndc=cfg.data.ndc, inverse_y=cfg.data.inverse_y,
                  flip_x=cfg.data.flip_x, flip_y=cfg.data.flip_y)
    sampler = cfg_train.ray_sampler
    if sampler == "in_maskcache":
        out = ray_lib.get_training_rays_in_maskcache_sampling(
            rgb_tr_ori=rgb_tr_ori, model=model, render_kwargs=render_kwargs,
            **common)
        if len(out[0]) == 0:
            # coarse geometry below mask_cache_thres everywhere (a very
            # short coarse stage) would starve training
            print("gather_training_rays: in_maskcache pool empty, "
                  "falling back to 'flatten'")
            sampler = "flatten"
    if sampler == "flatten":
        out = ray_lib.get_training_rays_flatten(rgb_tr_ori=rgb_tr_ori,
                                                **common)
    elif sampler == "random":
        out = ray_lib.get_training_rays(rgb_tr=rgb_tr_ori, **common)
    return out


def scene_rep_reconstruction(args, cfg, cfg_model, cfg_train, xyz_min,
                             xyz_max, data_dict, stage,
                             coarse_ckpt_path=None, device=None, mesh=None):
    """One optimisation stage; returns the trained model. On a CUDA device
    its unfused steps replay as CUDA graphs (:mod:`.graphs`).

    ``mesh`` (a :class:`..parallel.DataMesh`, or None) trains the stage
    data-parallel, with the JAX engine's rules: N_rand must split over the
    ranks (else the stage runs whole on every rank, as on one card),
    window buckets need whole ray tiles per rank, forced-axis 2D buckets
    are off, fused tiles need ``N_rand % (512 * world) == 0``. Every rank
    builds the pool, the view count and the draws; rank 0's state is
    broadcast once as a guard; only rank 0 prints progress and writes
    checkpoints. Under NCCL the steps replay as CUDA graphs with their
    all-reduce captured; under gloo they run eagerly."""
    device = resolve_device(device)
    writer = mesh is None or mesh.rank == 0
    t_stage = time.time()
    if stage == "fine" and not cfg.fine_model_and_render.get(
            "use_coarse_geo", True):
        coarse_ckpt_path = None
    if abs(cfg_model.world_bound_scale - 1) > 1e-9:
        xyz_shift = (xyz_max - xyz_min) * (cfg_model.world_bound_scale - 1) / 2
        xyz_min, xyz_max = xyz_min - xyz_shift, xyz_max + xyz_shift
    near, far = data_dict["near"], data_dict["far"]
    poses, i_train = data_dict["poses"], data_dict["i_train"]

    logdir = os.path.join(cfg.basedir, cfg.expname)
    last_ckpt_path = os.path.join(logdir, f"{stage}_last.tar")
    if args.no_reload:
        reload_ckpt_path = None
    elif getattr(args, "ft_path", ""):
        reload_ckpt_path = args.ft_path
    elif os.path.isfile(last_ckpt_path):
        reload_ckpt_path = last_ckpt_path
    else:
        # an interrupted run resumes from its newest i_weights checkpoint,
        # if it was written for the model this config builds
        reload_ckpt_path = ckpt_lib.newest_numbered_checkpoint(logdir, stage)
        if reload_ckpt_path is not None:
            ckpt_lib.check_numbered_resume(reload_ckpt_path, cfg_model)

    if reload_ckpt_path is None:
        print(f"scene_rep_reconstruction ({stage}): train from scratch")
        start = 0
        model_kwargs = copy.deepcopy(dict(cfg_model))
        num_voxels = model_kwargs.pop("num_voxels")
        if len(cfg_train.pg_scale):
            num_voxels = int(num_voxels / (2 ** len(cfg_train.pg_scale)))
        model = model_class_for(cfg)(
            xyz_min=xyz_min, xyz_max=xyz_max, num_voxels=num_voxels,
            mask_cache_path=coarse_ckpt_path, device=device, **model_kwargs)
        if not cfg.data.ndc and cfg_model.maskout_near_cam_vox:
            model.maskout_near_cam_vox(poses[i_train, :3, 3], near)
        optimizer = create_optimizer_or_freeze_model(model, cfg_train)
    else:
        print(f"scene_rep_reconstruction ({stage}): reload from "
              f"{reload_ckpt_path}")
        st = ckpt_lib.load_checkpoint_file(reload_ckpt_path)
        model = ckpt_lib.load_model(model_class_for(cfg), reload_ckpt_path,
                                    device=device)
        optimizer = create_optimizer_or_freeze_model(model, cfg_train)
        start = int(st["global_step"])
        if not args.no_reload_optimizer and st.get("optimizer_state_dict"):
            convert.opt_state_from_jax(st["optimizer_state_dict"], optimizer)
        if start >= cfg_train.N_iters:
            return model     # nothing left to train in this stage

    render_kwargs = {
        "near": float(near), "far": float(far),
        "bg": 1 if cfg.data.white_bkgd else 0,
        "stepsize": cfg_model.stepsize,
        "inverse_y": cfg.data.inverse_y,
        "flip_x": cfg.data.flip_x, "flip_y": cfg.data.flip_y,
    }
    rgb_tr, rays_o_tr, rays_d_tr, viewdirs_tr, imsz = gather_training_rays(
        model, cfg, cfg_train, data_dict, render_kwargs)

    # Data parallelism over rays: every rank takes its block of each batch.
    group = None
    if mesh is not None:
        if cfg_train.N_rand % mesh.world:
            print(f"data_parallel: N_rand={cfg_train.N_rand} not divisible "
                  f"by {mesh.world} devices; running single-chip")
        else:
            group = mesh
            print(f"data_parallel: sharding ray batches over {mesh.world} "
                  "devices")

    # The ray pool lives on the device; a step uploads only its indices.
    rays_d_np = np.asarray(rays_d_tr).reshape(-1, 3)

    def to_dev(x):
        return torch.as_tensor(np.ascontiguousarray(
            np.asarray(x, np.float32).reshape(-1, 3)), device=device)

    pool = {"rgb": to_dev(rgb_tr), "rays_o": to_dev(rays_o_tr),
            "rays_d": to_dev(rays_d_np), "viewdirs": to_dev(viewdirs_tr)}
    rng = np.random.default_rng(getattr(args, "seed", 777))
    # Occupancy-bbox sweep clipping: refreshed when the mask changes.
    clip_plan = {}   # axis -> (sizes or None, offsets int32[3])
    draws = Draws(model, cfg_train, cfg_model, rays_o_tr, rays_d_np, near,
                  far, rng, clip_plan, device, stage,
                  world=1 if group is None else group.world)

    # View-count-based per-voxel lr; voxels seen by at most two views are
    # switched off.
    if cfg_train.pervoxel_lr:
        t0 = time.time()
        cnt = model.voxel_count_views(
            rays_o_tr=rays_o_tr, rays_d_tr=rays_d_tr, imsz=imsz,
            near=near, far=far, stepsize=cfg_model.stepsize,
            downrate=cfg_train.pervoxel_lr_downrate,
            irregular_shape=data_dict["irregular_shape"])
        optimizer.set_pervoxel_lr(cnt)
        with torch.no_grad():
            model.density.masked_fill_(cnt <= 2, -100.0)
        print(f"scene_rep_reconstruction ({stage}): voxel_count_views in "
              f"{time.time() - t0:.1f} s")
    if group is not None:
        st = optimizer.state
        replicate(group, [*model.parameters(), *model.buffers(), st["step"],
                          *(t for d in (st["exp_avg"], st["exp_avg_sq"])
                            for ts in d.values() for t in ts)]
                  + ([] if st["per_lr"] is None else [st["per_lr"]]))

    gather = model.query_mode != "sweep"

    def refresh_clip():
        if gather:       # no sweep, no clip box
            return
        bb = fetchguard.guarded_get(grid_ops.mask_bbox_vox_device(
            model.mask), "mask bbox").numpy()
        bbox = (bb[0].astype(np.float64), bb[1].astype(np.float64))
        for ax in range(3):
            new = model.sweep_clip_for_axis(ax, bbox=bbox)
            old = clip_plan.get(ax)
            if old is not None and old[0] is not None \
                    and new[0] is not None and old[0] != new[0] \
                    and np.prod(new[0]) > 0.7 * np.prod(old[0]):
                # Renewals only shrink the mask within a stage: keep the
                # box shape (offsets refit) unless tightening buys at least
                # 30% of the sweep volume.
                kept = model.sweep_clip_for_axis(ax, fixed_sizes=old[0],
                                                 bbox=bbox)
                if kept[0] is not None:
                    new = kept
            clip_plan[ax] = new

    refresh_clip()
    draws.set_grid()
    pg_set = set(cfg_train.pg_scale)

    def tv_state_of(j):
        apply_tv = (j < cfg_train.tv_before and j > cfg_train.tv_after
                    and j % cfg_train.tv_every == 0
                    and (cfg_train.weight_tv_density > 0
                         or cfg_train.weight_tv_k0 > 0))
        return (apply_tv, j < cfg_train.tv_dense_before)

    print(f"scene_rep_reconstruction ({stage}): setup in "
          f"{time.time() - t_stage:.1f} s")
    psnr_lst = []
    # gloo's collectives cannot be captured in a CUDA graph
    steps = StepGraphs(device, graphed=group is None or group.graphable)
    if group is not None and not group.graphable \
            and torch.device(device).type == "cuda":
        print(f"data_parallel: {group.backend} collectives cannot be "
              "captured in CUDA graphs; the steps run eagerly")

    def fresh_steps():
        # the whole grid's voxels and the sweep's channels: K-C's largest
        # scratch of the stage (the gather step runs no K-C)
        steps.reset(scratch=None if gather else (
            int(np.prod(model.world_size)), 2 + model.k0_dim))
        return {}

    train_steps = fresh_steps()   # (axis, clip sizes) -> step of the tv state
    tv_state = None
    loss = None
    time0 = time.time()
    global_step = start
    while global_step < cfg_train.N_iters:
        global_step += 1
        # occupancy renewal
        if (global_step + 500) % 1000 == 0:
            model.update_occupancy_cache()
            refresh_clip()

        # progressive scaling: new grids, a fresh optimizer, density - 1
        if global_step in pg_set:
            n_rest_scales = len(cfg_train.pg_scale) \
                - list(cfg_train.pg_scale).index(global_step) - 1
            cur_voxels = int(cfg_model.num_voxels / (2 ** n_rest_scales))
            if hasattr(model, "mpi_depth"):
                model.scale_volume_grid(cur_voxels, model.mpi_depth)
            else:
                model.scale_volume_grid(cur_voxels)
            optimizer = create_optimizer_or_freeze_model(model, cfg_train)
            with torch.no_grad():
                model.density.sub_(1.0)
            train_steps = fresh_steps()
            clip_plan.clear()
            refresh_clip()
            draws.set_grid()     # the dispatch width too

        if tv_state != tv_state_of(global_step):
            tv_state = tv_state_of(global_step)
            train_steps = fresh_steps()

        # A chunk of steps on one axis, as the JAX engine dispatches them;
        # windows and fused tiles only one step at a time.
        n_sub = chunk_len(global_step, draws.n_dispatch, cfg_train.N_iters,
                          pg_set, tv_state_of, args.i_print, args.i_weights)
        sels, axis, clip_sizes, offs = draws.next_chunk(n_sub, tv_state[0])
        if clip_sizes is None:
            clip_sizes, clip_off = ((None, np.zeros(3, np.int32)) if gather
                                    else clip_plan[axis])
            offs = np.broadcast_to(np.asarray(clip_off, np.int32),
                                   (n_sub, 3))
        key = (axis, clip_sizes)
        if key not in train_steps:
            train_steps[key] = make_train_step(
                model, optimizer, cfg_train, render_kwargs, *tv_state,
                axis=axis, clip_sizes=clip_sizes, group=group)
        # the fused keys' offsets are host data into K-D and K-E: eager
        res = steps.run(key, train_steps[key], pool, sels, offs,
                        eager=clip_sizes is not None
                        and clip_sizes[0] == "fblk")
        loss = res[-1, 0]
        psnr_lst.append(res[:, 1])
        global_step += n_sub - 1

        if global_step % args.i_print == 0 and writer:
            eps_time = time.time() - time0
            eps_str = (f"{eps_time//3600:02.0f}:{eps_time//60%60:02.0f}:"
                       f"{eps_time%60:02.0f}")
            loss_h, psnr_h = fetchguard.guarded_get(
                (loss, torch.cat(psnr_lst).mean()), "i_print loss")
            print(f"scene_rep_reconstruction ({stage}): iter "
                  f"{global_step:6d} / Loss: {float(loss_h):.9f} / "
                  f"PSNR: {float(psnr_h):5.2f} / Eps: {eps_str}")
        if global_step % args.i_print == 0:
            psnr_lst = []

        if global_step % args.i_weights == 0 and writer:
            _save(os.path.join(logdir, f"{stage}_{global_step:06d}.tar"),
                  model, global_step, optimizer)

    if group is not None:
        # every rank applied the same updates to the same state
        spread = replica_spread(group, list(model.parameters()))
        print(f"data_parallel: replicas after {stage}: largest difference "
              f"from rank 0 {spread!r}")
    if writer:
        _save(last_ckpt_path, model, global_step, optimizer)
        print(f"scene_rep_reconstruction ({stage}): saved {last_ckpt_path}")
    if mesh is not None:
        mesh.barrier()     # the next stage reads this stage's checkpoint
    return model


def _save(path, model, global_step, optimizer):
    """A compact checkpoint of ``model`` and ``optimizer``; the optimizer's
    pull from the device is guarded (the model's, in
    :func:`.checkpoint.save_model_checkpoint`)."""
    with fetchguard.guarded("optimizer state",
                            timeout=4 * fetchguard.timeout_default()):
        opt_state = convert.opt_state_to_jax(optimizer)
    ckpt_lib.save_model_checkpoint(path, model, global_step, opt_state,
                                   compact=True)


def train(args, cfg, data_dict, device=None, mesh=None):
    """Full coarse -> fine pipeline; the checkpoints ``coarse_last.tar`` and
    ``fine_last.tar`` are on disk when it returns the fine model. ``mesh``:
    train data-parallel (:func:`scene_rep_reconstruction`)."""
    device = resolve_device(device)
    print("train: start")
    eps_time = time.time()
    logdir = os.path.join(cfg.basedir, cfg.expname)
    os.makedirs(logdir, exist_ok=True)
    if mesh is None or mesh.rank == 0:
        with open(os.path.join(logdir, "args.txt"), "w") as f:
            for arg in sorted(vars(args)):
                f.write(f"{arg} = {getattr(args, arg)}\n")
        cfg.dump(os.path.join(logdir, "config.py"))

    # coarse geometry searching
    eps_coarse = time.time()
    xyz_min_coarse, xyz_max_coarse = compute_bbox_by_cam_frustrm(
        cfg=cfg, **data_dict)
    if cfg.coarse_train.N_iters > 0:
        scene_rep_reconstruction(
            args=args, cfg=cfg, cfg_model=cfg.coarse_model_and_render,
            cfg_train=cfg.coarse_train, xyz_min=xyz_min_coarse,
            xyz_max=xyz_max_coarse, data_dict=data_dict, stage="coarse",
            device=device, mesh=mesh)
        print("train: coarse geometry searching in "
              f"{time.time() - eps_coarse:.1f} s")
        coarse_ckpt_path = os.path.join(logdir, "coarse_last.tar")
    else:
        print("train: skip coarse geometry searching")
        coarse_ckpt_path = None

    # fine detail reconstruction
    eps_fine = time.time()
    if cfg.data.ndc:
        xyz_min_fine, xyz_max_fine = xyz_min_coarse, xyz_max_coarse
    elif cfg.fine_model_and_render.get("use_coarse_geo", True) \
            and coarse_ckpt_path:
        xyz_min_fine, xyz_max_fine = compute_bbox_by_coarse_geo(
            model_class=DirectVoxGO, model_path=coarse_ckpt_path,
            thres=cfg.fine_model_and_render.bbox_thres, device=device)
    else:
        xyz_min_fine, xyz_max_fine = xyz_min_coarse, xyz_max_coarse
    model = scene_rep_reconstruction(
        args=args, cfg=cfg, cfg_model=cfg.fine_model_and_render,
        cfg_train=cfg.fine_train, xyz_min=xyz_min_fine,
        xyz_max=xyz_max_fine, data_dict=data_dict, stage="fine",
        coarse_ckpt_path=coarse_ckpt_path, device=device, mesh=mesh)
    print(f"train: fine detail reconstruction in "
          f"{time.time() - eps_fine:.1f} s")
    print(f"train: finish (eps time {time.time() - eps_time:.1f} s)")
    return model
