"""DirectMPIGO: a multiplane-image grid for forward-facing (NDC) scenes.

The grid is ``[X, Y, mpi_depth]`` over the NDC box. NDC rays all start on
the near plane (``o_z = -1``) and cross the box's whole depth (``d_z = 2``
over ``z`` in [-1, 1]), so sample ``j`` of every ray of the regular NDC
sampler sits on grid plane ``z = j * stepsize``: the sampler is a z-station
sweep, and every ray trains and renders through the station sweep along z
(kernel K-A forward, K-C backward), whatever its direction.

Differences from :class:`.dvgo.DirectVoxGO`: the resolution comes from a
voxel budget over the xy extent with ``voxel_size_ratio = 256 /
mpi_depth``; the density starts so that each plane stops 1/mpi_depth of
the light and the last plane is opaque, with ``act_shift`` 0; the TV
weights are anisotropic (``wxy``, ``wz``); the colour MLP takes all of k0
and returns the colour itself. The occupancy clip plan, the slab cache and
the state helpers are DirectVoxGO's.

With ``query_mode='gather'`` it renders and trains through :meth:`forward`
instead: the regular NDC sampler's points, the mask's nearest voxel,
trilinear gathers of density and k0, compositing with early termination
and the ``k_color`` samples of largest weight before the colour MLP (f32,
plain PyTorch), as the JAX package's ``DirectMPIGO.forward``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..ops import grid as grid_ops
from ..ops import raymarch as rm
from ..ops import sweep as sweep_ops
from ..ops.tv import total_variation_add_grad
from . import mlp as mlp_lib
from .dvgo import DirectVoxGO


def _density_init(world_size, mpi_depth, voxel_size_ratio):
    """Per-plane raw density whose alpha stops 1/mpi_depth of the light
    that reaches the plane; the last plane 10 (opaque). In f64, then f32."""
    g = np.full([mpi_depth], 1.0 / mpi_depth - 1e-6)
    p = [1 - g[0]]
    for i in range(1, len(g)):
        p.append((1 - g[:i + 1].sum()) / (1 - g[:i].sum()))
    density = np.zeros(world_size, np.float32)
    for i in range(len(p)):
        density[..., i] = np.log(p[i] ** (-1 / voxel_size_ratio) - 1)
    density[..., -1] = 10.0
    return density


class DirectMPIGO(nn.Module):
    """Multiplane-image radiance field of one forward-facing scene.

    The constructor takes the JAX package's keyword set (what checkpoints
    store as ``model_kwargs``); ``device`` (default: CUDA) and ``generator``
    (for the MLP's initial weights) are the port's own.
    """

    # Every ray sweeps along z (the NDC sampler's planes), whatever its
    # direction: the engine and the renderer route all rays to this axis.
    forced_sweep_axis = 2

    def __init__(self, xyz_min, xyz_max, num_voxels=0, mpi_depth=0,
                 mask_cache_path=None, mask_cache_thres=1e-3,
                 fast_color_thres=0, rgbnet_dim=0, rgbnet_depth=3,
                 rgbnet_width=128, viewbase_pe=0, k_color=64,
                 query_mode="sweep", sweep_color_topk=0, seed=0,
                 device=None, generator=None, **kwargs):
        super().__init__()
        if query_mode not in ("sweep", "gather"):
            raise ValueError(f"query_mode {query_mode!r}: expected 'sweep' "
                             "or 'gather'")
        dev = resolve_device(device)
        self.xyz_min = np.asarray(xyz_min, np.float32)
        self.xyz_max = np.asarray(xyz_max, np.float32)
        self.fast_color_thres = float(fast_color_thres)
        self.act_shift = 0.0
        self.k_color = int(k_color) if k_color else 0
        self.query_mode = query_mode
        self.sweep_color_topk = int(sweep_color_topk)
        # Colour-MLP compute dtype and the sweep's slab dtype (f32 = the
        # exact-parity mode), as DirectVoxGO.
        self.mlp_dtype = torch.bfloat16
        self.sweep_dtype = torch.bfloat16
        self.seed = seed
        self._set_grid_resolution(num_voxels, mpi_depth)

        self.rgbnet_kwargs = {
            "rgbnet_dim": rgbnet_dim, "rgbnet_depth": rgbnet_depth,
            "rgbnet_width": rgbnet_width, "viewbase_pe": viewbase_pe,
        }
        self.viewbase_pe = viewbase_pe
        self.rgbnet_dim = rgbnet_dim
        self.rgbnet_width = rgbnet_width
        self.rgbnet_depth = rgbnet_depth
        self.density = nn.Parameter(torch.tensor(_density_init(
            self.world_size, mpi_depth, self.voxel_size_ratio), device=dev))
        if rgbnet_dim <= 0:
            self.k0_dim = 3
            self.rgbnet = None
            self.has_rgbnet = False
        else:
            self.k0_dim = rgbnet_dim
            dim0 = (3 + 3 * viewbase_pe * 2) + self.k0_dim
            self.rgbnet = mlp_lib.MLP(dim0, rgbnet_width, rgbnet_depth, 3,
                                      generator=generator, device=dev)
            self.has_rgbnet = True
        self.k0 = nn.Parameter(torch.zeros((*self.world_size, self.k0_dim),
                                           device=dev))
        print("dmpigo: density", tuple(self.density.shape), "k0",
              tuple(self.k0.shape))

        self.mask_cache_path = mask_cache_path
        self.mask_cache_thres = mask_cache_thres
        if mask_cache_path:
            mask = self._mask_from_coarse_ckpt(mask_cache_path,
                                               mask_cache_thres)
        else:
            mask = torch.ones(self.world_size, dtype=torch.bool, device=dev)
        self.register_buffer("mask", mask)

    # ------------------------------------------------------------------ setup

    device = DirectVoxGO.device
    grid_points = DirectVoxGO.grid_points
    bounds_on = DirectVoxGO.bounds_on
    grid_cache = DirectVoxGO.grid_cache
    _coarse_mask_src = DirectVoxGO._coarse_mask_src
    _mask_from_coarse_ckpt = DirectVoxGO._mask_from_coarse_ckpt

    def _set_grid_resolution(self, num_voxels, mpi_depth):
        """xy resolution from ``sqrt(num_voxels / mpi_depth / area)``,
        truncated; ``mpi_depth`` planes."""
        self.num_voxels = num_voxels
        self.mpi_depth = int(mpi_depth)
        extent = self.xyz_max - self.xyz_min
        r = float(np.sqrt(num_voxels / mpi_depth / (extent[0] * extent[1])))
        self.world_size = (int(extent[0] * r), int(extent[1] * r),
                           int(mpi_depth))
        self.voxel_size_ratio = 256.0 / mpi_depth
        # xy voxel size (the NDC sampler, which is index-regular, needs none)
        self.voxel_size = 1.0 / r
        print("dmpigo: world_size      ", self.world_size)
        print("dmpigo: voxel_size_ratio", self.voxel_size_ratio)

    def get_kwargs(self):
        """Self-describing checkpoint manifest (the JAX package's keys)."""
        return {
            "xyz_min": np.asarray(self.xyz_min),
            "xyz_max": np.asarray(self.xyz_max),
            "num_voxels": self.num_voxels,
            "mpi_depth": self.mpi_depth,
            "act_shift": self.act_shift,
            "voxel_size_ratio": self.voxel_size_ratio,
            "mask_cache_path": self.mask_cache_path,
            "mask_cache_thres": self.mask_cache_thres,
            "fast_color_thres": self.fast_color_thres,
            "k_color": self.k_color,
            "query_mode": self.query_mode,
            "sweep_color_topk": self.sweep_color_topk,
            **self.rgbnet_kwargs,
        }

    def supports_fused_step(self):
        """The fused train step needs a perspective sweep; MPI grids train
        through :meth:`forward_sweep`."""
        return False

    # ------------------------------------------------------- state surgery

    @torch.no_grad()
    def scale_volume_grid(self, num_voxels, mpi_depth):
        """Progressive scaling: trilinear-upsample both grids and take the
        mask from the new density alone (``maxpool(alpha) >
        fast_color_thres``; no coarse checkpoint)."""
        ori = self.world_size
        self._set_grid_resolution(num_voxels, mpi_depth)
        print("dmpigo: scale_volume_grid from", ori, "to", self.world_size)
        ws = tuple(self.world_size)
        density = grid_ops.resize_trilinear(self.density.data, ws)
        k0 = grid_ops.resize_trilinear(self.k0.data, ws)
        alpha = grid_ops.max_pool3d_same(rm.raw2alpha(
            density, self.act_shift, self.voxel_size_ratio))
        self.density = nn.Parameter(density.contiguous())
        self.k0 = nn.Parameter(k0.contiguous())
        self.mask = alpha > self.fast_color_thres

    update_occupancy_cache = DirectVoxGO.update_occupancy_cache
    sweep_clip_for_axis = DirectVoxGO.sweep_clip_for_axis
    activate_density = DirectVoxGO.activate_density

    def tv_axis_scales(self):
        """Per-axis TV weight scale factors (weight = 1)."""
        sxy = max(self.world_size[:2]) / 128.0
        sz = self.mpi_depth / 128.0
        return (sxy, sxy, sz)

    def density_total_variation_grad(self, param, grad, weight, dense_mode):
        """``grad`` plus the anisotropic TV gradient (``wxy`` on x and y,
        ``wz`` on z; under ``bug_compat`` the x terms take ``wz``)."""
        sxy, _, sz = self.tv_axis_scales()
        return total_variation_add_grad(param, grad, weight * sxy,
                                        weight * sxy, weight * sz,
                                        dense_mode)

    k0_total_variation_grad = density_total_variation_grad

    # ----------------------------------------------------------- sampling

    def n_samples(self, stepsize):
        return int((self.mpi_depth - 1) / stepsize) + 1

    _sample_ndc_parts = staticmethod(rm.sample_points_ndc_parts)

    @torch.no_grad()
    def hit_coarse_geo(self, rays_o, rays_d, near, far, stepsize,
                       chunk=8192, **_):
        """[N] numpy bool: rays with an NDC sample in the occupancy."""
        rays_o = np.asarray(rays_o, np.float32).reshape(-1, 3)
        rays_d = np.asarray(rays_d, np.float32).reshape(-1, 3)
        bbox_min = tuple(float(v) for v in self.xyz_min)
        bbox_max = tuple(float(v) for v in self.xyz_max)
        n_s = self.n_samples(stepsize)
        outs = []
        for i in range(0, rays_o.shape[0], chunk):
            (px, py, pz), valid = self._sample_ndc_parts(
                torch.as_tensor(rays_o[i:i + chunk], device=self.device),
                torch.as_tensor(rays_d[i:i + chunk], device=self.device),
                n_s, bbox_min, bbox_max)
            occ = grid_ops.occupancy_lookup_parts(self.mask, px, py, pz,
                                                  bbox_min, bbox_max)
            outs.append(torch.any(occ & valid, -1))
        return torch.cat(outs).cpu().numpy()

    # ----------------------------------------------------- gather forward

    def forward(self, rays_o, rays_d, viewdirs, global_step=None,
                grids=None, *, near, far, bg, stepsize, render_depth=False,
                **_):
        """Gather-forward rendering of NDC rays (``grids`` = (density, k0,
        rgbnet, mask) replaces the module's own): the regular NDC
        sampler's points (``fma``, as the JAX package's compiler computes
        them), occupied by the mask's nearest voxel, density by trilinear
        gathers, alpha at interval ``stepsize * voxel_size_ratio``,
        compositing and the colour compaction of
        :meth:`.dvgo.DirectVoxGO._gather_weights`, then the colour: the
        sigmoid of the k0 samples, or of the f32 MLP over (k0, view
        embedding). Returns the keys of
        :meth:`.dvgo.DirectVoxGO._render_rays`; ``depth`` in sample-index
        units."""
        density_grid, k0_grid, rgbnet, mask = grids if grids is not None \
            else (self.density, self.k0, self.rgbnet, self.mask)
        bbox_min = tuple(float(v) for v in self.xyz_min)
        bbox_max = tuple(float(v) for v in self.xyz_max)
        interval = stepsize * self.voxel_size_ratio
        n_s = self.n_samples(stepsize)
        (px, py, pz), valid = rm.sample_points_ndc_parts(
            rays_o, rays_d, n_s, bbox_min, bbox_max, fma_=True)
        occ = grid_ops.occupancy_lookup_parts(
            mask, px, py, pz, bbox_min, bbox_max) & valid
        step_f = torch.arange(n_s, dtype=torch.float32,
                              device=rays_o.device)[None, :].expand(px.shape)

        density = grid_ops.trilinear_sample_world(
            density_grid, px, py, pz, bbox_min, bbox_max)
        alpha = rm.raw2alpha(density, self.act_shift, interval)
        w = self._gather_weights(alpha, occ, px, py, pz, step_f)
        px, py, pz = w["points"]

        vox_emb = grid_ops.trilinear_sample_world(
            k0_grid, px, py, pz, bbox_min, bbox_max)
        if not self.has_rgbnet:
            rgb = torch.sigmoid(vox_emb)
        else:
            vd_emb = mlp_lib.positional_encoding(viewdirs, self.viewbase_pe)
            vd_emb = vd_emb[:, None, :].expand(*px.shape, vd_emb.shape[-1])
            rgb = torch.sigmoid(mlp_lib.mlp_apply(
                rgbnet, torch.cat([vox_emb, vd_emb], -1)))
        return self._gather_result(w, rgb, bg, render_depth)

    _gather_weights = DirectVoxGO._gather_weights
    _gather_result = staticmethod(DirectVoxGO._gather_result)

    # ----------------------------------------------------- sweep forward

    _sweep_slabs = DirectVoxGO._sweep_slabs
    _stacked_grids = DirectVoxGO._stacked_grids

    def forward_sweep(self, rays_o, rays_d, viewdirs, axis, *, near, far, bg,
                      stepsize, render_depth=False, clip_sizes=None,
                      clip_offsets=None, grids_pre_clipped=False, grids=None,
                      f32_cot=False, **_):
        """The NDC sampler as a z-station sweep of density, mask and k0 in
        one pass (kernel K-A), composited with early termination
        (``raw2alpha`` with interval ``stepsize * voxel_size_ratio``); the
        colour MLP runs on the top-``sweep_color_topk`` stations per ray by
        weight when the sweep is long enough. Validity is the ray's slab
        interval within [near, far] and an interpolated mask above 0 (a
        superset of the nearest-voxel occupancy; the thresholds prune the
        rest).

        Gradients, ``grids``, ``grids_pre_clipped``, ``f32_cot`` and the slab
        cache under
        ``torch.no_grad()`` as in :meth:`.dvgo.DirectVoxGO.forward_sweep`.
        ``axis`` must be 2 (``forced_sweep_axis``). ``depth`` is in
        sample-index units (sample j of the NDC sampler at depth j).
        """
        if axis != 2:
            raise ValueError("the MPI sweep runs along z (forced_sweep_axis)")
        k = sweep_ops.substeps_for_stepsize(stepsize)
        common = dict(
            clip_sizes=clip_sizes,
            clip_offsets=None if clip_sizes is None else clip_offsets,
            world_size=tuple(self.world_size))
        if grids is None and not torch.is_grad_enabled():
            out = sweep_ops.sweep_samples(
                None, rays_o, rays_d, self.xyz_min, self.xyz_max, 2, k,
                slabs=self._sweep_slabs(2, k, clip_sizes, clip_offsets),
                **common)
        else:
            density, k0, mask_g = grids if grids is not None else (
                self.density, self.k0, self.mask)
            offs = (None if clip_sizes is None or grids_pre_clipped
                    else clip_offsets if torch.is_tensor(clip_offsets)
                    else [int(v) for v in np.asarray(clip_offsets)])
            grid_cat = self._stacked_grids(
                density, k0, mask_g, 2,
                None if grids_pre_clipped else clip_sizes, offs, f32_cot)
            out = sweep_ops.sweep_samples(
                grid_cat, rays_o, rays_d, self.xyz_min, self.xyz_max, 2, k,
                interp_dtype=self.sweep_dtype, pre_clipped=True,
                f32_cot=f32_cot, **common)
        vals, t, fwd = out["vals"], out["t"], out["forward"]
        density_s, mask_s, k0_cl = vals[0], vals[1], vals[2:]
        n_s = t.shape[1]

        dev = rays_o.device
        t_lo, t_hi = rm.ray_aabb_tminmax(
            rays_o, rays_d, *self.bounds_on(dev), near, far)
        valid = ((t >= t_lo[:, None]) & (t <= t_hi[:, None])
                 & (t_hi > t_lo)[:, None] & (mask_s > 0))
        alpha = rm.raw2alpha(density_s, self.act_shift,
                             stepsize * self.voxel_size_ratio)
        occ = valid
        if self.fast_color_thres > 0:
            occ = occ & (alpha > self.fast_color_thres)
        weights, alphainv_last, live = rm.alpha2weight_dense_bidir(
            alpha, occ, fwd)
        if self.fast_color_thres > 0:
            wmask = weights > self.fast_color_thres
        else:
            wmask = live
        w_eff = torch.where(wmask, weights, torch.zeros_like(weights))

        # Top-K station compaction before the colour MLP (exact whenever a
        # ray has at most K samples above the weight threshold).
        topk = self.sweep_color_topk
        idx = None
        compact = (self.has_rgbnet and self.fast_color_thres > 0
                   and 0 < topk < n_s and n_s > max(96, 2 * topk))
        if compact:
            idx, sel_nk, sel_cl = sweep_ops.topk_station_select(
                w_eff.detach(), topk)
            w_eff = sel_nk(w_eff)
            wmask = torch.gather(wmask, 1, idx)
            alpha = torch.gather(alpha, 1, idx)
            k0_cl = sel_cl(k0_cl)
        if not self.has_rgbnet:
            rgb_cl = torch.sigmoid(k0_cl)
        else:
            vd_emb = mlp_lib.positional_encoding(viewdirs, self.viewbase_pe)
            rgb_cl = torch.sigmoid(mlp_lib.mlp_apply_split_cl(
                self.rgbnet, k0_cl, vd_emb, compute_dtype=self.mlp_dtype,
                f32_cot=f32_cot))

        rgb_marched = (torch.einsum("ns,cns->nc", w_eff, rgb_cl)
                       + alphainv_last[..., None] * bg)
        ret = {
            "alphainv_last": alphainv_last,
            "weights": w_eff,
            "rgb_marched": rgb_marched,
            "raw_alpha": torch.where(wmask, alpha, torch.zeros_like(alpha)),
            "raw_rgb_cl": rgb_cl,
            "wmask": wmask,
        }
        if render_depth:
            # station s is plane p_offset*k + s (compacted: the kept
            # stations' indices)
            s_of = (idx.float() if compact else torch.arange(
                n_s, dtype=torch.float32, device=dev)[None, :])
            step_f = out["p_offset"] * k + s_of
            ret["depth"] = torch.sum(w_eff * step_f, 1).detach()
        return ret
