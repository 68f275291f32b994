"""DirectVoxGO: dense density and colour-feature voxel grids with a shallow
view-dependent MLP.

Grids are channels-last ``[X, Y, Z(, C)]`` parameters of the module, the
occupancy mask a boolean buffer of the density grid's shape. Two forwards,
chosen by ``query_mode`` as in the JAX package:

- ``'sweep'`` (:meth:`DirectVoxGO.forward_sweep`): the station sweep,
  differentiable in the grids and the MLP (kernel K-A forward, K-C
  backward); under ``torch.no_grad()`` it reads cached station slabs.
- ``'gather'`` (:meth:`DirectVoxGO.forward`, the reference-faithful point
  sampling): dense samples at fixed arc-length steps, the occupied ones
  compacted to ``k_density``, trilinear gathers of the density, early-
  terminated compositing, the ``k_color`` samples of largest weight
  compacted before the colour query, all in f32 plain PyTorch. It also
  serves the colour variants, which run only there: the positional-
  embedding colour (``posbase_pe``), the fully implicit colour
  (``rgbnet_full_implicit``) and grid-LIIF (``implicit_voxel_feat``,
  which forces gather).

The state surgery of training lives here too: near-camera maskout,
progressive rescaling, occupancy renewal, clip boxes, the coarse-geometry
ray filter and the per-voxel view count (the sweep form, or the exact form
of the gather models).
"""

from __future__ import annotations

import os

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..ops import grid as grid_ops
from ..ops import raymarch as rm
from ..ops import rounding
from ..ops import sweep as sweep_ops
from ..ops.tv import total_variation_add_grad
from . import mlp as mlp_lib


def _round_up(x, m):
    return ((int(x) + m - 1) // m) * m


# Clip boxes whose station slabs the render cache keeps beside the grid's.
SLAB_BOXES_KEPT = 4


class DirectVoxGO(nn.Module):
    """Per-scene voxel-grid radiance field.

    The constructor takes the JAX package's keyword set (what checkpoints
    store as ``model_kwargs``); ``device`` (default: CUDA) and ``generator``
    (for the MLP's initial weights) are the port's own.
    """

    def __init__(self, xyz_min, xyz_max,
                 num_voxels=0, num_voxels_base=0,
                 alpha_init=None,
                 mask_cache_path=None, mask_cache_thres=1e-3,
                 fast_color_thres=0,
                 rgbnet_dim=0, rgbnet_direct=False, rgbnet_full_implicit=False,
                 rgbnet_depth=3, rgbnet_width=128,
                 viewbase_pe=4, posbase_pe=0,
                 implicit_voxel_feat=False, feat_unfold=False,
                 local_ensemble=True, cell_decode=True,
                 k_density=None, k_color=64,
                 query_mode="sweep",
                 sweep_color_topk=0,
                 world_size_quantum=1,
                 seed=0, device=None, generator=None,
                 **kwargs):
        super().__init__()
        if query_mode not in ("sweep", "gather"):
            raise ValueError(f"query_mode {query_mode!r}: expected 'sweep' "
                             "or 'gather'")
        dev = resolve_device(device)
        self.xyz_min = np.asarray(xyz_min, np.float32)
        self.xyz_max = np.asarray(xyz_max, np.float32)
        self.fast_color_thres = float(fast_color_thres)
        self.posbase_pe = int(posbase_pe)
        self.sweep_color_topk = int(sweep_color_topk)
        self.query_mode = query_mode
        # Colour-MLP compute dtype of the per-ray path (None = f32) and the
        # sweep's slab dtype (f32 = the exact-parity mode).
        self.mlp_dtype = torch.bfloat16
        self.sweep_dtype = torch.bfloat16
        self.world_size_quantum = max(int(world_size_quantum), 1)

        self.num_voxels_base = num_voxels_base
        self.voxel_size_base = float(
            ((self.xyz_max - self.xyz_min).prod() / num_voxels_base)
            ** (1 / 3))
        self.alpha_init = alpha_init
        self.act_shift = float(np.log(1.0 / (1.0 - alpha_init) - 1.0))
        self._set_grid_resolution(num_voxels)
        self.k_density = k_density
        self.k_color = int(k_color) if k_color else 0
        self.seed = seed

        self.rgbnet_kwargs = {
            "rgbnet_dim": rgbnet_dim, "rgbnet_direct": rgbnet_direct,
            "rgbnet_full_implicit": rgbnet_full_implicit,
            "rgbnet_depth": rgbnet_depth, "rgbnet_width": rgbnet_width,
            "viewbase_pe": viewbase_pe, "posbase_pe": posbase_pe,
            "implicit_voxel_feat": implicit_voxel_feat,
            "feat_unfold": feat_unfold, "local_ensemble": local_ensemble,
            "cell_decode": cell_decode,
        }
        self.implicit_voxel_feat = implicit_voxel_feat
        self.feat_unfold = feat_unfold
        self.local_ensemble = local_ensemble
        self.cell_decode = cell_decode
        if implicit_voxel_feat:
            # grid-LIIF colour: only the gather forward computes it
            self.query_mode = "gather"
        self.rgbnet_full_implicit = rgbnet_full_implicit
        self.rgbnet_direct = rgbnet_direct
        self.rgbnet_depth = rgbnet_depth
        self.rgbnet_width = rgbnet_width
        self.viewbase_pe = viewbase_pe
        self.rgbnet_dim = rgbnet_dim

        ws = self.world_size
        self.density = nn.Parameter(torch.zeros(ws, device=dev))
        if rgbnet_dim <= 0:
            # Coarse stage: k0 is a direct RGB grid, no MLP.
            self.k0_dim = 3
            self.rgbnet = None
            self.has_rgbnet = False
        else:
            self.k0_dim = 0 if rgbnet_full_implicit else rgbnet_dim
            dim0 = 3 + 3 * viewbase_pe * 2
            if rgbnet_full_implicit:
                pass
            elif posbase_pe > 0:
                dim0 += 3 + 3 * posbase_pe * 2
            elif rgbnet_direct:
                dim0 += self.k0_dim
            else:
                dim0 += self.k0_dim - 3
            if implicit_voxel_feat:
                # per-corner decoder input: the (27-unfolded) feature, the
                # relative coordinate, the cell, the view embedding
                dim0 = (self.k0_dim * (27 if feat_unfold else 1) + 3
                        + (3 if cell_decode else 0) + 3 + 3 * viewbase_pe * 2)
            self.rgbnet_dim0 = dim0
            self.rgbnet = mlp_lib.MLP(dim0, rgbnet_width, rgbnet_depth, 3,
                                      generator=generator, device=dev)
            self.has_rgbnet = True
        self.k0 = nn.Parameter(torch.zeros((*ws, self.k0_dim), device=dev))

        self.mask_cache_path = mask_cache_path
        self.mask_cache_thres = mask_cache_thres
        if mask_cache_path:
            mask = self._mask_from_coarse_ckpt(mask_cache_path,
                                               mask_cache_thres)
        else:
            mask = torch.ones(ws, dtype=torch.bool, device=dev)
        self.register_buffer("mask", mask)

    # ------------------------------------------------------------------ setup

    @property
    def device(self):
        return self.density.device

    def _set_grid_resolution(self, num_voxels):
        """Grid resolution from a voxel-count budget; dims of 64 and more
        round to a multiple of ``world_size_quantum`` (Python's ``round``,
        as the JAX package)."""
        self.num_voxels = num_voxels
        self.voxel_size = float(
            ((self.xyz_max - self.xyz_min).prod() / num_voxels) ** (1 / 3))
        q = self.world_size_quantum
        self.world_size = tuple(
            q * round(int(v) / q) if q > 1 and int(v) >= 64 else int(v)
            for v in (self.xyz_max - self.xyz_min) / self.voxel_size)
        self.voxel_size_ratio = self.voxel_size / self.voxel_size_base

    def _coarse_mask_src(self, path, thres):
        """(occupancy grid, bounds) of a coarse checkpoint:
        ``alpha(maxpool(density)) >= thres``; cached, since progressive
        scaling looks it up again at every rescale."""
        cache = self.__dict__.get("_coarse_mask_cache")
        if cache is None or cache[0] != (path, thres):
            from ..engine import checkpoint as ckpt_lib
            st = ckpt_lib.load_checkpoint_file(path)
            c_kwargs = st["model_kwargs"]
            c_density = torch.as_tensor(st["model_state_dict"]["density"],
                                        device=self.density.device)
            alpha = rm.raw2alpha(grid_ops.max_pool3d_same(c_density),
                                 c_kwargs["act_shift"],
                                 c_kwargs["voxel_size_ratio"])
            c_min = [float(v) for v in np.asarray(c_kwargs["xyz_min"],
                                                  np.float64)]
            c_max = [float(v) for v in np.asarray(c_kwargs["xyz_max"],
                                                  np.float64)]
            cache = ((path, thres), alpha >= thres, c_min, c_max)
            self.__dict__["_coarse_mask_cache"] = cache
        return cache[1:]

    def _mask_from_coarse_ckpt(self, path, thres):
        """Occupancy of a coarse checkpoint looked up at this grid's
        points."""
        c_mask, c_min, c_max = self._coarse_mask_src(path, thres)
        xs, ys, zs = (torch.as_tensor(np.linspace(
            self.xyz_min[a], self.xyz_max[a], self.world_size[a]),
            dtype=torch.float32, device=c_mask.device) for a in range(3))
        return grid_ops.occupancy_lookup_parts(
            c_mask, xs[:, None, None], ys[None, :, None], zs[None, None, :],
            c_min, c_max)

    def grid_points(self):
        """[X, Y, Z, 3] world coordinates of every voxel (align-corners)."""
        axes = [np.linspace(self.xyz_min[a], self.xyz_max[a],
                            self.world_size[a]) for a in range(3)]
        return torch.as_tensor(np.stack(np.meshgrid(*axes, indexing="ij"),
                                        -1), dtype=torch.float32,
                               device=self.device)

    def get_kwargs(self):
        """Self-describing checkpoint manifest (the JAX package's keys)."""
        return {
            "xyz_min": np.asarray(self.xyz_min),
            "xyz_max": np.asarray(self.xyz_max),
            "num_voxels": self.num_voxels,
            "num_voxels_base": self.num_voxels_base,
            "alpha_init": self.alpha_init,
            "act_shift": self.act_shift,
            "voxel_size_ratio": self.voxel_size_ratio,
            "mask_cache_path": self.mask_cache_path,
            "mask_cache_thres": self.mask_cache_thres,
            "fast_color_thres": self.fast_color_thres,
            "k_density": self.k_density,
            "k_color": self.k_color,
            "query_mode": self.query_mode,
            "sweep_color_topk": self.sweep_color_topk,
            "world_size_quantum": self.world_size_quantum,
            **self.rgbnet_kwargs,
        }

    def bounds_on(self, device):
        """(xyz_min, xyz_max) as f32 tensors on ``device``, copied once: a
        train step captured as a CUDA graph may not copy from the host."""
        cache = self.__dict__.setdefault("_bounds_cache", {})
        if device not in cache:
            cache[device] = tuple(torch.as_tensor(b, device=device)
                                  for b in (self.xyz_min, self.xyz_max))
        return cache[device]

    def grid_cache(self, name):
        """A dict for arrays derived from the grids and the mask (station
        slabs), emptied when any of them is replaced or modified in place."""
        arrs = (self.density, self.k0, self.mask)
        stamp = tuple(a._version for a in arrs)
        caches = self.__dict__.setdefault("_grid_caches", {})
        entry = caches.get(name)
        if entry is None or entry[1] != stamp or not all(
                a is b for a, b in zip(entry[0], arrs)):
            entry = caches[name] = (arrs, stamp, {})
        return entry[2]

    # ------------------------------------------------------- state surgery

    @torch.no_grad()
    def maskout_near_cam_vox(self, cam_o, near):
        """Set density to -100 for voxels within ``near`` of any camera."""
        pts = self.grid_points()
        d2 = None
        for cam in torch.as_tensor(np.asarray(cam_o, np.float32),
                                   device=self.device):
            d2_c = torch.sum((pts - cam) ** 2, -1)
            d2 = d2_c if d2 is None else torch.minimum(d2, d2_c)
        self.density.masked_fill_(torch.sqrt(d2) <= near, -100.0)

    @torch.no_grad()
    def scale_volume_grid(self, num_voxels):
        """Progressive scaling: trilinear-upsample the grids to the
        resolution of ``num_voxels`` and refresh the mask from the new
        density (``maxpool(alpha) > fast_color_thres``) and, where there is
        one, the coarse checkpoint's occupancy."""
        ori = self.world_size
        self._set_grid_resolution(num_voxels)
        print("dvgo: scale_volume_grid from", ori, "to", self.world_size)
        ws = tuple(self.world_size)
        density = grid_ops.resize_trilinear(self.density.data, ws)
        k0 = grid_ops.resize_trilinear(self.k0.data, ws)
        alpha = grid_ops.max_pool3d_same(rm.raw2alpha(
            density, self.act_shift, self.voxel_size_ratio))
        mask = alpha > self.fast_color_thres
        if self.mask_cache_path:
            mask = self._mask_from_coarse_ckpt(
                self.mask_cache_path, self.mask_cache_thres) & mask
        self.density = nn.Parameter(density.contiguous())
        self.k0 = nn.Parameter(k0.contiguous())
        self.mask = mask

    @torch.no_grad()
    def update_occupancy_cache(self):
        """Periodic mask renewal: ``mask &= maxpool(alpha) >
        fast_color_thres``, in place (the train steps captured as CUDA
        graphs read the mask where it lies)."""
        alpha = grid_ops.max_pool3d_same(self.activate_density(self.density))
        self.mask.logical_and_(alpha > self.fast_color_thres)

    def sweep_clip_for_axis(self, axis, quantum=16, fixed_sizes=None,
                            bbox=None):
        """(clip_sizes, clip_offsets) for :meth:`forward_sweep`: the
        occupancy bbox in permuted order, sizes rounded up to ``quantum``
        voxels; (None, zeros) when clipping would not shrink anything.

        ``bbox``: host (lo, hi) rows computed elsewhere
        (:func:`..ops.grid.mask_bbox_vox_device`). ``fixed_sizes`` (permuted
        order): keep a box shape - offsets are refit to the current bbox and
        the sizes returned as they are while every extent still fits; None
        sizes once an extent outgrew them."""
        if bbox is not None:
            lo, hi = bbox
        else:
            cache = getattr(self, "_mask_bbox_cache", None)
            if cache is not None and cache[0] is self.mask \
                    and cache[1] == self.mask._version:
                lo, hi = cache[2]
            else:
                lo, hi = grid_ops.mask_bbox_vox(self.mask)
                self._mask_bbox_cache = (self.mask, self.mask._version,
                                         (lo, hi))
        perm = sweep_ops._PERMS[axis]
        if fixed_sizes is not None:
            offs = []
            for q, a in zip(fixed_sizes, perm):
                g = self.world_size[a]
                ext = int(hi[a] - lo[a] + 1)
                if ext > q or q > g:
                    return None, np.zeros(3, np.int32)
                offs.append(int(min(lo[a], g - q)))
            return tuple(fixed_sizes), np.asarray(offs, np.int32)
        sizes, offs = [], []
        for a in perm:
            g = self.world_size[a]
            ext = int(hi[a] - lo[a] + 1)
            q = min(_round_up(ext, quantum), g)
            sizes.append(q)
            offs.append(int(min(lo[a], g - q)))
        if all(s == self.world_size[a] for s, a in zip(sizes, perm)):
            return None, np.zeros(3, np.int32)
        return tuple(sizes), np.asarray(offs, np.int32)

    def tv_axis_scales(self):
        """Per-axis TV weight scale factors (weight = 1)."""
        s = max(self.world_size) / 128.0
        return (s, s, s)

    def density_total_variation_grad(self, param, grad, weight, dense_mode):
        """``grad`` plus the TV gradient, scaled with the resolution."""
        w = weight * max(self.world_size) / 128.0
        return total_variation_add_grad(param, grad, w, w, w, dense_mode)

    def k0_total_variation_grad(self, param, grad, weight, dense_mode):
        w = weight * max(self.world_size) / 128.0
        return total_variation_add_grad(param, grad, w, w, w, dense_mode)

    def activate_density(self, density, interval=None):
        interval = interval if interval is not None else self.voxel_size_ratio
        return rm.raw2alpha(density, self.act_shift, interval)

    # ------------------------------------------------- coarse-geometry hits

    def _hit_from_rays(self, rays_o, rays_d, near, far, stepsize,
                       mask=None):
        stepdist = stepsize * self.voxel_size
        n_samples = rm.max_samples_for_bbox(self.xyz_min, self.xyz_max,
                                            stepdist)
        bbox_min = tuple(float(v) for v in self.xyz_min)
        bbox_max = tuple(float(v) for v in self.xyz_max)
        (px, py, pz), valid, _ = rm.sample_points_dense_parts(
            rays_o, rays_d, bbox_min, bbox_max, near, far, stepdist,
            n_samples)
        occ = grid_ops.occupancy_lookup_parts(
            self.mask if mask is None else mask, px, py, pz, bbox_min,
            bbox_max)
        return torch.any(occ & valid, -1)

    @torch.no_grad()
    def hit_coarse_geo(self, rays_o, rays_d, near, far, stepsize,
                       chunk=65536, mask=None, **_):
        """[N] numpy bool: rays with a sample in the cached occupancy (or in
        ``mask``)."""
        rays_o = np.asarray(rays_o, np.float32).reshape(-1, 3)
        rays_d = np.asarray(rays_d, np.float32).reshape(-1, 3)
        outs = []
        for i in range(0, rays_o.shape[0], chunk):
            outs.append(self._hit_from_rays(
                torch.as_tensor(rays_o[i:i + chunk], device=self.device),
                torch.as_tensor(rays_d[i:i + chunk], device=self.device),
                float(near), float(far), float(stepsize), mask))
        return torch.cat(outs).cpu().numpy()

    @torch.no_grad()
    def hit_coarse_geo_view(self, H, W, K, c2w, near, far, stepsize,
                            inverse_y=False, flip_x=False, flip_y=False,
                            chunk=65536, **_):
        """One whole view's hit mask ([H*W] bool tensor) with the rays
        generated on the device from (K, c2w): pixel centres, directions
        combined elementwise in f32 as the host ray code does."""
        dev = self.device
        K = torch.as_tensor(np.asarray(K, np.float32), device=dev)
        c2w = torch.as_tensor(np.asarray(c2w, np.float32)[:3, :4],
                              device=dev)
        j, i = torch.meshgrid(
            torch.arange(H, dtype=torch.float32, device=dev),
            torch.arange(W, dtype=torch.float32, device=dev), indexing="ij")
        i, j = i + 0.5, j + 0.5
        if flip_x:
            i = i.flip(1)
        if flip_y:
            j = j.flip(0)
        u = (i - K[0, 2]) / K[0, 0]
        v = (j - K[1, 2]) / K[1, 1]
        dirs = (u, v, torch.ones_like(u)) if inverse_y \
            else (u, -v, -torch.ones_like(u))
        rot = c2w[:3, :3]
        rays_d = torch.stack(
            [dirs[0] * rot[r, 0] + dirs[1] * rot[r, 1] + dirs[2] * rot[r, 2]
             for r in range(3)], -1).reshape(-1, 3)
        rays_o = c2w[:3, 3].expand(rays_d.shape)
        return torch.cat([self._hit_from_rays(
            rays_o[s:s + chunk], rays_d[s:s + chunk], float(near),
            float(far), float(stepsize))
            for s in range(0, rays_d.shape[0], chunk)])

    # ----------------------------------------------------- gather forward

    def grid_sampler(self, xyz, grid):
        """Trilinear query of ``grid`` at world coordinates ``xyz [...,
        3]``."""
        idx = grid_ops.world_to_grid(xyz, *self.bounds_on(xyz.device),
                                     grid.shape[:3])
        return grid_ops.trilinear_sample(grid, idx)

    def forward(self, rays_o, rays_d, viewdirs, global_step=None,
                grids=None, **render_kwargs):
        """Gather-forward volume rendering of a ray batch (any directions):
        ``grids`` = (density, k0, rgbnet, mask) replaces the module's own.
        Returns :meth:`_render_rays`'s dict."""
        if grids is None:
            grids = (self.density, self.k0, self.rgbnet, self.mask)
        return self._render_rays(*grids, rays_o, rays_d, viewdirs,
                                 **render_kwargs)

    def _render_rays(self, density_grid, k0_grid, rgbnet, mask, rays_o,
                     rays_d, viewdirs, *, near, far, bg, stepsize,
                     render_depth=False, **_):
        """The gather forward over explicit grids (the multiscene variants
        pass per-scene ones):

        1. ``n_cap`` samples per ray at ``stepsize`` voxels apart from the
           ray's bbox entry, valid inside the bbox and occupied by the
           mask's nearest voxel;
        2. the occupied samples compacted in step order to ``k_density``;
        3. density by trilinear gathers, alpha, compositing weights with
           early termination (and the ``fast_color_thres`` gates);
        4. the ``k_color`` samples of largest weight compacted before the
           colour query, the weight the cap drops returned to
           ``alphainv_last`` (detached), so that the weights and the
           background still sum to 1;
        5. colour: the k0 grid's sigmoid (coarse), the MLP over (k0
           features, view embedding) with the k0 colour added (fine) or
           not (``rgbnet_direct``), over (position embedding, view
           embedding) (``posbase_pe``), over the view embedding alone
           (``rgbnet_full_implicit``), or grid-LIIF
           (:meth:`_implicit_color`).

        Returns ``rgb_marched [N, 3]``, ``alphainv_last [N]``, and per
        kept sample ``weights``, ``raw_alpha``, ``raw_rgb [N, K, 3]``,
        ``wmask``; ``depth [N]`` (no gradient, in steps) with
        ``render_depth``."""
        bbox_min = tuple(float(v) for v in self.xyz_min)
        bbox_max = tuple(float(v) for v in self.xyz_max)
        stepdist = stepsize * self.voxel_size
        interval = stepsize * self.voxel_size_ratio
        n_cap = rm.max_samples_for_bbox(self.xyz_min, self.xyz_max, stepdist)

        (px, py, pz), valid, step_sl = rm.sample_points_dense_parts(
            rays_o, rays_d, bbox_min, bbox_max, near, far, stepdist, n_cap,
            fma_=True)
        occ = grid_ops.occupancy_lookup_parts(
            mask, px, py, pz, bbox_min, bbox_max) & valid
        step_f = step_sl.to(torch.float32)[None, :].expand(px.shape)

        k_d = self.k_density or n_cap
        if k_d < n_cap:
            key = torch.where(occ, step_f, step_f + float(2 * n_cap))
            _, px, py, pz, occ, step_f = rm.compact_by_key(
                key, k_d, px, py, pz, occ, step_f)

        density = grid_ops.trilinear_sample_world(
            density_grid, px, py, pz, bbox_min, bbox_max)
        alpha = rm.raw2alpha(density, self.act_shift, interval)
        w = self._gather_weights(alpha, occ, px, py, pz, step_f)
        px, py, pz = w["points"]

        if self.has_rgbnet:
            vd_emb = mlp_lib.positional_encoding(viewdirs, self.viewbase_pe)
            vd_emb = vd_emb[:, None, :].expand(*px.shape, vd_emb.shape[-1])
        if self.has_rgbnet and self.implicit_voxel_feat:
            rgb = self._implicit_color(k0_grid, rgbnet, px, py, pz, vd_emb,
                                       stepsize, bbox_min, bbox_max)
        else:
            if not self.rgbnet_full_implicit:
                k0 = grid_ops.trilinear_sample_world(
                    k0_grid, px, py, pz, bbox_min, bbox_max)
            if not self.has_rgbnet:
                rgb = torch.sigmoid(k0)
            else:
                if self.rgbnet_full_implicit:
                    feat = vd_emb
                elif self.posbase_pe > 0:
                    pos_emb = mlp_lib.positional_encoding(
                        torch.stack([px, py, pz], -1), self.posbase_pe)
                    feat = torch.cat([pos_emb, vd_emb], -1)
                elif self.rgbnet_direct:
                    feat = torch.cat([k0, vd_emb], -1)
                else:
                    feat = torch.cat([k0[..., 3:], vd_emb], -1)
                logit = mlp_lib.mlp_apply(rgbnet, feat)
                if (self.rgbnet_direct or self.rgbnet_full_implicit
                        or self.posbase_pe > 0):
                    rgb = torch.sigmoid(logit)
                else:
                    rgb = torch.sigmoid(logit + k0[..., :3])

        return self._gather_result(w, rgb, bg, render_depth)

    def _gather_weights(self, alpha, occ, px, py, pz, step_f):
        """The gather forwards' compositing: the ``fast_color_thres`` gate
        on alpha, the weights with early termination, the weight gate (or
        the live samples), then, with a colour MLP, the ``k_color``
        samples of largest weight kept in a stable order, the weight
        dropped returned to ``alphainv_last`` (detached). Returns a dict:
        ``w_eff``, ``alphainv_last``, ``wmask``, ``alpha``, ``step_f`` and
        ``points`` (px, py, pz) of the kept samples."""
        if self.fast_color_thres > 0:
            occ = occ & (alpha > self.fast_color_thres)
        weights, alphainv_last, live = rm.alpha2weight_dense(alpha, occ)
        wmask = (weights > self.fast_color_thres
                 if self.fast_color_thres > 0 else live)
        w_eff = torch.where(wmask, weights, torch.zeros_like(weights))
        k_c = self.k_color if (self.has_rgbnet and self.k_color) else 0
        if k_c and k_c < w_eff.shape[-1]:
            w_total = torch.sum(w_eff, -1)
            _, w_eff, px, py, pz, step_f, alpha, wmask = rm.compact_by_key(
                -w_eff, k_c, w_eff, px, py, pz, step_f, alpha, wmask)
            alphainv_last = alphainv_last + (
                w_total - torch.sum(w_eff, -1)).detach()
        return {"w_eff": w_eff, "alphainv_last": alphainv_last,
                "wmask": wmask, "alpha": alpha, "step_f": step_f,
                "points": (px, py, pz)}

    @staticmethod
    def _gather_result(w, rgb, bg, render_depth):
        """The gather forwards' output dict from :meth:`_gather_weights`'
        ``w`` and the kept samples' colours ``rgb [N, K, 3]``."""
        w_eff, wmask, alpha = w["w_eff"], w["wmask"], w["alpha"]
        ret = {
            "alphainv_last": w["alphainv_last"],
            "weights": w_eff,
            "rgb_marched": (torch.sum(w_eff[..., None] * rgb, 1)
                            + w["alphainv_last"][..., None] * bg),
            "raw_alpha": torch.where(wmask, alpha, torch.zeros_like(alpha)),
            "raw_rgb": rgb,
            "wmask": wmask,
        }
        if render_depth:
            ret["depth"] = torch.sum(w_eff * w["step_f"], 1).detach()
        return ret

    @staticmethod
    def _unfold_grid_3x3x3(grid):
        """The 3x3x3 neighbourhood of every voxel, edge-replicated, as
        channels in position-outer order: ``out[..., (di*9 + dj*3 + dk) * C
        + c]``."""
        nx, ny, nz, _ = grid.shape
        padded = torch.nn.functional.pad(
            grid.permute(3, 0, 1, 2)[None], (1, 1, 1, 1, 1, 1),
            mode="replicate")[0].permute(1, 2, 3, 0)
        return torch.cat([padded[i:i + nx, j:j + ny, k:k + nz]
                          for i in range(3) for j in range(3)
                          for k in range(3)], -1)

    def _implicit_color(self, k0_grid, rgbnet, px, py, pz, vd_emb,
                        stepsize, bbox_min, bbox_max):
        """Grid-LIIF colour: per sample, the voxel features at the 8
        half-voxel-shifted nearest corners (``local_ensemble``; else the
        floor corner alone), each decoded by the MLP from (feature,
        relative coordinate, cell when ``cell_decode``, view embedding),
        sigmoided and blended by the volume of the opposite corner's box.

        The reference's quirks, kept as the JAX package keeps them: no
        diagonal swap of the volumes, the cell ``2 * stepsize / dim``
        without rescaling, and the relative coordinate at twice voxel
        units. All corners' features come from one gather (one gradient
        buffer of the grid's size)."""
        nx, ny, nz = k0_grid.shape[:3]
        grid = self._unfold_grid_3x3x3(k0_grid) if self.feat_unfold \
            else k0_grid
        grid_flat = grid.reshape(nx * ny * nz, grid.shape[-1])
        ix, iy, iz = grid_ops.world_to_grid_parts(
            px, py, pz, bbox_min, bbox_max, (nx, ny, nz))
        shifts = ([(sx, sy, sz) for sx in (-1, 1) for sy in (-1, 1)
                   for sz in (-1, 1)] if self.local_ensemble
                  else [(0, 0, 0)])
        cell = ([2.0 * stepsize / nx, 2.0 * stepsize / ny,
                 2.0 * stepsize / nz] if self.cell_decode else None)

        corners, lins = [], []
        for shift in shifts:
            c = [torch.clamp(torch.floor(i) + (1.0 if sh > 0 else 0.0), 0,
                             n - 1)
                 for i, sh, n in zip((ix, iy, iz), shift, (nx, ny, nz))]
            corners.append(c)
            lins.append((c[0].long() * ny + c[1].long()) * nz + c[2].long())
        q_all = grid_flat.index_select(0, torch.stack(lins).reshape(-1))
        q_all = q_all.reshape(len(shifts), *ix.shape, grid_flat.shape[-1])

        preds, volumes = [], []
        for q_feat, (cx, cy, cz) in zip(q_all, corners):
            rx, ry, rz = (2.0 * (i - q) for i, q in
                          ((ix, cx), (iy, cy), (iz, cz)))
            inp = [q_feat, rx[..., None], ry[..., None], rz[..., None]]
            if cell is not None:
                inp += [torch.full_like(rx[..., None], v) for v in cell]
            logit = mlp_lib.mlp_apply(rgbnet, torch.cat(inp + [vd_emb], -1))
            preds.append(torch.sigmoid(logit))
            volumes.append(torch.abs(rx * ry * rz) + 1e-9)
        tot = volumes[0]
        for v in volumes[1:]:
            tot = tot + v
        rgb = preds[0] * (volumes[0] / tot)[..., None]
        for p, v in zip(preds[1:], volumes[1:]):
            rgb = rgb + p * (v / tot)[..., None]
        return rgb

    # ----------------------------------------------------- sweep forward

    def _sweep_slabs(self, axis, k, clip_sizes, clip_offsets):
        """Station slabs [S, Gu, Gv, 2 + k0_dim] (density, mask, k0) of a
        sweep along ``axis`` over the clip box (or the whole grid), in
        ``sweep_dtype``; the render path's cache (no gradient). The whole
        grid's slabs are built once per axis; a box's are a copy of their
        slice (a station blends the same two slabs either way), and the
        last ``SLAB_BOXES_KEPT`` boxes stay cached, so that the chunks of
        a view share one copy and the windows of a tiled view do not pile
        up."""
        cache = self.grid_cache("sweep_slabs")
        whole = (axis, k, self.sweep_dtype)
        if whole not in cache:
            with torch.no_grad():
                grid_cat = self._stacked_grids(
                    self.density, self.k0, self.mask, axis, None, None)
                cache[whole] = sweep_ops._station_slabs(
                    sweep_ops.permute_grid(grid_cat, axis,
                                           dtype=self.sweep_dtype),
                    k).contiguous()
        if clip_sizes is None:
            return cache[whole]
        (p0, u0, v0) = (int(v) for v in np.asarray(clip_offsets))
        bp, bu, bv = (int(v) for v in clip_sizes)
        key = whole + ((bp, bu, bv), (p0, u0, v0))
        if key not in cache:
            boxes = [kk for kk in cache if len(kk) == 5]
            for old in boxes[:len(boxes) + 1 - SLAB_BOXES_KEPT]:
                del cache[old]
            cache[key] = cache[whole][p0 * k: (p0 + bp - 1) * k + 1,
                                      u0: u0 + bu, v0: v0 + bv].contiguous()
        return cache[key]

    def _stacked_grids(self, density, k0, mask_g, axis, clip_sizes, offs,
                       f32_cot=False):
        """[X, Y, Z, 2 + k0_dim] (density, mask, k0) in ``sweep_dtype``,
        sliced to the clip box (``clip_sizes`` permuted, ``offs`` ints, or
        an integer tensor on the grids' device read as device data) before
        the cast; differentiable in density and k0 (``f32_cot``: by
        unrounded gradients, :mod:`..ops.rounding`)."""
        sdt = self.sweep_dtype
        inv = {ax: i for i, ax in enumerate(sweep_ops._PERMS[axis])}
        if clip_sizes is not None and torch.is_tensor(offs):
            box = grid_ops.DeviceBox(
                offs, tuple(int(clip_sizes[inv[a]]) for a in range(3)),
                density.shape, sweep_ops._PERMS[axis])
            density, mask_g, k0 = (box.take(t) for t in (density, mask_g, k0))
        elif clip_sizes is not None:
            sl = tuple(slice(offs[inv[a]], offs[inv[a]]
                             + int(clip_sizes[inv[a]])) for a in range(3))
            density, mask_g, k0 = density[sl], mask_g[sl], k0[sl]
        def cast(t):
            return rounding.to_dtype(t, sdt, f32_cot)
        return torch.cat([cast(density)[..., None], cast(mask_g)[..., None],
                          cast(k0)], -1)

    def forward_sweep(self, rays_o, rays_d, viewdirs, axis, *, near, far, bg,
                      stepsize, render_depth=False, clip_sizes=None,
                      clip_offsets=None, grids_pre_clipped=False,
                      tile_windows=None, block_windows=None, grids=None,
                      f32_cot=False, **_):
        """Station-sweep volume rendering of a ray batch whose rays share
        the dominant ``axis``: density, mask and colour features are swept
        in one pass (kernel K-A), composited with early termination, and the
        colour MLP runs on the top-``sweep_color_topk`` stations per ray by
        weight when the sweep is long enough.

        With gradients enabled the result is differentiable in the grids
        and the MLP (the sweep's backward is kernel K-C) and the grids are
        read afresh; under ``torch.no_grad()`` the station slabs come from
        the per-model cache. ``grids`` = (density, k0, mask) replaces the
        module's own tensors; with ``grids_pre_clipped`` they are already
        the clip box (xyz order), so their gradients stay box-sized (the
        region-sliced train step). ``tile_windows`` = (v_base, wv):
        per-ray-tile v-windows of an unclipped sweep. ``block_windows`` =
        ((B, wu, wv), (u_off, v_off)): per-p-block (u, v) windows of an
        unclipped sweep (:func:`..ops.sweep.sweep_samples_blocked`, the
        blocked train step), read from the grids with gradients.
        ``f32_cot``: the gradients of the bf16 grid and MLP paths come back
        unrounded (:mod:`..ops.rounding`; the data-parallel step).

        Returns a dict with ``rgb_marched [N, 3]``, ``alphainv_last [N]``,
        ``weights``, ``raw_alpha``, ``raw_rgb_cl``, ``wmask`` and optionally
        ``depth [N]`` (no gradient).
        """
        k = sweep_ops.substeps_for_stepsize(stepsize)
        common = dict(
            clip_sizes=clip_sizes,
            clip_offsets=None if clip_sizes is None else clip_offsets,
            world_size=tuple(self.world_size))
        if block_windows is not None and clip_sizes is None:
            density, k0, mask_g = grids if grids is not None else (
                self.density, self.k0, self.mask)
            block_sizes, (u_off, v_off) = block_windows
            out = sweep_ops.sweep_samples_blocked(
                self._stacked_grids(density, k0, mask_g, axis, None, None,
                                    f32_cot),
                rays_o, rays_d, self.xyz_min, self.xyz_max, axis, k,
                block_sizes, u_off, v_off, interp_dtype=self.sweep_dtype,
                f32_cot=f32_cot)
        elif grids is None and not torch.is_grad_enabled():
            out = sweep_ops.sweep_samples(
                None, rays_o, rays_d, self.xyz_min, self.xyz_max, axis, k,
                slabs=self._sweep_slabs(axis, k, clip_sizes, clip_offsets),
                **common)
        else:
            density, k0, mask_g = grids if grids is not None else (
                self.density, self.k0, self.mask)
            offs = (None if clip_sizes is None or grids_pre_clipped
                    else clip_offsets if torch.is_tensor(clip_offsets)
                    else [int(v) for v in np.asarray(clip_offsets)])
            grid_cat = self._stacked_grids(
                density, k0, mask_g, axis,
                None if grids_pre_clipped else clip_sizes, offs, f32_cot)
            out = sweep_ops.sweep_samples(
                grid_cat, rays_o, rays_d, self.xyz_min, self.xyz_max, axis,
                k, interp_dtype=self.sweep_dtype, pre_clipped=True,
                tile_windows=tile_windows, f32_cot=f32_cot, **common)
        vals, t, fwd = out["vals"], out["t"], out["forward"]
        density_s, mask_s, k0_cl = vals[0], vals[1], vals[2:]

        t_lo, t_hi = rm.ray_aabb_tminmax(
            rays_o, rays_d, *self.bounds_on(rays_o.device), near, far)
        valid = ((t >= t_lo[:, None]) & (t <= t_hi[:, None])
                 & (t_hi > t_lo)[:, None] & (mask_s > 0))
        interval = (out["interval"] / self.voxel_size_base)[:, None]
        alpha = rm.raw2alpha(density_s, self.act_shift, interval)
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
        s_total = t.shape[1]
        topk = self.sweep_color_topk
        compact = (self.has_rgbnet and self.fast_color_thres > 0
                   and 0 < topk < s_total and s_total > max(96, 2 * topk))
        if compact:
            idx, sel_nk, sel_cl = sweep_ops.topk_station_select(
                w_eff.detach(), topk)
            w_eff = sel_nk(w_eff)
            wmask = torch.gather(wmask, 1, idx)
            alpha = torch.gather(alpha, 1, idx)
            t = sel_nk(t)
            if self.k0_dim > 0:
                k0_cl = sel_cl(k0_cl)
        if not self.has_rgbnet:
            rgb_cl = torch.sigmoid(k0_cl)
        else:
            vd_emb = mlp_lib.positional_encoding(viewdirs, self.viewbase_pe)
            if self.rgbnet_direct:
                logit_cl = mlp_lib.mlp_apply_split_cl(
                    self.rgbnet, k0_cl, vd_emb, compute_dtype=self.mlp_dtype,
                    f32_cot=f32_cot)
                rgb_cl = torch.sigmoid(logit_cl)
            else:
                logit_cl = mlp_lib.mlp_apply_split_cl(
                    self.rgbnet, k0_cl[3:], vd_emb,
                    compute_dtype=self.mlp_dtype, f32_cot=f32_cot)
                rgb_cl = torch.sigmoid(logit_cl + k0_cl[:3])

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
            d_norm = torch.sqrt(torch.sum(rays_d * rays_d, -1))
            t_safe = torch.where(wmask, t, torch.zeros_like(t))
            ret["depth"] = (torch.sum(w_eff * t_safe, 1) * d_norm).detach()
        return ret

    # ------------------------------------------------ fused train forward

    def supports_fused_step(self):
        """Whether the fused train step (:mod:`..ops.train_fused`, kernels
        K-D and K-E) can stand in for :meth:`forward_sweep` and the losses'
        reductions: the standard fine-stage composition with a three-layer
        split MLP over (k0 features, view embedding) and
        ``fast_color_thres`` gates."""
        return (self.has_rgbnet and not self.implicit_voxel_feat
                and not self.rgbnet_full_implicit and self.posbase_pe == 0
                and self.k0_dim > 0 and self.rgbnet_depth == 3
                and self.fast_color_thres > 0
                and self.sweep_dtype == torch.bfloat16
                and (self.k0_dim if self.rgbnet_direct
                     else self.k0_dim - 3) >= 1)

    def forward_sweep_fused(self, rays_o, rays_d, viewdirs, axis, target, *,
                            near, far, bg, stepsize, grids=None,
                            clip_offsets=None, window=None, s_blk=None,
                            nt=None, **_):
        """Fused train forward: the arithmetic of :meth:`forward_sweep` and
        the losses' per-ray reductions in one kernel (K-D; K-E backward).

        ``grids`` = (density, k0, mask) already sliced to the sweep box (xyz
        order; default: the module's whole grids) with ``clip_offsets`` the
        box's start voxels in permuted order. The batch must be
        direction-uniform along ``axis``. ``window`` = (wu, wv) (multiples
        of 16 and 8): every (8-station block, 512-ray tile) cell reads only
        its own window of the slabs; exact when every cell's support fits,
        as for the batches of
        :func:`..ops.sweep.build_ray_tiles_blocktile`.

        Returns dict(rgb_marched [N, 3], alphainv_last [N], rgbper_sum
        [N]); ``rgbper_sum`` is ``sum_s w_eff * |rgb_s - target|^2`` per
        ray with the weights detached.
        """
        from ..ops import train_fused as tf

        k = sweep_ops.substeps_for_stepsize(stepsize)
        density, k0, mask_g = grids if grids is not None else (
            self.density, self.k0, self.mask)
        perm = sweep_ops._PERMS[axis]
        density_pm = density.float().permute(*perm)
        mask_pm = mask_g.float().permute(*perm)
        k0_pm = k0.float().permute(*perm, 3)

        o_pv, d_pv = sweep_ops.rays_to_voxel(
            rays_o, rays_d, self.xyz_min, self.xyz_max,
            tuple(self.world_size), axis)
        if clip_offsets is not None:
            offs = [float(v) for v in np.asarray(clip_offsets)]
            o_pv = tuple(o - off for o, off in zip(o_pv, offs))
        dp = d_pv[0]
        dp_safe = torch.where(dp == 0, torch.full_like(dp, 1e-10), dp)
        dev = rays_o.device
        t_lo, t_hi = rm.ray_aabb_tminmax(
            rays_o, rays_d, torch.as_tensor(self.xyz_min, device=dev),
            torch.as_tensor(self.xyz_max, device=dev), near, far)
        d_norm = torch.sqrt(torch.sum(rays_d * rays_d, -1))
        interval = d_norm / (k * torch.clamp(dp.abs(), min=1e-10)) \
            / self.voxel_size_base
        zeros = torch.zeros_like(dp)
        rays16 = torch.stack(
            [o_pv[0], o_pv[1], o_pv[2], dp_safe, d_pv[1], d_pv[2],
             t_lo, t_hi, interval, target[:, 0], target[:, 1], target[:, 2],
             zeros, zeros, zeros, zeros]).float().detach()

        fdim = self.k0_dim if self.rgbnet_direct else self.k0_dim - 3
        l0 = self.rgbnet.layers[0]
        vd_emb = mlp_lib.positional_encoding(viewdirs, self.viewbase_pe)
        sh1_t = (vd_emb @ l0.weight.t()[fdim:] + l0.bias).t().float()

        wu, wv = (int(window[0]), int(window[1])) if window else (0, 0)
        cfg = tf.FusedCfg(
            k=int(k), f=int(fdim), width=int(self.rgbnet_width),
            act_shift=float(self.act_shift),
            thres=float(self.fast_color_thres), bg=float(bg),
            direct=bool(self.rgbnet_direct), wu=wu, wv=wv,
            s_blk=int(s_blk or tf.S_BLK), nt=int(nt or tf.NT))
        rgb, ainv, rgbper = tf.fused_chain(
            cfg, density_pm, k0_pm, mask_pm, rays16, sh1_t, self.rgbnet)
        return {"rgb_marched": rgb, "alphainv_last": ainv,
                "rgbper_sum": rgbper}

    # ---------------------------------------------------- per-voxel lr init

    def voxel_count_views(self, rays_o_tr, rays_d_tr, imsz, near, far,
                          stepsize, downrate=1, irregular_shape=False):
        """Count, per voxel, how many training views touch it (per view
        the grid's gradient of the summed samples of its rays, thresholded
        at ``> 1``); returns the [X, Y, Z] f32 count. Two forms, chosen as
        the JAX package chooses them: by ``query_mode``, or by the
        environment's ``DVGO_COUNT_FORM`` ('sweep' or 'exact'; any other
        value raises ``ValueError``):

        - the sweep form: the station-sweep transpose of an all-ones
          cotangent at one f32 channel (kernel K-A forward of a zero grid,
          K-C backward), each view swept along its camera's dominant axis
          by ray majority;
        - the exact form (:meth:`_voxel_count_views_exact`): the trilinear
          weights of ``|world_size + 1| / stepsize + 1`` samples per ray at
          fixed arc-length steps, scattered with ``index_add_``."""
        form = os.environ.get("DVGO_COUNT_FORM", "")
        if form not in ("", "sweep", "exact"):
            raise ValueError(
                f"DVGO_COUNT_FORM={form!r}: expected 'sweep' or 'exact'")
        use_sweep = (form == "sweep" if form
                     else self.query_mode == "sweep")
        views = self._count_views(rays_o_tr, rays_d_tr, imsz, downrate)
        if not use_sweep:
            return self._voxel_count_views_exact(views, near, far, stepsize)
        dev = self.device
        count = torch.zeros(self.world_size, dtype=torch.float32, device=dev)
        k = sweep_ops.substeps_for_stepsize(stepsize)
        for ro, rd in views:
            axes = sweep_ops.dominant_axis(rd, self.xyz_min, self.xyz_max,
                                           self.world_size)
            axis = int(np.bincount(axes, minlength=3).argmax())
            perm = sweep_ops._PERMS[axis]
            rays_pv = sweep_ops.rays_to_voxel(
                torch.as_tensor(ro, device=dev),
                torch.as_tensor(rd, device=dev), self.xyz_min, self.xyz_max,
                self.world_size, axis)
            grid_perm = torch.zeros(
                (*(int(self.world_size[a]) for a in perm), 1),
                dtype=torch.float32, device=dev, requires_grad=True)
            with torch.enable_grad():
                vals, _ = sweep_ops.station_sweep(grid_perm, rays_pv, k)
                g_view, = torch.autograd.grad(vals[0].sum(), grid_perm)
            g_view = g_view[..., 0].permute(*np.argsort(perm).tolist())
            count += (g_view > 1).float()
        return count

    @staticmethod
    def _count_views(rays_o_tr, rays_d_tr, imsz, downrate):
        """Yield the training rays of each view with rays, as contiguous
        f32 ``[n, 3]`` numpy pairs (image layouts subsampled by
        ``downrate``)."""
        is_list = isinstance(rays_o_tr, list)
        views_o = rays_o_tr if is_list else np.split(
            np.asarray(rays_o_tr), np.cumsum(imsz)[:-1])
        views_d = rays_d_tr if is_list else np.split(
            np.asarray(rays_d_tr), np.cumsum(imsz)[:-1])
        for ro, rd in zip(views_o, views_d):
            ro, rd = np.asarray(ro), np.asarray(rd)
            while ro.ndim > 3:   # split() leaves a leading length-1 dim
                ro, rd = ro[0], rd[0]
            if ro.ndim == 3:     # [H, W, 3] image layout
                ro, rd = ro[::downrate, ::downrate], rd[::downrate, ::downrate]
            ro = np.ascontiguousarray(ro.reshape(-1, 3), np.float32)
            rd = np.ascontiguousarray(rd.reshape(-1, 3), np.float32)
            if ro.shape[0]:
                yield ro, rd

    @torch.no_grad()
    def _voxel_count_views_exact(self, views, near, far, stepsize,
                                 chunk=65536):
        """The exact view count: per view and chunk of rays, samples at
        ``t_min + stepsize * voxel_size * j / |d|`` (``t_min`` the bbox
        entry clamped to [near, far]; no bbox mask: samples outside clamp
        to the border voxels), each adding its 8 trilinear corner weights
        to the view's sum (:func:`..ops.grid.trilinear_splat_`)."""
        dev = self.device
        dims = tuple(int(v) for v in self.world_size)
        count = torch.zeros(dims, dtype=torch.float32, device=dev)
        n_samples = int(np.linalg.norm(np.array(self.world_size) + 1)
                        / stepsize) + 1
        step = (stepsize * self.voxel_size) * torch.arange(
            n_samples, dtype=torch.float32, device=dev)
        lo, hi = self.bounds_on(dev)
        g_view = torch.empty(int(np.prod(dims)), dtype=torch.float32,
                             device=dev)
        for ro_v, rd_v in views:
            g_view.zero_()
            for i in range(0, ro_v.shape[0], chunk):
                ro = torch.as_tensor(ro_v[i:i + chunk], device=dev)
                rd = torch.as_tensor(rd_v[i:i + chunk], device=dev)
                vec = torch.where(rd == 0, torch.full_like(rd, 1e-6), rd)
                t_min = torch.clamp(torch.amax(torch.minimum(
                    (hi - ro) / vec, (lo - ro) / vec), -1), near, far)
                interp = t_min[:, None] + step[None, :] / torch.linalg.norm(
                    rd, dim=-1, keepdim=True)
                pts = ro[:, None, :] + rd[:, None, :] * interp[..., None]
                idx = grid_ops.world_to_grid(pts, lo, hi, dims)
                grid_ops.trilinear_splat_(
                    g_view, idx[..., 0], idx[..., 1], idx[..., 2], dims, 1.0)
            count += (g_view.reshape(dims) > 1).float()
        return count
