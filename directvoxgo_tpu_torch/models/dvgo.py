"""DirectVoxGO: dense density and colour-feature voxel grids with a shallow
view-dependent MLP, rendered and trained through the station sweep.

Grids are channels-last ``[X, Y, Z(, C)]`` parameters of the module, the
occupancy mask a boolean buffer of the density grid's shape. The sweep
forward is differentiable in the grids and the MLP (kernel K-A forward, K-C
backward); under ``torch.no_grad()`` it reads cached station slabs instead.
The state surgery of training lives here too: near-camera maskout,
progressive rescaling, occupancy renewal, clip boxes, the coarse-geometry
ray filter and the per-voxel view count. The gather forward, the exact
(gather) view count and the implicit colour variants are not ported yet
(ROADMAP queue A).
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


def _round_up(x, m):
    return ((int(x) + m - 1) // m) * m


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
        if rgbnet_dim > 0 and (rgbnet_full_implicit or posbase_pe > 0
                               or implicit_voxel_feat):
            raise NotImplementedError(
                "implicit colour, positional-embedding colour and grid-LIIF "
                "variants are not ported yet (ROADMAP A: model variants)")
        if query_mode != "sweep":
            raise NotImplementedError(
                f"query_mode {query_mode!r}: only the sweep forward is "
                "ported yet (ROADMAP A: gather forward)")
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
            self.k0_dim = rgbnet_dim
            dim0 = 3 + 3 * viewbase_pe * 2
            dim0 += self.k0_dim if rgbnet_direct else self.k0_dim - 3
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
        fast_color_thres``."""
        alpha = grid_ops.max_pool3d_same(self.activate_density(self.density))
        self.mask = self.mask & (alpha > self.fast_color_thres)

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

    def _hit_from_rays(self, rays_o, rays_d, near, far, stepsize):
        stepdist = stepsize * self.voxel_size
        n_samples = rm.max_samples_for_bbox(self.xyz_min, self.xyz_max,
                                            stepdist)
        bbox_min = tuple(float(v) for v in self.xyz_min)
        bbox_max = tuple(float(v) for v in self.xyz_max)
        (px, py, pz), valid, _ = rm.sample_points_dense_parts(
            rays_o, rays_d, bbox_min, bbox_max, near, far, stepdist,
            n_samples)
        occ = grid_ops.occupancy_lookup_parts(self.mask, px, py, pz,
                                              bbox_min, bbox_max)
        return torch.any(occ & valid, -1)

    @torch.no_grad()
    def hit_coarse_geo(self, rays_o, rays_d, near, far, stepsize,
                       chunk=65536, **_):
        """[N] numpy bool: rays with a sample in the cached occupancy."""
        rays_o = np.asarray(rays_o, np.float32).reshape(-1, 3)
        rays_d = np.asarray(rays_d, np.float32).reshape(-1, 3)
        outs = []
        for i in range(0, rays_o.shape[0], chunk):
            outs.append(self._hit_from_rays(
                torch.as_tensor(rays_o[i:i + chunk], device=self.device),
                torch.as_tensor(rays_d[i:i + chunk], device=self.device),
                float(near), float(far), float(stepsize)))
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

    # ----------------------------------------------------- sweep forward

    def _sweep_slabs(self, axis, k, clip_sizes, clip_offsets):
        """Station slabs [S, Gu, Gv, 2 + k0_dim] (density, mask, k0) of a
        sweep along ``axis`` over the clip box (or the whole grid), in
        ``sweep_dtype``; the render path's cache (no gradient), built once
        per view direction class, not per ray chunk."""
        offs = (None if clip_sizes is None
                else tuple(int(v) for v in np.asarray(clip_offsets)))
        key = (axis, k, self.sweep_dtype, clip_sizes, offs)
        cache = self.grid_cache("sweep_slabs")
        if key in cache:
            return cache[key]
        with torch.no_grad():
            grid_cat = self._stacked_grids(self.density, self.k0, self.mask,
                                           axis, clip_sizes, offs)
            cache[key] = sweep_ops._station_slabs(
                sweep_ops.permute_grid(grid_cat, axis,
                                       dtype=self.sweep_dtype),
                k).contiguous()
        return cache[key]

    def _stacked_grids(self, density, k0, mask_g, axis, clip_sizes, offs):
        """[X, Y, Z, 2 + k0_dim] (density, mask, k0) in ``sweep_dtype``,
        sliced to the clip box (``clip_sizes`` permuted, ``offs`` ints)
        before the cast; differentiable in density and k0."""
        sdt = self.sweep_dtype
        if clip_sizes is not None:
            inv = {ax: i for i, ax in enumerate(sweep_ops._PERMS[axis])}
            sl = tuple(slice(offs[inv[a]], offs[inv[a]]
                             + int(clip_sizes[inv[a]])) for a in range(3))
            density, mask_g, k0 = density[sl], mask_g[sl], k0[sl]
        return torch.cat([density.to(sdt)[..., None],
                          mask_g.to(sdt)[..., None], k0.to(sdt)], -1)

    def forward_sweep(self, rays_o, rays_d, viewdirs, axis, *, near, far, bg,
                      stepsize, render_depth=False, clip_sizes=None,
                      clip_offsets=None, grids_pre_clipped=False,
                      tile_windows=None, grids=None, **_):
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
        per-ray-tile v-windows of an unclipped sweep.

        Returns a dict with ``rgb_marched [N, 3]``, ``alphainv_last [N]``,
        ``weights``, ``raw_alpha``, ``raw_rgb_cl``, ``wmask`` and optionally
        ``depth [N]`` (no gradient).
        """
        k = sweep_ops.substeps_for_stepsize(stepsize)
        common = dict(
            clip_sizes=clip_sizes,
            clip_offsets=None if clip_sizes is None else clip_offsets,
            world_size=tuple(self.world_size))
        if grids is None and not torch.is_grad_enabled():
            out = sweep_ops.sweep_samples(
                None, rays_o, rays_d, self.xyz_min, self.xyz_max, axis, k,
                slabs=self._sweep_slabs(axis, k, clip_sizes, clip_offsets),
                **common)
        else:
            density, k0, mask_g = grids if grids is not None else (
                self.density, self.k0, self.mask)
            offs = (None if clip_sizes is None or grids_pre_clipped
                    else [int(v) for v in np.asarray(clip_offsets)])
            grid_cat = self._stacked_grids(
                density, k0, mask_g, axis,
                None if grids_pre_clipped else clip_sizes, offs)
            out = sweep_ops.sweep_samples(
                grid_cat, rays_o, rays_d, self.xyz_min, self.xyz_max, axis,
                k, interp_dtype=self.sweep_dtype, pre_clipped=True,
                tile_windows=tile_windows, **common)
        vals, t, fwd = out["vals"], out["t"], out["forward"]
        density_s, mask_s, k0_cl = vals[0], vals[1], vals[2:]

        dev = rays_o.device
        t_lo, t_hi = rm.ray_aabb_tminmax(
            rays_o, rays_d, torch.as_tensor(self.xyz_min, device=dev),
            torch.as_tensor(self.xyz_max, device=dev), near, far)
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
                    self.rgbnet, k0_cl, vd_emb, compute_dtype=self.mlp_dtype)
                rgb_cl = torch.sigmoid(logit_cl)
            else:
                logit_cl = mlp_lib.mlp_apply_split_cl(
                    self.rgbnet, k0_cl[3:], vd_emb,
                    compute_dtype=self.mlp_dtype)
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
        """Count, per voxel, how many training views touch it: per view the
        station-sweep transpose of an all-ones cotangent at one f32 channel
        (kernel K-A forward of a zero grid, K-C backward), thresholded at
        ``> 1``. Each view sweeps along its camera's dominant axis by ray
        majority. Returns the [X, Y, Z] f32 count."""
        if self.query_mode != "sweep":
            raise NotImplementedError(
                "the exact (gather) view count is not ported yet (ROADMAP A: "
                "gather forward)")
        dev = self.device
        count = torch.zeros(self.world_size, dtype=torch.float32, device=dev)
        k = sweep_ops.substeps_for_stepsize(stepsize)
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
            if ro.shape[0] == 0:
                continue
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
