"""DirectVoxGO: dense density and colour-feature voxel grids with a shallow
view-dependent MLP, rendered by the station sweep (render subset).

Grids are channels-last ``[X, Y, Z(, C)]`` parameters of the module, the
occupancy mask a boolean buffer of the density grid's shape. Only the
no-grad sweep forward is ported; training, the gather forward and the
implicit colour variants are later slices (ROADMAP queue A).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..ops import grid as grid_ops
from ..ops import raymarch as rm
from ..ops import sweep as sweep_ops
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

    def _mask_from_coarse_ckpt(self, path, thres):
        """Occupancy of a coarse checkpoint (``alpha(maxpool(density)) >=
        thres``) looked up at this grid's points."""
        from ..engine import checkpoint as ckpt_lib
        st = ckpt_lib.load_checkpoint_file(path)
        c_kwargs = st["model_kwargs"]
        dev = self.density.device
        c_density = torch.as_tensor(st["model_state_dict"]["density"],
                                    device=dev)
        alpha = rm.raw2alpha(grid_ops.max_pool3d_same(c_density),
                             c_kwargs["act_shift"],
                             c_kwargs["voxel_size_ratio"])
        c_mask = alpha >= thres
        c_min = [float(v) for v in np.asarray(c_kwargs["xyz_min"], np.float64)]
        c_max = [float(v) for v in np.asarray(c_kwargs["xyz_max"], np.float64)]
        xs, ys, zs = (torch.as_tensor(np.linspace(
            self.xyz_min[a], self.xyz_max[a], self.world_size[a]),
            dtype=torch.float32, device=dev) for a in range(3))
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

    def _sweep_slabs(self, axis, k, clip_sizes, clip_offsets):
        """Station slabs [S, Gu, Gv, 2 + k0_dim] (density, mask, k0) of a
        sweep along ``axis`` over the clip box (or the whole grid), in
        ``sweep_dtype``; built once per view direction class, not per ray
        chunk."""
        offs = (None if clip_sizes is None
                else tuple(int(v) for v in np.asarray(clip_offsets)))
        key = (axis, k, self.sweep_dtype, clip_sizes, offs)
        cache = self.grid_cache("sweep_slabs")
        if key in cache:
            return cache[key]
        sdt = self.sweep_dtype
        density, k0, mask_g = self.density, self.k0, self.mask
        if clip_sizes is not None:
            inv = {ax: i for i, ax in enumerate(sweep_ops._PERMS[axis])}
            sl = tuple(slice(offs[inv[a]], offs[inv[a]]
                             + int(clip_sizes[inv[a]])) for a in range(3))
            density, mask_g, k0 = density[sl], mask_g[sl], k0[sl]
        with torch.no_grad():
            grid_cat = torch.cat([density.to(sdt)[..., None],
                                  mask_g.to(sdt)[..., None], k0.to(sdt)], -1)
            cache[key] = sweep_ops._station_slabs(
                sweep_ops.permute_grid(grid_cat, axis, dtype=sdt),
                k).contiguous()
        return cache[key]

    def activate_density(self, density, interval=None):
        interval = interval if interval is not None else self.voxel_size_ratio
        return rm.raw2alpha(density, self.act_shift, interval)

    def sweep_clip_for_axis(self, axis, quantum=16):
        """(clip_sizes, clip_offsets) for :meth:`forward_sweep`: the
        occupancy bbox in permuted order, sizes rounded up to ``quantum``
        voxels; (None, zeros) when clipping would not shrink anything."""
        cache = getattr(self, "_mask_bbox_cache", None)
        if cache is not None and cache[0] is self.mask:
            lo, hi = cache[1]
        else:
            lo, hi = grid_ops.mask_bbox_vox(self.mask)
            self._mask_bbox_cache = (self.mask, (lo, hi))
        perm = sweep_ops._PERMS[axis]
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

    # ----------------------------------------------------- sweep forward

    @torch.no_grad()
    def forward_sweep(self, rays_o, rays_d, viewdirs, axis, *, near, far, bg,
                      stepsize, render_depth=False, clip_sizes=None,
                      clip_offsets=None, **_):
        """Station-sweep volume rendering of a ray batch whose rays share
        the dominant ``axis``: density, mask and colour features are swept
        in one pass (kernel K-A), composited with early termination, and the
        colour MLP runs on the top-``sweep_color_topk`` stations per ray by
        weight when the sweep is long enough. Returns a dict with
        ``rgb_marched [N, 3]``, ``alphainv_last [N]``, ``weights``,
        ``raw_alpha``, ``raw_rgb_cl``, ``wmask`` and optionally
        ``depth [N]``.
        """
        k = sweep_ops.substeps_for_stepsize(stepsize)
        slabs = self._sweep_slabs(axis, k, clip_sizes, clip_offsets)
        out = sweep_ops.sweep_samples(
            slabs, k, rays_o, rays_d, self.xyz_min, self.xyz_max, axis,
            tuple(self.world_size),
            clip_offsets=None if clip_sizes is None else clip_offsets)
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
            idx, sel_nk, sel_cl = sweep_ops.topk_station_select(w_eff, topk)
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
            ret["depth"] = torch.sum(w_eff * t_safe, 1) * d_norm
        return ret
