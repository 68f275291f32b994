"""Image-conditioned single-scene triplane DVGO.

A learned density voxel grid (as in DirectVoxGO) whose colour features
come from three image-conditioned 2D planes instead of a 3D feature grid.
Three conditioning views (rgb + rays_o + rays_d, 9 channels, NCHW) pass
through an EDSR encoder, then the pose-conditioned ``Mapping`` per plane,
whose pose input is the view's pose minus a canonical spherical anchor.
Colour queries sample the planes bilinearly at (x, y) / (y, z) / (z, x)
and aggregate by concatenation or sum; LIIF replaces the bilinear tap by a
4-tap local ensemble decoded by per-plane MLPs (``interp_zx`` starts as a
copy of ``interp_yz``'s weights and trains on its own, as the JAX package's
optimizer updates the two leaves apart).

The geometry is the gather forward's (its samplers, as the JAX package's
compiler computes them): dense samples, the occupied ones compacted to ``k_density``,
trilinear density, compositing, the ``k_color`` samples of largest weight
kept for the colour query. Unlike DirectVoxGO's gather forward the weight
the colour cap drops is not returned to ``alphainv_last``, as in the JAX
package's conditioned models.

Progressive scaling resizes the density grid and refreshes the mask; the
JAX package's ``TriDVGO`` inherits a rescale that reads the ``k0`` grid it
deleted and raises (ROADMAP, known JAX faults).
"""

from __future__ import annotations

import copy

import numpy as np
import torch
from torch import nn

from ..data.load_blender import pose_spherical
from ..ops import grid as grid_ops
from ..ops import raymarch as rm
from . import backbone
from . import mlp as mlp_lib
from . import nets
from . import prng
from .dvgo import DirectVoxGO

PLANE_AXES = {"xy": (0, 1), "yz": (1, 2), "zx": (2, 0)}
PLANES = ("xy", "yz", "zx")


def anchor_poses():
    """The three canonical spherical anchor poses ``[3, 4, 4]``."""
    return np.stack([
        pose_spherical(theta=0, phi=90, radius=4),
        pose_spherical(theta=90, phi=0, radius=4),
        pose_spherical(theta=90, phi=90, radius=4),
    ], 0).astype(np.float32)


def _planes_last(x):
    """``[C, h, w]`` map -> ``[h, w, C]`` plane."""
    return x.permute(1, 2, 0)


class TriDVGO(DirectVoxGO):
    """Learned density grid + image-conditioned triplane colour."""

    def __init__(self, xyz_min, xyz_max,
                 num_voxels=0, num_voxels_base=0, alpha_init=None,
                 mask_cache_path=None, mask_cache_thres=1e-3,
                 fast_color_thres=0,
                 rgbnet_dim=12, rgbnet_direct=True, rgbnet_depth=3,
                 rgbnet_width=128, viewbase_pe=4, posbase_pe=0,
                 tri_aggregation="concat", liif=False,
                 implicit_voxel_feat=False, local_ensemble=True,
                 cell_decode=True, feat_unfold=False,
                 interp_width=128, interp_depth=5,
                 map_depth=1, map_width=64,
                 n_feats=64, n_resblocks=16, res_scale=1,
                 k_density=None, k_color=64, seed=0, device=None,
                 **kwargs):
        super().__init__(
            xyz_min, xyz_max, num_voxels=num_voxels,
            num_voxels_base=num_voxels_base, alpha_init=alpha_init,
            mask_cache_path=mask_cache_path,
            mask_cache_thres=mask_cache_thres,
            fast_color_thres=fast_color_thres, rgbnet_dim=0,
            k_density=k_density, k_color=k_color, seed=seed, device=device)
        self.k0 = None
        dev = self.density.device
        k_enc, k_map, k_rgb, k_ixy, k_iyz, _ = prng.split(
            prng.prng_key(seed), 6)

        self.tri_aggregation = tri_aggregation
        self.liif = bool(liif or implicit_voxel_feat)
        self.local_ensemble = local_ensemble
        self.cell_decode = cell_decode
        self.feat_unfold = feat_unfold
        self.rgbnet_dim = rgbnet_dim
        self.rgbnet_direct = rgbnet_direct
        self.viewbase_pe = viewbase_pe
        self.posbase_pe = posbase_pe
        self.k0_dim = rgbnet_dim * 3 if tri_aggregation == "concat" \
            else rgbnet_dim
        self.pose_anchor = anchor_poses()
        self.encoder_kwargs = dict(n_feats=n_feats, n_resblocks=n_resblocks,
                                   res_scale=res_scale)
        self.rgbnet_kwargs = {
            "rgbnet_dim": rgbnet_dim, "rgbnet_direct": rgbnet_direct,
            "rgbnet_depth": rgbnet_depth, "rgbnet_width": rgbnet_width,
            "viewbase_pe": viewbase_pe, "posbase_pe": posbase_pe,
            "tri_aggregation": tri_aggregation, "liif": self.liif,
            "local_ensemble": local_ensemble, "cell_decode": cell_decode,
            "feat_unfold": feat_unfold,
            "interp_width": interp_width, "interp_depth": interp_depth,
            "map_depth": map_depth, "map_width": map_width,
            "n_feats": n_feats, "n_resblocks": n_resblocks,
            "res_scale": res_scale,
        }

        self.encoder, _ = backbone.make_edsr_baseline(
            n_resblocks=n_resblocks, n_feats=n_feats, res_scale=res_scale,
            no_upsampling=True, n_colors=9, key=k_enc, device=dev)
        self.map = nets.Mapping(n_feats + 16, rgbnet_dim, map_depth,
                                map_width, key=k_map, device=dev)
        dim0 = 3 + 3 * viewbase_pe * 2
        dim0 += self.k0_dim if rgbnet_direct else self.k0_dim - 3
        self.rgbnet_dim0 = dim0
        self.rgbnet = mlp_lib.MLP(dim0, rgbnet_width, rgbnet_depth, 3,
                                  key=k_rgb, device=dev)
        self.has_rgbnet = True
        if self.liif:
            # decoder input: the feature (3x3-unfolded), the relative
            # coordinate (2), the cell (2)
            in_dim = (rgbnet_dim * (9 if feat_unfold else 1) + 2
                      + (2 if cell_decode else 0))
            self.interp_xy = nets.InterpMLP(in_dim, rgbnet_dim, interp_width,
                                            interp_depth, key=k_ixy,
                                            device=dev)
            self.interp_yz = nets.InterpMLP(in_dim, rgbnet_dim, interp_width,
                                            interp_depth, key=k_iyz,
                                            device=dev)
            # the reference shares zx's decoder with yz at init
            self.interp_zx = copy.deepcopy(self.interp_yz)

    def jax_groups(self):
        """name -> grid parameter or module, the JAX pytree's top level."""
        names = ["density", "encoder", "map", "rgbnet"]
        if self.liif:
            names += ["interp_xy", "interp_yz", "interp_zx"]
        return {n: getattr(self, n) for n in names}

    def get_kwargs(self):
        return {
            "xyz_min": np.asarray(self.xyz_min),
            "xyz_max": np.asarray(self.xyz_max),
            "num_voxels": self.num_voxels,
            "num_voxels_base": self.num_voxels_base,
            "alpha_init": self.alpha_init,
            "mask_cache_path": self.mask_cache_path,
            "mask_cache_thres": self.mask_cache_thres,
            "fast_color_thres": self.fast_color_thres,
            "k_density": self.k_density,
            "k_color": self.k_color,
            **self.rgbnet_kwargs,
        }

    # ------------------------------------------------------- state surgery

    @torch.no_grad()
    def scale_volume_grid(self, num_voxels):
        """Progressive scaling: the density grid resized (align-corners
        trilinear), the mask refreshed from it (``maxpool(alpha) >
        fast_color_thres``) and, with a coarse checkpoint, its occupancy."""
        ori = self.world_size
        self._set_grid_resolution(num_voxels)
        print("tri_dvgo: scale_volume_grid from", ori, "to", self.world_size)
        density = grid_ops.resize_trilinear(self.density.data,
                                            tuple(self.world_size))
        mask = grid_ops.max_pool3d_same(rm.raw2alpha(
            density, self.act_shift, self.voxel_size_ratio)) \
            > self.fast_color_thres
        if self.mask_cache_path:
            mask = self._mask_from_coarse_ckpt(
                self.mask_cache_path, self.mask_cache_thres) & mask
        self.density = nn.Parameter(density.contiguous())
        self.mask = mask

    # --------------------------------------------------------- conditioning

    def anchors_on(self, device):
        cache = self.__dict__.setdefault("_anchor_cache", {})
        if device not in cache:
            cache[device] = torch.as_tensor(self.pose_anchor, device=device)
        return cache[device]

    def encode_feat(self, rgb_lr, pose_lr):
        """3 conditioning views ``rgb_lr [3, 9, H, W]`` (NCHW) with their
        poses ``pose_lr [3, 4, 4]`` -> ``{'xy', 'yz', 'zx'}`` planes ``[h,
        w, C]``."""
        feats3 = backbone.edsr_apply(self.encoder, rgb_lr)
        anchors = self.anchors_on(rgb_lr.device)
        planes = {}
        for i, name in enumerate(PLANES):
            rel_pose = (pose_lr[i] - anchors[i])[None]
            mapped = nets.mapping_apply(self.map, feats3[i:i + 1], rel_pose)
            planes[name] = _planes_last(mapped[0])
        return planes

    # ------------------------------------------------------- plane queries

    def _norm_to_plane(self, v, axis, n):
        lo, hi = float(self.xyz_min[axis]), float(self.xyz_max[axis])
        return (v - lo) / (hi - lo) * (n - 1.0)

    def query_triplane(self, feats, px, py, pz, aux=None):
        """Plane features at the points, concatenated or summed over the
        three planes. ``aux`` (a dict) collects the anchor-LIIF
        distillation loss of a model with the teacher."""
        outs = []
        for name in PLANES:
            a, b = PLANE_AXES[name]
            plane = feats[name]
            u = self._norm_to_plane((px, py, pz)[a], a, plane.shape[0])
            v = self._norm_to_plane((px, py, pz)[b], b, plane.shape[1])
            if self.liif:
                outs.append(self._liif_plane(name, plane, u, v, aux=aux))
            else:
                outs.append(grid_ops.bilinear_sample_parts(plane, u, v))
        if self.tri_aggregation == "concat":
            return torch.cat(outs, -1)
        return outs[0] + outs[1] + outs[2]

    @staticmethod
    def _unfold_plane_3x3(plane):
        """3x3 zero-padded neighbourhoods, channel-outer: ``out[...,
        c*9 + (di*3 + dj)]`` (``F.unfold(feat, 3, padding=1)``'s order)."""
        nu, nv, c = plane.shape
        padded = torch.nn.functional.pad(plane, (0, 0, 1, 1, 1, 1))
        shifts = [padded[di:di + nu, dj:dj + nv] for di in range(3)
                  for dj in range(3)]
        return torch.stack(shifts, -1).reshape(nu, nv, c * 9)

    def _liif_plane(self, name, plane, u, v, aux=None):
        """LIIF local ensemble on one plane: 4 nearest-cell taps (rounded
        half to even), each decoded from (feature, relative coordinate(,
        cell)), blended by the diagonally opposite tap's area. With the
        anchor-LIIF teacher and ``aux``, each tap adds ``mse(head(pred),
        head(teacher)) / (taps x planes)`` to ``aux['distillation']``."""
        nu, nv = plane.shape[:2]
        if self.feat_unfold:
            plane = self._unfold_plane_3x3(plane)
        interp = getattr(self, f"interp_{name}")
        taps = [(-0.5, -0.5), (-0.5, 0.5), (0.5, -0.5), (0.5, 0.5)] \
            if self.local_ensemble else [(0.0, 0.0)]
        distill = getattr(self, "use_anchor_liif", False) and aux is not None
        n_avg = float(len(taps) * 3)
        preds, areas = [], []
        for du, dv in taps:
            cu = torch.clamp(torch.round(u + du), 0, nu - 1)
            cv = torch.clamp(torch.round(v + dv), 0, nv - 1)
            q_feat = grid_ops.nearest_sample_2d_parts(plane, cu, cv)
            rel_u, rel_v = u - cu, v - cv
            inp = [q_feat, rel_u[..., None], rel_v[..., None]]
            if self.cell_decode:
                inp += [torch.ones_like(rel_u[..., None]),
                        torch.ones_like(rel_v[..., None])]
            inp_cat = torch.cat(inp, -1)
            pred = nets.interp_mlp_apply(interp, inp_cat)
            if distill:
                anchor_pred = nets.interp_mlp_apply(self.anchor_liif,
                                                    inp_cat).detach()
                head = self.distillation_head
                pd = torch.relu(nets._linear(head, pred))
                ad = torch.relu(nets._linear(head, anchor_pred))
                aux["distillation"] = aux.get("distillation", 0.0) \
                    + torch.mean((pd - ad) ** 2) / n_avg
            preds.append(pred)
            areas.append(torch.abs(rel_u * rel_v) + 1e-9)
        if self.local_ensemble:
            areas = [areas[3], areas[2], areas[1], areas[0]]
        tot = sum(areas)
        out = 0.0
        for p, a in zip(preds, areas):
            out = out + p * (a / tot)[..., None]
        return out

    # ------------------------------------------------------------ forward

    def _scene_grids(self, scene_id):
        """(density grid, mask) of the scene (the whole grids of a
        single-scene model)."""
        if scene_id is not None and self.mask.dim() == 4:
            return self.density[scene_id], self.mask[scene_id]
        return self.density, self.mask

    def _cond_samples(self, mask, rays_o, rays_d, near, far, stepsize):
        """The gather samples: (px, py, pz), occupancy, step index, of the
        ``k_density`` first occupied samples of each ray; the alpha
        interval."""
        bbox_min = tuple(float(x) for x in self.xyz_min)
        bbox_max = tuple(float(x) for x in self.xyz_max)
        stepdist = stepsize * self.voxel_size
        interval = stepsize * self.voxel_size_ratio
        n_cap = rm.max_samples_for_bbox(self.xyz_min, self.xyz_max, stepdist)
        (px, py, pz), valid, step_sl = rm.sample_points_dense_parts(
            rays_o, rays_d, bbox_min, bbox_max, near, far, stepdist, n_cap)
        occ = grid_ops.occupancy_lookup_parts(
            mask, px, py, pz, bbox_min, bbox_max) & valid
        step_f = step_sl.to(torch.float32)[None, :].expand(px.shape)
        k_d = self.k_density or n_cap
        if k_d < n_cap:
            key = torch.where(occ, step_f, step_f + float(2 * n_cap))
            _, px, py, pz, occ, step_f = rm.compact_by_key(
                key, k_d, px, py, pz, occ, step_f)
        return (px, py, pz), occ, step_f, interval

    def _composite(self, alpha, occ):
        """(weights gated by ``wmask``, alphainv_last, wmask)."""
        if self.fast_color_thres > 0:
            occ = occ & (alpha > self.fast_color_thres)
        weights, alphainv_last, live = rm.alpha2weight_dense(alpha, occ)
        wmask = (weights > self.fast_color_thres
                 if self.fast_color_thres > 0 else live)
        return (torch.where(wmask, weights, torch.zeros_like(weights)),
                alphainv_last, wmask)

    def _colour(self, k0, viewdirs, shape):
        vd_emb = mlp_lib.positional_encoding(viewdirs, self.viewbase_pe)
        vd_emb = vd_emb[:, None, :].expand(*shape, vd_emb.shape[-1])
        if self.rgbnet_direct:
            return torch.sigmoid(mlp_lib.mlp_apply(
                self.rgbnet, torch.cat([k0, vd_emb], -1)))
        logit = mlp_lib.mlp_apply(self.rgbnet,
                                  torch.cat([k0[..., 3:], vd_emb], -1))
        return torch.sigmoid(logit + k0[..., :3])

    @staticmethod
    def _result(w_eff, alphainv_last, wmask, alpha, rgb, step_f, bg,
                render_depth):
        ret = {
            "alphainv_last": alphainv_last,
            "weights": w_eff,
            "rgb_marched": (torch.sum(w_eff[..., None] * rgb, 1)
                            + alphainv_last[..., None] * bg),
            "raw_alpha": torch.where(wmask, alpha, torch.zeros_like(alpha)),
            "raw_rgb": rgb,
            "wmask": wmask,
        }
        if render_depth:
            ret["depth"] = torch.sum(w_eff * step_f, 1).detach()
        return ret

    def _render_grid(self, colour_of, density_grid, mask, rays_o, rays_d,
                     *, near, far, bg, stepsize, render_depth=False):
        """Render with the density grid and ``colour_of(px, py, pz) ->
        rgb [N, K, 3]`` on the kept samples."""
        bbox_min = tuple(float(x) for x in self.xyz_min)
        bbox_max = tuple(float(x) for x in self.xyz_max)
        (px, py, pz), occ, step_f, interval = self._cond_samples(
            mask, rays_o, rays_d, near, far, stepsize)
        density = grid_ops.trilinear_sample_world(
            density_grid, px, py, pz, bbox_min, bbox_max)
        alpha = rm.raw2alpha(density, self.act_shift, interval)
        w_eff, alphainv_last, wmask = self._composite(alpha, occ)
        k_c = self.k_color or 0
        if k_c and k_c < w_eff.shape[-1]:
            _, w_eff, px, py, pz, step_f, alpha, wmask = rm.compact_by_key(
                -w_eff, k_c, w_eff, px, py, pz, step_f, alpha, wmask)
        rgb = colour_of(px, py, pz)
        return self._result(w_eff, alphainv_last, wmask, alpha, rgb, step_f,
                            bg, render_depth)

    def render(self, feats, rays_o, rays_d, viewdirs, global_step=None, *,
               near, far, bg, stepsize, render_depth=False, scene_id=None,
               **_):
        """Volume render with triplane colour against encoded ``feats``
        (``scene_id``: the scene of a multi-scene model)."""
        density_grid, mask = self._scene_grids(scene_id)
        aux = {}

        def colour_of(px, py, pz):
            k0 = self.query_triplane(feats, px, py, pz, aux=aux)
            return self._colour(k0, viewdirs, px.shape)

        ret = self._render_grid(colour_of, density_grid, mask, rays_o,
                                rays_d, near=near, far=far, bg=bg,
                                stepsize=stepsize, render_depth=render_depth)
        if "distillation" in aux:
            ret["distillation"] = aux["distillation"]
        return ret

    def forward(self, rgb_lr, pose_lr, rays_o, rays_d, viewdirs,
                global_step=None, **render_kwargs):
        feats = self.encode_feat(rgb_lr, pose_lr)
        return self.render(feats, rays_o, rays_d, viewdirs, global_step,
                           **render_kwargs)
