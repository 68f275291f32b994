"""Conditioned multi-scene triplane model: TriDVGO with

* per-scene density grids ``[n_scene, X, Y, Z]`` and masks;
* a choice of plane-mapping operators: the MLP ``Mapping`` or the
  convolutional ``ConvMapping`` (pose input ``anchor @ inv(pose)``), a
  closed-form affine warp of the feature maps by the pose's submatrix
  (``closed_map``), non-local attention against the scene's accumulated
  alpha maps (``use_nl``), or a 1x1 projection;
* auxiliary losses from ``encode_feat``: cross-view feature consistency
  and the plane-decorrelation cosine losses (v1, v2, inverse MSE);
* an anchor-LIIF teacher (a frozen decoder, pretrained weights from a local
  file) with a trained distillation head.

``forward`` returns ``(ret, consistency, cosine, distillation)``. The 3
views x 3 planes give 9 mapped maps; plane i takes view i's.
"""

from __future__ import annotations

import os

import numpy as np
import torch
from torch import nn

from ..ops import grid as grid_ops
from . import backbone, nets, prng
from .dvgo_multiscene import pooled_alpha
from .mlp import init_linear
from .tri_dvgo import PLANE_AXES, PLANES, TriDVGO, _planes_last


def affine_warp(feat, theta):
    """``F.affine_grid`` + ``grid_sample`` (align_corners=True, border
    clamp) of a ``[H, W, C]`` map by ``theta [2, 3]`` (normalized output
    (u, v, 1) -> normalized source coordinates), through the bilinear plane
    sampler."""
    h, w, _ = feat.shape
    vs = torch.as_tensor(np.linspace(-1.0, 1.0, h), dtype=torch.float32,
                         device=feat.device)
    us = torch.as_tensor(np.linspace(-1.0, 1.0, w), dtype=torch.float32,
                         device=feat.device)
    v_grid, u_grid = torch.meshgrid(vs, us, indexing="ij")
    src_u = theta[0, 0] * u_grid + theta[0, 1] * v_grid + theta[0, 2]
    src_v = theta[1, 0] * u_grid + theta[1, 1] * v_grid + theta[1, 2]
    iu = (src_v + 1.0) / 2.0 * (h - 1)
    iv = (src_u + 1.0) / 2.0 * (w - 1)
    return grid_ops.bilinear_sample_parts(feat, iu, iv)


def _cos_abs_sum(a, b):
    num = torch.sum(a * b, -1)
    den = (torch.linalg.vector_norm(a, dim=-1)
           * torch.linalg.vector_norm(b, dim=-1) + 1e-8)
    return torch.sum(torch.abs(num / den))


class TriDVGOMultiScene(TriDVGO):
    def __init__(self, xyz_min, xyz_max, n_scene=1,
                 mlp_map=True, conv_map=False, closed_map=False,
                 use_nl=False,
                 compute_consistency=False, compute_cosine=False,
                 cosine_v1=False, cosine_v2=True,
                 use_anchor_liif=False, load_liif_sd=False,
                 liif_state_dict="", device=None, **kwargs):
        super().__init__(xyz_min, xyz_max, device=device, **kwargs)
        self.n_scene = int(n_scene)
        dev = self.density.device
        ws = tuple(self.world_size)
        self.density = nn.Parameter(torch.zeros((self.n_scene, *ws),
                                                device=dev))
        self.mask = torch.ones((self.n_scene, *ws), dtype=torch.bool,
                               device=dev)
        self.mlp_map = mlp_map
        self.conv_map = conv_map
        self.closed_map = closed_map
        self.use_nl = use_nl
        self.compute_consistency = compute_consistency
        self.compute_cosine = compute_cosine
        self.cosine_v1 = cosine_v1
        self.cosine_v2 = cosine_v2
        self.use_anchor_liif = bool(use_anchor_liif)
        self.rgbnet_kwargs.update({
            "n_scene": self.n_scene, "mlp_map": mlp_map,
            "conv_map": conv_map, "closed_map": closed_map,
            "use_nl": use_nl, "compute_consistency": compute_consistency,
            "compute_cosine": compute_cosine, "cosine_v1": cosine_v1,
            "cosine_v2": cosine_v2,
            "use_anchor_liif": self.use_anchor_liif,
            "load_liif_sd": bool(load_liif_sd),
            "liif_state_dict": liif_state_dict,
        })
        # the JAX model's keys: ``seed + 11``, whole for the mapping and
        # the NL block, folded with 1, 2 and 3 for the rest
        key = prng.prng_key(kwargs.get("seed", 0) + 11)
        n_feats = self.encoder_kwargs["n_feats"]
        if conv_map:
            self.map = nets.ConvMapping(n_feats + 16, self.rgbnet_dim,
                                        key=key, device=dev)
        if use_nl:
            self.nl_block = nets.NLBlock(n_feats, 1, key=key, device=dev)
        if not (conv_map or mlp_map) and n_feats != self.rgbnet_dim:
            # the closed-form, NL and identity modes emit n_feats channels
            self.plane_proj = init_linear(n_feats, self.rgbnet_dim,
                                          key=prng.fold_in(key, 1),
                                          device=dev)

        if (self.use_anchor_liif or load_liif_sd) and not self.liif:
            raise ValueError("use_anchor_liif/load_liif_sd require liif=True "
                             "(the teacher distills the LIIF decoders)")
        liif_layers = None
        if (self.use_anchor_liif or load_liif_sd) and liif_state_dict:
            if not os.path.isfile(liif_state_dict):
                raise FileNotFoundError(
                    f"liif_state_dict not found: {liif_state_dict!r} "
                    "(use_anchor_liif/load_liif_sd need the pretrained LIIF "
                    "checkpoint)")
            liif_layers = nets.load_liif_state_dict(liif_state_dict)
            if load_liif_sd:
                for nm in ("interp_xy", "interp_yz", "interp_zx"):
                    nets.apply_liif_sd_to_interp(getattr(self, nm),
                                                 liif_layers)
        if self.use_anchor_liif:
            first = self.interp_xy.layers[0]
            self.anchor_liif = nets.InterpMLP(
                first.in_features, self.rgbnet_dim, first.out_features,
                len(self.interp_xy.layers), key=prng.fold_in(key, 2),
                device=dev)
            if liif_layers is not None:
                nets.apply_liif_sd_to_interp(self.anchor_liif, liif_layers)
            self.distillation_head = init_linear(
                self.rgbnet_dim, self.rgbnet_dim, key=prng.fold_in(key, 3),
                device=dev)

    def jax_groups(self):
        groups = super().jax_groups()
        for n in ("nl_block", "plane_proj", "anchor_liif",
                  "distillation_head"):
            if hasattr(self, n):
                groups[n] = getattr(self, n)
        return groups

    def get_kwargs(self):
        kw = super().get_kwargs()
        kw.update(self.rgbnet_kwargs)
        return kw

    # ------------------------------------------------------- state surgery

    @torch.no_grad()
    def scale_volume_grid(self, num_voxels):
        """Every scene's density grid resized; the mask from the new
        density, as the joint coarse model's rescale."""
        ori = self.world_size
        self._set_grid_resolution(num_voxels)
        print("tri_dvgo_ms: scale_volume_grid from", ori, "to",
              self.world_size)
        ws = tuple(self.world_size)
        self.density = nn.Parameter(torch.stack([
            grid_ops.resize_trilinear(d, ws) for d in self.density.data]))
        self.mask = pooled_alpha(self) > self.fast_color_thres

    @torch.no_grad()
    def update_occupancy_cache(self):
        self.mask.logical_and_(pooled_alpha(self) > self.fast_color_thres)

    def hit_coarse_geo(self, rays_o, rays_d, scene_id=0, **kw):
        """The scene's occupancy test of each ray."""
        return super().hit_coarse_geo(rays_o, rays_d,
                                      mask=self.mask[scene_id], **kw)

    # --------------------------------------------------------- conditioning

    @staticmethod
    def _plane_theta(pose, plane_idx):
        """The pose's submatrix selecting the plane's two axes, translation
        column zeroed."""
        rows = [(0, 1), (1, 2), (2, 0)][plane_idx]
        cols = [(0, 1), (1, 2), (2, 0)][plane_idx]
        theta = pose[list(rows)][:, list(cols)]
        return torch.cat([theta, torch.zeros_like(theta[:, :1])], 1)

    def encode_feat(self, rgb_lr, pose_lr, scene_id=0):
        """3 views ``[3, 9, H, W]`` with poses ``[3, 4, 4]`` -> (planes
        ``{'xy', 'yz', 'zx'}`` ``[h, w, C]``, consistency, cosine)."""
        feats3 = backbone.edsr_apply(self.encoder, rgb_lr)
        anchors = self.anchors_on(rgb_lr.device)
        mapped = [[None] * 3 for _ in range(3)]       # plane i, view j
        for i in range(3):
            for j in range(3):
                fmap = feats3[j:j + 1]
                if self.closed_map:
                    fmap = _planes_last(fmap[0])
                    fmap = affine_warp(fmap, self._plane_theta(pose_lr[j],
                                                               i))
                    fmap = fmap.permute(2, 0, 1)[None]
                if self.use_nl:
                    alpha_map = self._accumulated_alpha_map(
                        scene_id, i, fmap.shape[-2:])
                    fmap = nets.nl_block_apply(self.nl_block, fmap,
                                               alpha_map[None, None])
                if self.conv_map or self.mlp_map:
                    cond = anchors[i] @ torch.linalg.inv(pose_lr[j])
                    apply = (nets.conv_mapping_apply if self.conv_map
                             else nets.mapping_apply)
                    fmap = _planes_last(apply(self.map, fmap,
                                              cond[None])[0])
                elif hasattr(self, "plane_proj"):
                    fmap = nets._linear(self.plane_proj,
                                        _planes_last(fmap[0]))
                else:
                    fmap = _planes_last(fmap[0])
                mapped[i][j] = fmap

        consistency = 0.0
        if self.compute_consistency:
            for i in range(3):
                for a in range(3):
                    for b in range(3):
                        consistency = consistency + (1.0 / 27.0) * torch.mean(
                            (mapped[i][a].detach() - mapped[i][b]) ** 2)

        feats = {"xy": mapped[0][0], "yz": mapped[1][1], "zx": mapped[2][2]}
        cosine = 0.0
        if self.compute_cosine:
            h, w = feats["xy"].shape[:2]
            pairs = [("xy", "yz"), ("yz", "zx"), ("zx", "xy")]
            if self.cosine_v1:
                for k in range(3):
                    for i in range(3):
                        sim = 0
                        for j in range(3):
                            if j != i:
                                sim = sim + 0.5 * _cos_abs_sum(
                                    mapped[i][k].detach(), mapped[j][k])
                        cosine = cosine + sim / 3.0
                cosine = cosine / h / w
            elif self.cosine_v2:
                for a, b in pairs:
                    cosine = cosine + (1.0 / 3.0) * _cos_abs_sum(
                        feats[a].detach(), feats[b])
                cosine = cosine / h / w
            else:
                for a, b in pairs:
                    mse = torch.mean((feats[a].detach() - feats[b]) ** 2)
                    cosine = cosine + (1.0 / 3.0) / (mse + 1e-8)
        return feats, consistency, cosine

    def _accumulated_alpha_map(self, scene_id, plane_idx, hw):
        """The scene's alpha grid resized so that the plane's two axes
        match the map, summed along the third axis (the last slice of the
        cumulative sum), rows and columns in the plane's axis order."""
        alpha = self.activate_density(self.density[scene_id])
        a, b = PLANE_AXES[PLANES[plane_idx]]
        c = 3 - a - b
        new_size = [0, 0, 0]
        new_size[a], new_size[b] = int(hw[0]), int(hw[1])
        new_size[c] = alpha.shape[c]
        resized = grid_ops.resize_trilinear(alpha, tuple(new_size))
        out = torch.cumsum(resized, c).select(c, -1)
        return out.t() if a > b else out

    # ------------------------------------------------------------ forward

    def forward(self, rgb_lr, pose_lr, rays_o, rays_d, viewdirs, scene_id=0,
                global_step=None, teacher_apply=None, **render_kwargs):
        feats, consistency, cosine = self.encode_feat(rgb_lr, pose_lr,
                                                      scene_id)
        ret = self.render(feats, rays_o, rays_d, viewdirs, global_step,
                          scene_id=scene_id, **render_kwargs)
        distillation = ret.pop("distillation", 0.0)
        if teacher_apply is not None:
            teacher = teacher_apply(rgb_lr, pose_lr)
            for name in PLANES:
                distillation = distillation + (1.0 / 3.0) * torch.mean(
                    (feats[name] - teacher[name].detach()) ** 2)
        return ret, consistency, cosine, distillation
