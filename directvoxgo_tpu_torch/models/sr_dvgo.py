"""Super-resolution DVGO: a learned density grid + colour features from one
low-resolution conditioning view.

The LR image (``[1, n_colors, H, W]``, NCHW) passes through an EDSR
encoder; the feature map, cropped to ``rgbnet_dim`` channels, is sampled at
the (x, y) world coordinates of each point (the implicit form of the
reference's feature map repeated along z) and decoded by the colour MLP.
The geometry is the triplane model's (:class:`.tri_dvgo.TriDVGO`).
"""

from __future__ import annotations

import torch

from ..ops import grid as grid_ops
from . import backbone
from . import mlp as mlp_lib
from .dvgo import DirectVoxGO
from .tri_dvgo import TriDVGO


class SRDVGO(TriDVGO):
    """Density grid + LR-image-conditioned colour."""

    def __init__(self, xyz_min, xyz_max,
                 num_voxels=0, num_voxels_base=0, alpha_init=None,
                 mask_cache_path=None, mask_cache_thres=1e-3,
                 fast_color_thres=0,
                 rgbnet_dim=6, rgbnet_direct=False, rgbnet_depth=3,
                 rgbnet_width=128, viewbase_pe=4,
                 n_feats=64, n_resblocks=16, res_scale=1, n_colors=3,
                 k_density=None, k_color=64, seed=0, device=None,
                 generator=None, **kwargs):
        DirectVoxGO.__init__(
            self, xyz_min, xyz_max, num_voxels=num_voxels,
            num_voxels_base=num_voxels_base, alpha_init=alpha_init,
            mask_cache_path=mask_cache_path,
            mask_cache_thres=mask_cache_thres,
            fast_color_thres=fast_color_thres, rgbnet_dim=0,
            k_density=k_density, k_color=k_color, seed=seed, device=device)
        self.k0 = None
        dev = self.density.device
        gen = generator if generator is not None \
            else torch.Generator().manual_seed(int(seed))
        self.liif = False
        self.rgbnet_dim = rgbnet_dim
        self.rgbnet_direct = rgbnet_direct
        self.viewbase_pe = viewbase_pe
        self.k0_dim = rgbnet_dim
        self.encoder_kwargs = dict(n_feats=n_feats, n_resblocks=n_resblocks,
                                   res_scale=res_scale, n_colors=n_colors)
        self.rgbnet_kwargs = {
            "rgbnet_dim": rgbnet_dim, "rgbnet_direct": rgbnet_direct,
            "rgbnet_depth": rgbnet_depth, "rgbnet_width": rgbnet_width,
            "viewbase_pe": viewbase_pe, **self.encoder_kwargs,
        }
        self.encoder, _ = backbone.make_edsr_baseline(
            n_resblocks=n_resblocks, n_feats=n_feats, res_scale=res_scale,
            no_upsampling=True, n_colors=n_colors, generator=gen,
            device=dev)
        dim0 = 3 + 3 * viewbase_pe * 2
        dim0 += rgbnet_dim if rgbnet_direct else rgbnet_dim - 3
        self.rgbnet = mlp_lib.MLP(dim0, rgbnet_width, rgbnet_depth, 3,
                                  generator=gen, device=dev)
        self.has_rgbnet = True

    def jax_groups(self):
        return {n: getattr(self, n) for n in ("density", "encoder",
                                              "rgbnet")}

    def encode_feat(self, rgb_lr):
        """LR view ``[1, C, H, W]`` -> feature plane ``[H, W,
        rgbnet_dim]``."""
        feats = backbone.edsr_apply(self.encoder, rgb_lr)
        return feats[0, :self.rgbnet_dim].permute(1, 2, 0)

    def render(self, plane, rays_o, rays_d, viewdirs, global_step=None, *,
               near, far, bg, stepsize, render_depth=False, **_):
        """Render against an encoded LR feature plane."""
        mn = tuple(float(x) for x in self.xyz_min)
        mx = tuple(float(x) for x in self.xyz_max)

        def colour_of(px, py, pz):
            u = (px - mn[0]) / (mx[0] - mn[0]) * (plane.shape[0] - 1)
            v = (py - mn[1]) / (mx[1] - mn[1]) * (plane.shape[1] - 1)
            k0 = grid_ops.bilinear_sample_parts(plane, u, v)
            return self._colour(k0, viewdirs, px.shape)

        return self._render_grid(colour_of, self.density, self.mask, rays_o,
                                 rays_d, near=near, far=far, bg=bg,
                                 stepsize=stepsize, render_depth=render_depth)

    def forward(self, rgb_lr, rays_o, rays_d, viewdirs, global_step=None,
                **render_kwargs):
        plane = self.encode_feat(rgb_lr)
        return self.render(plane, rays_o, rays_d, viewdirs, global_step,
                           **render_kwargs)
