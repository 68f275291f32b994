"""Joint multi-scene DirectVoxGO: per-scene grids with a leading scene axis,
a shared colour net.

``density`` is ``[n_scene, X, Y, Z]``; in the coarse configuration (no
colour MLP) ``k0`` is per scene ``[n_scene, X, Y, Z, 3]``, in the fine one
the feature grid and the MLP are shared. The occupancy mask is
scene-indexed, and ``forward`` takes a ``scene_id``: it renders the
scene's grids through DirectVoxGO's gather forward.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..ops import grid as grid_ops
from ..ops import raymarch as rm
from .dvgo import DirectVoxGO


def pooled_alpha(model):
    """``[n_scene, X, Y, Z]`` alpha of each scene's max-pooled density."""
    return torch.stack([
        rm.raw2alpha(grid_ops.max_pool3d_same(d), model.act_shift,
                     model.voxel_size_ratio) for d in model.density])


class DirectVoxGOMultiScene(DirectVoxGO):
    def __init__(self, xyz_min, xyz_max, n_scene=1, device=None,
                 generator=None, **kwargs):
        n = int(n_scene)
        mask_cache_path = kwargs.pop("mask_cache_path", None)
        super().__init__(xyz_min, xyz_max, device=device, generator=generator,
                         **kwargs)
        self.n_scene = n
        dev = self.density.device
        ws = tuple(self.world_size)
        self.density = nn.Parameter(torch.zeros((self.n_scene, *ws),
                                                device=dev))
        self.k0_per_scene = not self.has_rgbnet
        if self.k0_per_scene:
            self.k0 = nn.Parameter(torch.zeros(
                (self.n_scene, *ws, self.k0_dim), device=dev))
        self.mask_cache_path = mask_cache_path
        if mask_cache_path:
            self.mask = self._multiscene_mask_from_coarse_ckpt(
                mask_cache_path, kwargs.get("mask_cache_thres", 1e-3))
        else:
            self.mask = torch.ones((self.n_scene, *ws), dtype=torch.bool,
                                   device=dev)

    def _multiscene_mask_from_coarse_ckpt(self, path, thres):
        """Each scene's coarse occupancy (``alpha(maxpool(density)) >=
        thres``) looked up at this grid's points."""
        from ..engine import checkpoint as ckpt_lib
        st = ckpt_lib.load_checkpoint_file(path)
        c_kwargs = st["model_kwargs"]
        c_density = torch.as_tensor(st["model_state_dict"]["density"],
                                    device=self.device)
        assert c_density.dim() == 4, "expected [n_scene, X, Y, Z] density"
        pts = self.grid_points()
        masks = []
        for s in range(self.n_scene):
            alpha = rm.raw2alpha(grid_ops.max_pool3d_same(c_density[s]),
                                 c_kwargs["act_shift"],
                                 c_kwargs["voxel_size_ratio"])
            masks.append(grid_ops.occupancy_lookup(
                alpha >= thres, pts, c_kwargs["xyz_min"],
                c_kwargs["xyz_max"]))
        return torch.stack(masks, 0)

    def get_kwargs(self):
        kw = super().get_kwargs()
        kw["n_scene"] = self.n_scene
        return kw

    # ------------------------------------------------------- state surgery

    @torch.no_grad()
    def maskout_near_cam_vox(self, cam_o, near, scene_id=None):
        """Density -100 for the scene's voxels within ``near`` of any of its
        cameras."""
        if scene_id is None:
            raise ValueError("multiscene maskout needs a scene_id")
        pts = self.grid_points()
        d2 = None
        for cam in torch.as_tensor(np.asarray(cam_o, np.float32),
                                   device=self.device):
            d2_c = torch.sum((pts - cam) ** 2, -1)
            d2 = d2_c if d2 is None else torch.minimum(d2, d2_c)
        self.density[scene_id].masked_fill_(torch.sqrt(d2) <= near, -100.0)

    @torch.no_grad()
    def scale_volume_grid(self, num_voxels):
        """Every scene's grids resized; the mask from the new density."""
        ori = self.world_size
        self._set_grid_resolution(num_voxels)
        print("dvgo_ms: scale from", ori, "to", self.world_size)
        ws = tuple(self.world_size)
        self.density = nn.Parameter(torch.stack([
            grid_ops.resize_trilinear(d, ws) for d in self.density.data]))
        if self.k0_dim > 0:
            k0 = self.k0.data
            self.k0 = nn.Parameter(
                torch.stack([grid_ops.resize_trilinear(k, ws) for k in k0])
                if self.k0_per_scene
                else grid_ops.resize_trilinear(k0, ws).contiguous())
        self.mask = pooled_alpha(self) > self.fast_color_thres

    @torch.no_grad()
    def update_occupancy_cache(self, scene_id=None):
        new = self.mask & (pooled_alpha(self) > self.fast_color_thres)
        if scene_id is None:
            self.mask.copy_(new)
        else:
            self.mask[scene_id] = new[scene_id]

    # ------------------------------------------------------------ forward

    def forward(self, rays_o, rays_d, viewdirs, scene_id=0, global_step=None,
                **render_kwargs):
        k0 = self.k0[scene_id] if self.k0_per_scene else self.k0
        return self._render_rays(self.density[scene_id], k0, self.rgbnet,
                                 self.mask[scene_id], rays_o, rays_d,
                                 viewdirs, **render_kwargs)

    def hit_coarse_geo(self, rays_o, rays_d, scene_id=0, **kw):
        """The scene's occupancy test of each ray."""
        return super().hit_coarse_geo(rays_o, rays_d,
                                      mask=self.mask[scene_id], **kw)
