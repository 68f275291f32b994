"""Fully implicit image-conditioned model: triplane features and a
skip-connected NeRF MLP that predicts colour and density, with no density
grid. Density activates as mip-NeRF's, ``softplus(d - 1)``, then ``alpha =
-expm1(-sigma * interval)``. The occupancy mask of a coarse checkpoint (when
given) still skips free space.

With no density grid the model has no progressive scaling and no occupancy
renewal; the JAX package's model inherits both and raises on the grid it
does not have, and its NeRF MLP's ``skips`` are an integer leaf of the
trained pytree, so ``jax.value_and_grad`` refuses its train step (ROADMAP,
known JAX faults). Here ``skips`` is a module setting.
"""

from __future__ import annotations

import torch

from ..ops import raymarch as rm
from . import mlp as mlp_lib
from . import nets
from .tri_dvgo import TriDVGO


def density2alpha(density, interval):
    """``alpha = 1 - exp(-density * interval)``, in ``expm1`` form."""
    return -torch.expm1(-density * interval)


class MultiSceneImplicitDVGO(TriDVGO):
    """Triplane-conditioned NeRF-MLP radiance field (no density grid)."""

    def __init__(self, xyz_min, xyz_max, use_mipnerf_density=True,
                 rgbnet_depth=8, rgbnet_width=256, skips=(2,), device=None,
                 generator=None, **kwargs):
        kwargs.setdefault("alpha_init", 1e-2)
        gen = generator if generator is not None \
            else torch.Generator().manual_seed(int(kwargs.get("seed", 0)))
        super().__init__(xyz_min, xyz_max, device=device, generator=gen,
                         **kwargs)
        dev = self.density.device
        self.density = None
        self.use_mipnerf_density = use_mipnerf_density
        if use_mipnerf_density:
            self.act_shift = -1.0
        self.skips = tuple(int(s) for s in skips)
        self.rgbnet_depth = rgbnet_depth
        self.rgbnet_width = rgbnet_width
        self.rgbnet_kwargs.update({
            "rgbnet_depth": rgbnet_depth, "rgbnet_width": rgbnet_width,
            "skips": self.skips,
            "use_mipnerf_density": use_mipnerf_density,
        })
        self.rgbnet = nets.NerfMLP(
            D=rgbnet_depth, W=rgbnet_width, input_ch=self.k0_dim,
            input_ch_views=3 + 3 * self.viewbase_pe * 2, skips=self.skips,
            generator=gen, device=dev)

    @property
    def device(self):
        return self.mask.device

    def jax_groups(self):
        groups = super().jax_groups()
        del groups["density"]
        return groups

    def get_kwargs(self):
        kw = super().get_kwargs()
        kw.update(self.rgbnet_kwargs)
        return kw

    def update_occupancy_cache(self):
        """No density grid: the mask stays the coarse checkpoint's."""

    def render(self, feats, rays_o, rays_d, viewdirs, global_step=None, *,
               near, far, bg, stepsize, render_depth=False, **_):
        (px, py, pz), occ, step_f, interval = self._cond_samples(
            self.mask, rays_o, rays_d, near, far, stepsize)
        vox_emb = self.query_triplane(feats, px, py, pz)
        vd_emb = mlp_lib.positional_encoding(viewdirs, self.viewbase_pe)
        vd_emb = vd_emb[:, None, :].expand(*px.shape, vd_emb.shape[-1])
        rgb_logit, density = nets.nerf_mlp_apply(self.rgbnet, vox_emb,
                                                 vd_emb)
        rgb = torch.sigmoid(rgb_logit)
        density = density[..., 0]
        if self.use_mipnerf_density:
            x = density + self.act_shift
            alpha = density2alpha(torch.logaddexp(x, torch.zeros_like(x)),
                                  interval)
        else:
            alpha = rm.raw2alpha(density, self.act_shift, interval)
        w_eff, alphainv_last, wmask = self._composite(alpha, occ)
        return self._result(w_eff, alphainv_last, wmask, alpha, rgb, step_f,
                            bg, render_depth)
