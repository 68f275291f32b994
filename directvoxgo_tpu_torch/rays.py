"""Camera-to-ray generation (numpy, host-side; reference lib/ray_utils.py)."""

from __future__ import annotations

import numpy as np


def get_rays(H, W, K, c2w, inverse_y, flip_x, flip_y, mode="center"):
    """Pixel grid -> world-space ray origins and directions, [H, W, 3] each.

    ``inverse_y`` selects the intrinsics convention; ``mode`` is
    ``"center"`` (pixel centers), ``"lefttop"`` or ``"random"`` (jitter).
    """
    c2w = np.asarray(c2w, dtype=np.float32)
    K = np.asarray(K, dtype=np.float32)
    j, i = np.meshgrid(np.arange(H, dtype=np.float32),
                       np.arange(W, dtype=np.float32), indexing="ij")
    if mode == "lefttop":
        pass
    elif mode == "center":
        i, j = i + 0.5, j + 0.5
    elif mode == "random":
        i = i + np.random.rand(*i.shape).astype(np.float32)
        j = j + np.random.rand(*j.shape).astype(np.float32)
    else:
        raise NotImplementedError(mode)
    if flip_x:
        i = i[:, ::-1]
    if flip_y:
        j = j[::-1, :]
    if inverse_y:
        dirs = np.stack(
            [(i - K[0][2]) / K[0][0], (j - K[1][2]) / K[1][1], np.ones_like(i)], -1)
    else:
        dirs = np.stack(
            [(i - K[0][2]) / K[0][0], -(j - K[1][2]) / K[1][1], -np.ones_like(i)], -1)
    rays_d = dirs @ c2w[:3, :3].T
    rays_o = np.broadcast_to(c2w[:3, 3], rays_d.shape).copy()
    return rays_o, rays_d


def ndc_rays(H, W, focal, near, rays_o, rays_d):
    """Project rays into NDC space (forward-facing scenes)."""
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d

    o0 = -1.0 / (W / (2.0 * focal)) * rays_o[..., 0] / rays_o[..., 2]
    o1 = -1.0 / (H / (2.0 * focal)) * rays_o[..., 1] / rays_o[..., 2]
    o2 = 1.0 + 2.0 * near / rays_o[..., 2]
    d0 = -1.0 / (W / (2.0 * focal)) * (
        rays_d[..., 0] / rays_d[..., 2] - rays_o[..., 0] / rays_o[..., 2])
    d1 = -1.0 / (H / (2.0 * focal)) * (
        rays_d[..., 1] / rays_d[..., 2] - rays_o[..., 1] / rays_o[..., 2])
    d2 = -2.0 * near / rays_o[..., 2]
    return np.stack([o0, o1, o2], -1), np.stack([d0, d1, d2], -1)


def get_rays_of_a_view(H, W, K, c2w, ndc, inverse_y, flip_x, flip_y,
                       mode="center"):
    """(rays_o, rays_d, viewdirs) of one view, f32 [H, W, 3] each."""
    rays_o, rays_d = get_rays(H, W, K, c2w, inverse_y=inverse_y,
                              flip_x=flip_x, flip_y=flip_y, mode=mode)
    viewdirs = rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)
    if ndc:
        rays_o, rays_d = ndc_rays(H, W, K[0][0], 1.0, rays_o, rays_d)
    return (rays_o.astype(np.float32), rays_d.astype(np.float32),
            viewdirs.astype(np.float32))
