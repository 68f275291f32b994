"""Camera-to-ray generation and the training ray pools (numpy, host-side)."""

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


def get_training_rays(rgb_tr, train_poses, HW, Ks, ndc, inverse_y,
                      flip_x, flip_y):
    """Per-image ray arrays [n_img, H, W, 3] (all images one size)."""
    assert len(np.unique(HW, axis=0)) == 1
    assert len(np.unique(np.asarray(Ks).reshape(len(Ks), -1), axis=0)) == 1
    H, W = HW[0]
    K = Ks[0]
    n = len(rgb_tr)
    rays_o_tr = np.zeros([n, H, W, 3], np.float32)
    rays_d_tr = np.zeros([n, H, W, 3], np.float32)
    viewdirs_tr = np.zeros([n, H, W, 3], np.float32)
    for i, c2w in enumerate(train_poses):
        rays_o_tr[i], rays_d_tr[i], viewdirs_tr[i] = get_rays_of_a_view(
            H, W, K, c2w, ndc, inverse_y, flip_x, flip_y)
    imsz = [1] * n
    return rgb_tr, rays_o_tr, rays_d_tr, viewdirs_tr, imsz


def get_training_rays_flatten(rgb_tr_ori, train_poses, HW, Ks, ndc, inverse_y,
                              flip_x, flip_y):
    """Every image's rays concatenated into flat [N, 3] pools (image sizes
    may differ)."""
    chunks_rgb, chunks_o, chunks_d, chunks_v, imsz = [], [], [], [], []
    for c2w, img, (H, W), K in zip(train_poses, rgb_tr_ori, HW, Ks):
        assert img.shape[:2] == (H, W)
        rays_o, rays_d, viewdirs = get_rays_of_a_view(
            H, W, K, c2w, ndc, inverse_y, flip_x, flip_y)
        chunks_rgb.append(np.asarray(img, np.float32).reshape(-1, 3))
        chunks_o.append(rays_o.reshape(-1, 3))
        chunks_d.append(rays_d.reshape(-1, 3))
        chunks_v.append(viewdirs.reshape(-1, 3))
        imsz.append(H * W)
    return (np.concatenate(chunks_rgb), np.concatenate(chunks_o),
            np.concatenate(chunks_d), np.concatenate(chunks_v), imsz)


def get_training_rays_in_maskcache_sampling(rgb_tr_ori, train_poses, HW, Ks,
                                            ndc, inverse_y, flip_x, flip_y,
                                            model, render_kwargs):
    """Training rays pre-filtered to those that hit the coarse geometry:
    per image, ``model.hit_coarse_geo_view`` (rays generated on the device)
    or, for NDC cameras, ``model.hit_coarse_geo`` on the host rays; the
    dynamic-length compaction happens here on the host."""
    device_view = not ndc
    rk = {k: v for k, v in render_kwargs.items()
          if k not in ("inverse_y", "flip_x", "flip_y")}
    chunks_rgb, chunks_o, chunks_d, chunks_v, imsz = [], [], [], [], []
    total = kept = 0
    for c2w, img, (H, W), K in zip(train_poses, rgb_tr_ori, HW, Ks):
        assert img.shape[:2] == (H, W)
        rays_o, rays_d, viewdirs = get_rays_of_a_view(
            H, W, K, c2w, ndc, inverse_y, flip_x, flip_y)
        if device_view:
            hit = model.hit_coarse_geo_view(
                H, W, K, c2w, inverse_y=inverse_y, flip_x=flip_x,
                flip_y=flip_y, **rk).cpu().numpy()
        else:
            hit = model.hit_coarse_geo(rays_o=rays_o.reshape(-1, 3),
                                       rays_d=rays_d.reshape(-1, 3), **rk)
        mask = np.asarray(hit, bool).reshape(H, W)
        n = int(mask.sum())
        chunks_rgb.append(np.asarray(img, np.float32)[mask])
        chunks_o.append(rays_o[mask])
        chunks_d.append(rays_d[mask])
        chunks_v.append(viewdirs[mask])
        imsz.append(n)
        total += H * W
        kept += n
    print("get_training_rays_in_maskcache_sampling: ratio",
          kept / max(total, 1))
    return (np.concatenate(chunks_rgb), np.concatenate(chunks_o),
            np.concatenate(chunks_d), np.concatenate(chunks_v), imsz)


def batch_indices_generator(N, BS, rng=None):
    """Infinite shuffled index batches: a fresh permutation whenever fewer
    than ``BS`` indices remain."""
    rng = rng or np.random
    idx, top = rng.permutation(N), 0
    while True:
        if top + BS > N:
            idx, top = rng.permutation(N), 0
        yield idx[top:top + BS]
        top += BS
