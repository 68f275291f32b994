"""Procedural synthetic scene fixtures (no external dataset needed): the
inward-facing blob scene and its forward-facing (NDC) variant.

Same scenes, poses and cache keys as the JAX package's fixtures. The ground
truth images are read from ``fixture_<key>.npz`` (an f16 ``images`` stack)
in the ``cache_dir`` given, else in the repository's ``fixture_cache/``.
A key found in neither is rendered from the analytic teacher volume
(:func:`render_teacher_view`: trilinear samples, softplus alpha, front to
back compositing) on the device given, and written to ``cache_dir`` when
one is given; the repository's cache is never written.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import rays as ray_lib
from ..ops.raymarch import fma
from .load_blender import pose_spherical

REPO_CACHE = os.path.normpath(os.path.join(
    os.path.dirname(__file__), os.pardir, os.pardir, "fixture_cache"))


def cache_load(name, cache_dir=None):
    """The cached GT stack ``name`` as f32 images, from ``cache_dir`` or
    the repository's cache; None when neither has it."""
    for d in (cache_dir, REPO_CACHE):
        path = os.path.join(d, name) if d else None
        if path and os.path.isfile(path):
            with np.load(path) as z:
                return z["images"].astype(np.float32)
    return None


def cache_save(name, cache_dir, images):
    """Write the GT stack as the JAX package does (f16 ``images``,
    compressed) to ``cache_dir``."""
    os.makedirs(cache_dir, exist_ok=True)
    np.savez_compressed(os.path.join(cache_dir, name),
                        images=images.astype(np.float16))


def _teacher_chunk(fields, ro, vd, t, box_min, box_max, interval, bg):
    """Trilinear samples of the teacher ``fields [R, R, R, 4]`` (density,
    rgb) along ``ro + vd * t`` and their composite over ``bg``; rays
    ``[n, 3]``, ``t [S]`` -> ``[n, 3]``. The points and the corner sums are
    fused multiply-adds, as the JAX package's CPU compiler contracts them."""
    res = fields.shape[0]
    pts = fma(vd[:, None, :], t[None, :, None], ro[:, None, :])
    scale = (res - 1) / (box_max - box_min)
    idx = (pts - box_min) * scale
    inb = ((pts >= box_min) & (pts <= box_max)).all(-1)
    i0 = torch.clamp(torch.floor(idx).to(torch.int64), 0, res - 2)
    f = torch.clamp(idx - i0, 0.0, 1.0)
    v = torch.zeros((*pts.shape[:2], 4), dtype=torch.float32,
                    device=pts.device)
    for dx in (0, 1):
        wx = f[..., 0] if dx else 1.0 - f[..., 0]
        for dy in (0, 1):
            wy = f[..., 1] if dy else 1.0 - f[..., 1]
            for dz in (0, 1):
                wz = f[..., 2] if dz else 1.0 - f[..., 2]
                corner = fields[i0[..., 0] + dx, i0[..., 1] + dy,
                                i0[..., 2] + dz]
                v = fma((wx * wy * wz)[..., None], corner, v)
    d, c = v[..., 0], v[..., 1:]
    alpha = 1.0 - torch.exp(-torch.log1p(torch.exp(d)) * interval)
    alpha = torch.where(inb, alpha, torch.zeros_like(alpha))
    one_minus = 1.0 - alpha + 1e-10
    weights = torch.cumprod(one_minus, -1) / one_minus * alpha
    alphainv_last = torch.prod(one_minus, -1)
    return (weights[..., None] * c).sum(1) + alphainv_last[..., None] * bg


@torch.no_grad()
def render_teacher_view(density, rgb, H, W, K, c2w, near, far, bg,
                        n_samples=192, scene_box=None, device="cpu",
                        chunk=65536):
    """One ``[H, W, 3]`` f32 ground-truth view of the teacher grids
    (:func:`teacher_grids`) placed in ``scene_box`` ((min3, max3), default
    [-1, 1]^3), rendered on ``device`` with ``n_samples`` stations from
    ``near`` to ``far``."""
    box_min, box_max = scene_box if scene_box is not None \
        else (np.full(3, -1.0), np.full(3, 1.0))
    box_min = np.asarray(box_min, np.float32)
    box_max = np.asarray(box_max, np.float32)
    rays_o, _, viewdirs = ray_lib.get_rays_of_a_view(
        H, W, K, c2w, ndc=False, inverse_y=False, flip_x=False, flip_y=False)
    res = density.shape[0]
    voxel = float(box_max[0] - box_min[0]) / res
    interval = np.float32((far - near) / n_samples / voxel)

    def put(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    fields = put(np.concatenate([density[..., None], rgb], -1))
    ro = put(rays_o.reshape(-1, 3).astype(np.float32))
    vd = put(viewdirs.reshape(-1, 3).astype(np.float32))
    t = put(np.linspace(near, far, n_samples, dtype=np.float32))
    lo, hi = put(box_min), put(box_max)
    out = torch.cat([
        _teacher_chunk(fields, ro[s:s + chunk], vd[s:s + chunk], t, lo, hi,
                       float(interval), float(bg))
        for s in range(0, ro.shape[0], chunk)])
    return out.cpu().numpy().reshape(H, W, 3)


def _ground_truth(name, cache_dir, device, render_one, n_views):
    """The cached stack ``name``, else its views rendered by
    ``render_one(i, device)`` (written to ``cache_dir`` when given)."""
    images = cache_load(name, cache_dir)
    if images is not None:
        return images
    from ..device import resolve_device
    device = resolve_device(device)
    print(f"synthetic: {name} is not cached; rendering {n_views} views on "
          f"{device}")
    images = np.stack([render_one(i, device) for i in range(n_views)], 0)
    if cache_dir:
        cache_save(name, cache_dir, images)
    return images


def teacher_grids(resolution=64, variant="blobs"):
    """Analytic density/rgb voxel grids for the fixture scene.

    ``variant``: "blobs" (three broad gaussian blobs filling most of the
    volume) or "lego" (seven compact sharp primitives inside ~55% of the
    extent — lego-like occupancy statistics).
    """
    lin = np.linspace(-1.0, 1.0, resolution, dtype=np.float32)
    x, y, z = np.meshgrid(lin, lin, lin, indexing="ij")
    density = np.full_like(x, -6.0)
    if variant == "lego":
        blobs = [
            ((0.30, 0.10, -0.15), 0.20, 14.0, (0.9, 0.75, 0.2)),
            ((-0.28, 0.18, -0.05), 0.17, 14.0, (0.75, 0.2, 0.15)),
            ((0.05, -0.30, 0.10), 0.19, 14.0, (0.2, 0.55, 0.85)),
            ((0.02, 0.25, 0.28), 0.14, 14.0, (0.3, 0.8, 0.3)),
            ((-0.20, -0.22, -0.30), 0.15, 14.0, (0.85, 0.4, 0.1)),
            ((0.33, -0.12, 0.30), 0.12, 14.0, (0.6, 0.6, 0.65)),
            ((-0.05, 0.02, -0.02), 0.22, 14.0, (0.5, 0.5, 0.2)),
        ]
        sharp = 6.0
    else:
        blobs = [
            ((0.35, 0.0, 0.0), 0.35, 9.0, (0.9, 0.2, 0.2)),
            ((-0.3, 0.25, 0.1), 0.28, 9.0, (0.2, 0.8, 0.3)),
            ((0.0, -0.3, -0.25), 0.30, 9.0, (0.25, 0.35, 0.95)),
        ]
        sharp = 2.0
    rgb_num = np.zeros((*x.shape, 3), np.float32)
    w_sum = np.zeros_like(x)
    for (cx, cy, cz), r, peak, color in blobs:
        d2 = (x - cx) ** 2 + (y - cy) ** 2 + (z - cz) ** 2
        if sharp == 2.0:
            w = np.exp(-d2 / (2 * (r / 2) ** 2)).astype(np.float32)
        else:
            w = np.exp(-(d2 / (r / 2) ** 2) ** (sharp / 2)
                       / 2).astype(np.float32)
        density = np.maximum(density, peak * w - 6.0)
        rgb_num += w[..., None] * np.asarray(color, np.float32)
        w_sum += w
    rgb = rgb_num / np.maximum(w_sum[..., None], 1e-6)
    return density, rgb


def make_synthetic_dataset(n_train=16, n_val=2, n_test=4, H=64, W=64,
                           teacher_res=64, white_bkgd=True, seed=0,
                           variant="blobs", cache_dir=None, device=None):
    """A data_dict with the same keys as :func:`..load_data.load_everything`.

    The ground truth comes from ``cache_dir`` or the repository's
    ``fixture_cache/``, else it is rendered on ``device`` (default: the
    CUDA device) and written to ``cache_dir`` when given."""
    rng = np.random.default_rng(seed)
    near, far = 2.0, 6.0
    focal = 0.8 * W
    K = np.array([[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]],
                 np.float32)

    n_total = n_train + n_val + n_test
    thetas = np.linspace(-180, 180, n_total, endpoint=False) \
        + rng.uniform(-2, 2, n_total)
    phis = -30.0 + 12.0 * np.sin(np.linspace(0, 3 * np.pi, n_total)) \
        + rng.uniform(-2, 2, n_total)
    poses = np.stack([pose_spherical(t, p, 4.0)
                      for t, p in zip(thetas, phis)], 0)

    key = f"{n_train}_{n_val}_{n_test}_{H}_{W}_{teacher_res}_" \
          f"{int(white_bkgd)}_{seed}_v2" \
          + (f"_{variant}" if variant != "blobs" else "")

    def render_one(i, dev):
        if not grids:
            grids.extend(teacher_grids(teacher_res, variant=variant))
        return render_teacher_view(*grids, H, W, K, poses[i][:3, :4], near,
                                   far, 1.0 if white_bkgd else 0.0,
                                   device=dev)

    grids = []
    images = _ground_truth(f"fixture_{key}.npz", cache_dir, device,
                           render_one, n_total)

    idx = np.arange(n_total)
    render_poses = np.stack([pose_spherical(t, -30.0, 4.0)
                             for t in np.linspace(-180, 180, 10,
                                                  endpoint=False)], 0)
    return {
        "hwf": [H, W, focal],
        "HW": np.array([[H, W]] * n_total),
        "Ks": np.repeat(K[None], n_total, 0),
        "near": near, "far": far,
        "i_train": idx[:n_train],
        "i_val": idx[n_train:n_train + n_val],
        "i_test": idx[n_train + n_val:],
        "poses": poses[:, :3, :4].astype(np.float32),
        "render_poses": render_poses[:, :3, :4].astype(np.float32),
        "images": images,
        "irregular_shape": False,
    }


def make_ndc_fixture_dataset(n_train=12, n_val=2, n_test=3, H=64, W=64,
                             teacher_res=64, seed=0, cache_dir=None,
                             device=None):
    """The forward-facing (LLFF-style) fixture of the NDC pipeline: cameras
    near the z = 0 plane with small x/y offsets looking down -z at the
    teacher blobs; ``near``/``far`` are NDC's 0/1 (rays are reparameterized
    by :func:`..rays.ndc_rays` downstream). A data_dict with the keys of
    :func:`..load_data.load_everything`. The ground truth (world-space
    renders of the teacher in [-1.2, 1.2]^2 x [-3.4, -1.0]) comes from
    ``cache_dir`` or the repository's ``fixture_cache/``, else it is
    rendered on ``device`` and written to ``cache_dir`` when given."""
    rng = np.random.default_rng(seed)
    focal = 0.8 * W
    K = np.array([[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]],
                 np.float32)
    n_total = n_train + n_val + n_test
    poses = []
    for _ in range(n_total):
        c2w = np.eye(4, dtype=np.float32)
        c2w[0, 3] = rng.uniform(-0.25, 0.25)
        c2w[1, 3] = rng.uniform(-0.25, 0.25)
        c2w[2, 3] = rng.uniform(-0.05, 0.05)
        poses.append(c2w)
    poses = np.stack(poses, 0)
    key = f"ndc_{n_train}_{n_val}_{n_test}_{H}_{W}_{teacher_res}_{seed}_v1"
    scene_box = (np.array([-1.2, -1.2, -3.4], np.float32),
                 np.array([1.2, 1.2, -1.0], np.float32))

    def render_one(i, dev):
        if not grids:
            grids.extend(teacher_grids(teacher_res))
        return render_teacher_view(*grids, H, W, K, poses[i][:3, :4], 0.5,
                                   4.5, 0.0, n_samples=256,
                                   scene_box=scene_box, device=dev)

    grids = []
    images = _ground_truth(f"fixture_{key}.npz", cache_dir, device,
                           render_one, n_total)

    idx = np.arange(n_total)
    render_poses = []
    for t in np.linspace(-0.2, 0.2, 8):
        c2w = np.eye(4, dtype=np.float32)
        c2w[0, 3] = t
        render_poses.append(c2w)
    render_poses = np.stack(render_poses, 0)
    return {
        "hwf": [H, W, focal],
        "HW": np.array([[H, W]] * n_total),
        "Ks": np.repeat(K[None], n_total, 0),
        "near": 0.0, "far": 1.0,
        "i_train": idx[:n_train],
        "i_val": idx[n_train:n_train + n_val],
        "i_test": idx[n_train + n_val:],
        "poses": poses[:, :3, :4].astype(np.float32),
        "render_poses": render_poses[:, :3, :4].astype(np.float32),
        "images": images,
        "irregular_shape": False,
    }
