"""Procedural synthetic scene fixtures (no external dataset needed): the
inward-facing blob scene and its forward-facing (NDC) variant.

Same scenes, poses and cache keys as the JAX package's fixtures: the ground
truth images are read from the committed ``fixture_cache/*.npz`` files.
Generating missing ground truth (the teacher volume render) is not ported
yet (ROADMAP queue A, "GT generation"); a missing cache file raises.
"""

from __future__ import annotations

import os

import numpy as np

from .load_blender import pose_spherical

REPO_CACHE = os.path.normpath(os.path.join(
    os.path.dirname(__file__), os.pardir, os.pardir, "fixture_cache"))


def cache_load(name, cache_dir=None):
    """Load a cached GT stack ``fixture_<key>.npz`` as f32 images."""
    path = os.path.join(cache_dir or REPO_CACHE, name)
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"fixture ground truth {path} is missing; generating it is not "
            "ported yet (ROADMAP: GT generation for uncached fixtures) — "
            "render it once with the JAX package to fill fixture_cache/")
    with np.load(path) as z:
        return z["images"].astype(np.float32)


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
                           variant="blobs", cache_dir=None):
    """A data_dict with the same keys as :func:`..load_data.load_everything`.

    ``cache_dir`` defaults to the repository's ``fixture_cache/``."""
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
    images = cache_load(f"fixture_{key}.npz", cache_dir)

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
                             teacher_res=64, seed=0, cache_dir=None):
    """The forward-facing (LLFF-style) fixture of the NDC pipeline: cameras
    near the z = 0 plane with small x/y offsets looking down -z at the
    teacher blobs; ``near``/``far`` are NDC's 0/1 (rays are reparameterized
    by :func:`..rays.ndc_rays` downstream). A data_dict with the keys of
    :func:`..load_data.load_everything`; ``cache_dir`` defaults to the
    repository's ``fixture_cache/``. The ground truth is rendered in world
    space by the JAX package; a missing cache file raises."""
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
    images = cache_load(f"fixture_{key}.npz", cache_dir)

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
