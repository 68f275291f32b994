"""DeepVoxels dataset loader.

Layout: ``{train,validation,test}/{scene}/{rgb,pose}`` with an
``intrinsics.txt`` header giving (f, cx, cy), the barycenter, the near
plane, the scale and the source resolution. The intrinsics are rescaled
to the 512x512 target, and the poses are multiplied by diag(1, -1, -1, 1)
into the OpenGL convention. The images are read as they are.
"""

from __future__ import annotations

import os

import numpy as np

from .image_io import read_png

TARGET = 512
_AXIS_FLIP = np.array([
    [1, 0, 0, 0],
    [0, -1, 0, 0],
    [0, 0, -1, 0],
    [0, 0, 0, 1.0],
])


def parse_intrinsics(filepath, trgt_sidelength):
    """(K at the target side length, barycenter, scale, near plane)."""
    with open(filepath) as f:
        focal, cx, cy = map(float, f.readline().split()[:3])
        barycenter = np.array(list(map(float, f.readline().split())))
        near_plane = float(f.readline())
        scale = float(f.readline())
        height, width = map(float, f.readline().split())
    cx = cx / width * trgt_sidelength
    cy = cy / height * trgt_sidelength
    focal = trgt_sidelength / height * focal
    K = np.array([[focal, 0.0, cx], [0.0, focal, cy], [0.0, 0.0, 1.0]])
    return K, barycenter, scale, near_plane


def _files(d, ext):
    return [os.path.join(d, f) for f in sorted(os.listdir(d))
            if f.endswith(ext)]


def _load_poses(posedir, skip=1):
    poses = np.stack([np.loadtxt(f).reshape(4, 4)
                      for f in _files(posedir, "txt")], 0).astype(np.float32)
    poses = (poses @ _AXIS_FLIP)[:, :3, :4].astype(np.float32)
    return poses[::skip]


def _load_images(rgbdir, skip=1):
    return np.stack([read_png(f) / 255.0
                     for f in _files(rgbdir, "png")[::skip]],
                    0).astype(np.float32)


def load_dv_data(scene="cube", basedir="/data/deepvoxels", testskip=1):
    """(images, poses [n, 3, 4], render_poses (the test poses), [512, 512,
    focal], i_split)."""
    H = W = TARGET
    train_base = os.path.join(basedir, "train", scene)
    K, _, _, _ = parse_intrinsics(os.path.join(train_base, "intrinsics.txt"),
                                  H)
    splits = ((train_base, 1),
              (os.path.join(basedir, "validation", scene), testskip),
              (os.path.join(basedir, "test", scene), testskip))
    imgs_per_split, poses_per_split = [], []
    for base, skip in splits:
        imgs_per_split.append(_load_images(os.path.join(base, "rgb"), skip))
        poses_per_split.append(_load_poses(os.path.join(base, "pose"), skip))
    counts = np.cumsum([0] + [x.shape[0] for x in imgs_per_split])
    i_split = [np.arange(counts[i], counts[i + 1]) for i in range(3)]
    imgs = np.concatenate(imgs_per_split, 0)
    poses = np.concatenate(poses_per_split, 0)
    return imgs, poses, poses_per_split[-1], [H, W, K[0, 0]], i_split
