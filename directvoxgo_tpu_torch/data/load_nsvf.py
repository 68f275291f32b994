"""NSVF-format dataset loader.

Layout: ``rgb/*.png`` + ``pose/*.txt`` (4x4 c2w) + ``intrinsics.txt`` whose
first value is the focal length. The split is the file name's first
digit: 0_* train, 1_* val, 2_* test (val falls back to test when empty).
``down > 1`` shrinks the views by an area resize.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from .image_io import area_resize_np, read_png


def read_views(basedir, n_splits):
    """Sorted ``rgb/*png`` and ``pose/*txt`` pairs: float32 images in [0,
    1], float32 poses and per split the indices whose file name starts
    with its digit."""
    pose_paths = sorted(glob.glob(os.path.join(basedir, "pose", "*txt")))
    rgb_paths = sorted(glob.glob(os.path.join(basedir, "rgb", "*png")))
    imgs, poses = [], []
    i_split = [[] for _ in range(n_splits)]
    for i, (pose_path, rgb_path) in enumerate(zip(pose_paths, rgb_paths)):
        i_set = int(os.path.split(rgb_path)[-1][0])
        imgs.append((read_png(rgb_path) / 255.0).astype(np.float32))
        poses.append(np.loadtxt(pose_path).astype(np.float32))
        i_split[i_set].append(i)
    return np.stack(imgs, 0), np.stack(poses, 0), i_split


def load_nsvf_data(basedir, down=1):
    """(images, poses, render_poses, [H, W, focal], i_split); the render
    path is the test poses."""
    imgs, poses, i_split = read_views(basedir, 3)
    i_split = [np.array(s, dtype=np.int64) for s in i_split]
    if len(i_split[1]) == 0:
        i_split[1] = i_split[2]
    with open(os.path.join(basedir, "intrinsics.txt")) as f:
        focal = float(f.readline().split()[0])
    H, W = imgs[0].shape[:2]
    if down > 1:
        H, W = H // down, W // down
        focal = focal / down
        imgs = np.stack([area_resize_np(im, H, W) for im in imgs], 0)
    render_poses = poses[i_split[-1]]
    return imgs, poses, render_poses, [H, W, focal], i_split
