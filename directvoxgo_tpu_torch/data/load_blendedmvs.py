"""BlendedMVS dataset loader.

Layout: ``rgb/*.png`` + ``pose/*.txt`` + ``intrinsics.txt`` (the full K)
+ ``test_traj.txt`` (the render path). The file name's first digit 0/1
selects train/test; the test split doubles as val.
"""

from __future__ import annotations

import os

import numpy as np

from .load_nsvf import read_views


def load_prefix_split_scene(basedir):
    """(images, poses, K, [train, test, test]) of a prefix-split scene."""
    imgs, poses, i_split = read_views(basedir, 2)
    i_split.append(i_split[-1])
    i_split = [np.array(s, dtype=np.int64) for s in i_split]
    K = np.loadtxt(os.path.join(basedir, "intrinsics.txt"))
    return imgs, poses, K, i_split


def load_render_traj(basedir):
    """``test_traj.txt`` as float32 ``[n, 4, 4]`` c2w, or None."""
    path = os.path.join(basedir, "test_traj.txt")
    if not os.path.isfile(path):
        return None
    return np.loadtxt(path).reshape(-1, 4, 4).astype(np.float32)


def load_blendedmvs_data(basedir):
    imgs, poses, K, i_split = load_prefix_split_scene(basedir)
    H, W = imgs[0].shape[:2]
    render_poses = load_render_traj(basedir)
    if render_poses is None:
        raise FileNotFoundError(
            f"{os.path.join(basedir, 'test_traj.txt')} is missing")
    return imgs, poses, render_poses, [H, W, float(K[0, 0])], K, i_split
