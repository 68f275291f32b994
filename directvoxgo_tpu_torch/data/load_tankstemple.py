"""Tanks&Temples dataset loader: the BlendedMVS layout; the render path
falls back to the test poses when ``test_traj.txt`` is absent."""

from __future__ import annotations

from .load_blendedmvs import load_prefix_split_scene, load_render_traj


def load_tankstemple_data(basedir):
    imgs, poses, K, i_split = load_prefix_split_scene(basedir)
    H, W = imgs[0].shape[:2]
    render_poses = load_render_traj(basedir)
    if render_poses is None:
        render_poses = poses[i_split[-1]]
    return imgs, poses, render_poses, [H, W, float(K[0, 0])], K, i_split
