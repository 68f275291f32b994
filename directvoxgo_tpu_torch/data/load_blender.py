"""Blender (nerf_synthetic) dataset loader: ``transforms_{split}.json`` plus
RGBA pngs, a 40-view spherical render path, ``half_res``/``down`` resizing
(area, :func:`.image_io.area_resize_np`)."""

from __future__ import annotations

import json
import os

import numpy as np

from .image_io import area_resize_np, read_png


def _translate_z(t):
    m = np.eye(4, dtype=np.float32)
    m[2, 3] = t
    return m


def _rotate_phi(phi):
    c, s = np.cos(phi), np.sin(phi)
    m = np.eye(4, dtype=np.float32)
    m[1, 1], m[1, 2] = c, -s
    m[2, 1], m[2, 2] = s, c
    return m


def _rotate_theta(th):
    c, s = np.cos(th), np.sin(th)
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[0, 2] = c, -s
    m[2, 0], m[2, 2] = s, c
    return m


def pose_spherical(theta, phi, radius):
    """Camera-to-world for a spherical orbit pose."""
    c2w = _translate_z(radius)
    c2w = _rotate_phi(phi / 180.0 * np.pi) @ c2w
    c2w = _rotate_theta(theta / 180.0 * np.pi) @ c2w
    flip = np.array([[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]],
                    dtype=np.float32)
    return flip @ c2w


def render_path_spherical(n_views=40, phi=-30.0, radius=4.0):
    return np.stack([
        pose_spherical(angle, phi, radius)
        for angle in np.linspace(-180, 180, n_views + 1)[:-1]], 0)


def load_blender_data(basedir, half_res=False, testskip=1, down=1):
    splits = ["train", "val", "test"]
    metas = {}
    for s in splits:
        with open(os.path.join(basedir, f"transforms_{s}.json")) as fp:
            metas[s] = json.load(fp)

    all_imgs, all_poses, counts = [], [], [0]
    for s in splits:
        meta = metas[s]
        skip = 1 if s == "train" or testskip == 0 else testskip
        imgs, poses = [], []
        for frame in meta["frames"][::skip]:
            fname = os.path.join(basedir, frame["file_path"] + ".png")
            imgs.append(read_png(fname))
            poses.append(np.array(frame["transform_matrix"]))
        imgs = (np.array(imgs) / 255.0).astype(np.float32)
        poses = np.array(poses).astype(np.float32)
        counts.append(counts[-1] + imgs.shape[0])
        all_imgs.append(imgs)
        all_poses.append(poses)

    i_split = [np.arange(counts[i], counts[i + 1]) for i in range(3)]
    imgs = np.concatenate(all_imgs, 0)
    poses = np.concatenate(all_poses, 0)

    H, W = imgs[0].shape[:2]
    camera_angle_x = float(metas["train"]["camera_angle_x"])
    focal = 0.5 * W / np.tan(0.5 * camera_angle_x)
    render_poses = render_path_spherical()

    factor = (2 if half_res else 1) * int(down)
    if factor > 1:
        H, W = H // factor, W // factor
        focal = focal / factor
        imgs = np.stack([area_resize_np(im, H, W) for im in imgs], 0)

    return imgs, poses, render_poses, [H, W, focal], i_split
