"""CO3D dataset loader.

Reads the gzip json frame annotations (kept to one sequence), the
train/test set lists, each frame's foreground mask (frames whose mask is
empty are dropped) and pytorch3d-convention viewpoints, turned into c2w
and pixel intrinsics. Views may differ in size: the images and masks are
then object arrays (``irregular_shape``). PNG and JPEG frames (CO3D ships
``.jpg``) load without ``imageio`` (:func:`.image_io.read_image`).
"""

from __future__ import annotations

import gzip
import json
import os

import numpy as np

from .image_io import read_image


def pixel_intrinsics(size_hw, principal_point, focal_length):
    """3x3 pixel K of a view of ``size_hw`` from pytorch3d's NDC principal
    point and focal length (+x left, +y up, half the size per unit)."""
    half_wh = np.float32(size_hw[::-1]) * 0.5
    pp = np.float32(principal_point)
    fl = np.float32(focal_length)
    pp_px = -1.0 * (pp - 1.0) * half_wh
    fl_px = fl * half_wh
    return np.array([
        [fl_px[0], 0, pp_px[0]],
        [0, fl_px[1], pp_px[1]],
        [0, 0, 1],
    ])


def _set_lists(split_path, sequence_name):
    with open(split_path) as f:
        split = json.load(f)
    train_im_path, test_im_path = set(), set()
    for k, lst in split.items():
        for v in lst:
            if v[0] == sequence_name:
                (train_im_path if "known" in k else test_im_path).add(v[-1])
    return train_im_path, test_im_path


def load_co3d_data(cfg):
    """(images, masks, poses, render_poses, [H, W, focal] (means), Ks,
    [train, test, test])."""
    with gzip.open(cfg.annot_path, "rt", encoding="utf8") as zf:
        annot = [v for v in json.load(zf)
                 if v["sequence_name"] == cfg.sequence_name]
    train_im_path, test_im_path = _set_lists(cfg.split_path,
                                             cfg.sequence_name)
    if len(annot) != len(train_im_path) + len(test_im_path):
        raise ValueError(
            f"{len(annot)} annotated frames against "
            f"{len(train_im_path) + len(test_im_path)} in the set lists")

    imgs, masks, poses, Ks = [], [], [], []
    i_split = [[], []]
    removed = [0, 0]
    for meta in annot:
        im_fname = meta["image"]["path"]
        if im_fname not in train_im_path | test_im_path:
            raise ValueError(f"{im_fname} is in no set list")
        sid = 0 if im_fname in train_im_path else 1
        if meta["mask"]["mass"] == 0:
            removed[sid] += 1
            continue
        mask = read_image(os.path.join(cfg.datadir,
                                       meta["mask"]["path"])) / 255.0
        if mask.max() < 0.5:
            removed[sid] += 1
            continue
        # world->cam [R|T] -> c2w
        Rt = np.concatenate(
            [meta["viewpoint"]["R"],
             np.array(meta["viewpoint"]["T"])[:, None]], 1)
        pose = np.linalg.inv(np.concatenate([Rt, [[0, 0, 0, 1]]]))
        imgs.append(read_image(os.path.join(cfg.datadir, im_fname)) / 255.0)
        masks.append(mask)
        poses.append(pose)
        if imgs[-1].shape[:2] != tuple(meta["image"]["size"]):
            raise ValueError(f"{im_fname}: image of {imgs[-1].shape[:2]}, "
                             f"annotated {meta['image']['size']}")
        Ks.append(pixel_intrinsics(meta["image"]["size"],
                                   meta["viewpoint"]["principal_point"],
                                   meta["viewpoint"]["focal_length"]))
        i_split[sid].append(len(imgs) - 1)

    if sum(removed) > 0:
        print("load_co3d_data: removed %d train / %d test due to empty mask"
              % tuple(removed))
    print(f"load_co3d_data: num images {len(i_split[0])} train / "
          f"{len(i_split[1])} test")

    imgs = np.array(imgs, dtype=object) \
        if len({im.shape for im in imgs}) > 1 else np.array(imgs)
    masks = np.array(masks, dtype=object) \
        if len({m.shape for m in masks}) > 1 else np.array(masks)
    poses = np.stack(poses, 0)
    Ks = np.stack(Ks, 0)
    render_poses = poses[i_split[-1]]
    i_split.append(i_split[-1])
    hw = np.array([im.shape[:2] for im in imgs]).mean(0).astype(int)
    focal = Ks[:, [0, 1], [0, 1]].mean()
    return imgs, masks, poses, render_poses, \
        [int(hw[0]), int(hw[1]), focal], Ks, i_split
