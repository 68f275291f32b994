"""Dataset classes of the conditioned and multi-scene drivers: the LR/HR
pair loader with its ``down_{d}.pkl`` cache, the single-scene Blender
dataset and the multi-scene Blender dataset (preloaded, or read per scene
with ``lazy``). Plain Python over numpy arrays; the drivers index them.

Images are downscaled with :func:`..ops.resize.area_resize` (OpenCV's
``INTER_AREA``). The multi-scene NSVF dataset needs the NSVF loader, which
is not ported yet.
"""

from __future__ import annotations

import json
import os
import pickle

import numpy as np
import torch

from ..ops.resize import area_resize
from .load_blender import render_path_spherical


def _composite(image, white_bkgd):
    if image.shape[-1] == 4:
        if white_bkgd:
            return image[..., :3] * image[..., -1:] + (1.0 - image[..., -1:])
        return image[..., :3] * image[..., -1:]
    return image


def _downscale(images, h, w):
    """``[..., H, W, C]`` float32 numpy -> ``[..., h, w, C]`` (area)."""
    return area_resize(torch.as_tensor(np.ascontiguousarray(images)), h,
                       w).numpy()


def _read_png(path):
    import imageio.v2 as imageio
    return (np.array(imageio.imread(path)) / 255.0).astype(np.float32)


def load_blender_data_lrsr(basedir, down=4, testskip=1):
    """LR/HR pairs of a Blender scene, cached in ``basedir/down_{d}.pkl``:
    (imgs_lr, imgs_sr, poses, render_poses, [H, W, focal] of the HR and of
    the LR views, i_split)."""
    from ..engine.checkpoint import load_checkpoint_file
    pkl_file = os.path.join(basedir, f"down_{down}.pkl")
    if os.path.isfile(pkl_file):
        ret = load_checkpoint_file(pkl_file)
        return (ret["imgs_lr"], ret["imgs_sr"], ret["poses"],
                ret["render_poses"], ret["sr_cam"], ret["lr_cam"],
                ret["i_split"])

    splits = ["train", "val", "test"]
    metas = {}
    for s in splits:
        with open(os.path.join(basedir, f"transforms_{s}.json")) as fp:
            metas[s] = json.load(fp)
    all_imgs, all_poses, counts = [], [], [0]
    for s in splits:
        skip = 1 if s == "train" or testskip == 0 else testskip
        frames = metas[s]["frames"][::skip]
        all_imgs.append(np.stack([
            _read_png(os.path.join(basedir, f["file_path"] + ".png"))
            for f in frames]))
        all_poses.append(np.array([f["transform_matrix"] for f in frames],
                                  np.float32))
        counts.append(counts[-1] + len(frames))
    i_split = [np.arange(counts[i], counts[i + 1]) for i in range(3)]
    imgs_sr = np.concatenate(all_imgs, 0)
    poses = np.concatenate(all_poses, 0)
    H, W = imgs_sr[0].shape[:2]
    focal_sr = 0.5 * W / np.tan(0.5 * float(metas["train"]["camera_angle_x"]))
    render_poses = render_path_spherical()
    h, w = H // down, W // down
    focal_lr = focal_sr / float(down)
    imgs_lr = _downscale(imgs_sr, h, w) if down > 1 else imgs_sr
    ret = dict(imgs_lr=imgs_lr, imgs_sr=imgs_sr, poses=poses,
               render_poses=render_poses, sr_cam=[H, W, focal_sr],
               lr_cam=[h, w, focal_lr], i_split=i_split)
    with open(pkl_file, "wb") as f:
        pickle.dump(ret, f)
    return (imgs_lr, imgs_sr, poses, render_poses, [H, W, focal_sr],
            [h, w, focal_lr], i_split)


def _intrinsics(H, W, camera_angle_x):
    focal = 0.5 * W / np.tan(0.5 * float(camera_angle_x))
    return np.array([[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]],
                    np.float32)


class BlenderDataset:
    """One Blender scene's split as arrays: ``images``, ``poses``, ``K``."""

    near, far = 2.0, 6.0

    def __init__(self, basedir, split="train", testskip=1, down=1,
                 white_bkgd=True):
        with open(os.path.join(basedir, f"transforms_{split}.json")) as f:
            meta = json.load(f)
        skip = 1 if split == "train" or testskip == 0 else testskip
        imgs, poses = [], []
        for frame in meta["frames"][::skip]:
            image = _read_png(os.path.join(basedir,
                                           frame["file_path"] + ".png"))
            if down > 1:
                image = _downscale(image, image.shape[0] // down,
                                   image.shape[1] // down)
            imgs.append(_composite(image, white_bkgd))
            poses.append(np.array(frame["transform_matrix"], np.float32))
        self.images = np.stack(imgs, 0)
        self.poses = np.stack(poses, 0)
        self.H, self.W = self.images.shape[1:3]
        self.K = _intrinsics(self.H, self.W, meta["camera_angle_x"])
        self.render_poses = render_path_spherical()

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i):
        return {"image": self.images[i], "pose": self.poses[i],
                "K": self.K, "HW": (self.H, self.W)}


class MultisceneBlenderDataset:
    """Scenes are subdirectories with Blender transforms; ``test_scenes``
    are held out of the train split (and are the test split). ``lazy``
    reads a scene's images when it is asked for, else all are preloaded
    (``all_imgs [n_scene, n_views, H, W, 3]``)."""

    near, far = 2.0, 6.0

    def __init__(self, basedir, split="train", testskip=1, down=1,
                 white_bkgd=True, test_scenes=(), lazy=False):
        self.basedir = basedir
        self.split = split
        self.down = down
        self.white_bkgd = white_bkgd
        self.lazy = lazy
        scenes = sorted(
            d for d in os.listdir(basedir)
            if os.path.isdir(os.path.join(basedir, d))
            and os.path.isfile(os.path.join(
                basedir, d, f"transforms_{split}.json")))
        if test_scenes:
            if split == "train":
                scenes = [s for s in scenes if s not in test_scenes]
            else:
                scenes = [s for s in scenes if s in test_scenes]
        self.scenes = scenes
        self.meta = {}
        for s in scenes:
            with open(os.path.join(basedir, s,
                                   f"transforms_{split}.json")) as f:
                self.meta[s] = json.load(f)
        self.skip = 1 if split == "train" or testskip == 0 else testskip
        self.render_poses = render_path_spherical()
        if not lazy:
            self._preload()

    @property
    def n_scene(self):
        return len(self.scenes)

    def _load_frame(self, scene, frame):
        image = _read_png(os.path.join(self.basedir, scene,
                                       frame["file_path"] + ".png"))
        if self.down > 1:
            image = _downscale(image, image.shape[0] // self.down,
                               image.shape[1] // self.down)
        return _composite(image, self.white_bkgd)

    def _load_scene(self, s):
        frames = self.meta[s]["frames"][::self.skip]
        imgs = np.stack([self._load_frame(s, f) for f in frames], 0)
        poses = np.stack([np.array(f["transform_matrix"], np.float32)
                          for f in frames], 0)
        K = _intrinsics(imgs.shape[1], imgs.shape[2],
                        self.meta[s]["camera_angle_x"])
        return imgs, poses, np.repeat(K[None], len(poses), 0)

    def _preload(self):
        loaded = [self._load_scene(s) for s in self.scenes]
        self.all_imgs = np.stack([x[0] for x in loaded], 0)
        self.all_poses = np.stack([x[1] for x in loaded], 0)
        self.all_Ks = np.stack([x[2] for x in loaded], 0)
        self.H, self.W = self.all_imgs.shape[2:4]

    def scene_data(self, scene_id):
        """The scene's views: images, poses ``[n, 3, 4]``, Ks, HW, near,
        far."""
        if self.lazy:
            imgs, poses, Ks = self._load_scene(self.scenes[scene_id])
        else:
            imgs, poses, Ks = (self.all_imgs[scene_id],
                               self.all_poses[scene_id],
                               self.all_Ks[scene_id])
        H, W = imgs.shape[1:3]
        return {"images": imgs, "poses": poses[:, :3, :4], "Ks": Ks,
                "HW": np.array([[H, W]] * len(imgs)),
                "near": self.near, "far": self.far}

    def __len__(self):
        return self.n_scene

    def __getitem__(self, i):
        return self.scene_data(i)


class MultisceneNSVFDataset:
    """Multi-scene NSVF scenes; needs ``load_nsvf``."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "the multi-scene NSVF dataset needs the NSVF loader, which is "
            "not ported yet (ROADMAP A4)")


dataset_dict = {
    "blender": BlenderDataset,
    "multiscene_blender": MultisceneBlenderDataset,
    "multiscene_nsvf": MultisceneNSVFDataset,
}
