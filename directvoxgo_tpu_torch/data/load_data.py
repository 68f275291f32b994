"""Dataset hub: dispatch by ``dataset_type`` (blender, llff and the two
procedural fixtures so far) and normalize near/far and the background
policy (llff: from the bounds, or NDC's 0/1)."""

from __future__ import annotations

import numpy as np

# ROADMAP queue A item that ports each remaining loader.
_NOT_PORTED = {
    "nsvf": "A10 (remaining loaders)",
    "blendedmvs": "A10 (remaining loaders)",
    "tankstemple": "A10 (remaining loaders)",
    "deepvoxels": "A10 (remaining loaders)",
    "co3d": "A10 (remaining loaders)",
}


def _composite_bg(images, white_bkgd):
    if images.shape[-1] == 4:
        if white_bkgd:
            return images[..., :3] * images[..., -1:] + (1.0 - images[..., -1:])
        return images[..., :3] * images[..., -1:]
    return images


def load_data(args):
    if args.dataset_type == "blender" and args.get("task") != "sr":
        from .load_blender import load_blender_data
        images, poses, render_poses, hwf, i_split = load_blender_data(
            args.datadir, args.half_res, args.testskip, args.down)
        print("Loaded blender", images.shape, render_poses.shape, hwf,
              args.datadir)
        i_train, i_val, i_test = i_split
        near, far = 2.0, 6.0
        images = _composite_bg(images, args.white_bkgd)
    elif args.dataset_type == "llff":
        from .load_llff import load_llff_data
        images, depths, poses, bds, render_poses, i_test = load_llff_data(
            args.datadir, args.factor, args.width, args.height,
            recenter=True, bd_factor=0.75, spherify=args.spherify,
            load_depths=args.load_depths)
        hwf = poses[0, :3, -1]
        poses = poses[:, :3, :4]
        print("Loaded llff", images.shape, render_poses.shape, hwf,
              args.datadir)
        if not isinstance(i_test, (list, np.ndarray)):
            i_test = [i_test]
        if args.llffhold > 0:
            print("Auto LLFF holdout,", args.llffhold)
            i_test = np.arange(images.shape[0])[::args.llffhold]
        i_val = i_test
        i_train = np.array([i for i in np.arange(int(images.shape[0]))
                            if i not in i_test and i not in i_val])
        if args.ndc:
            near, far = 0.0, 1.0
        else:
            near = float(np.min(bds)) * 0.9
            far = float(np.max(bds)) * 1.0
        print("NEAR FAR", near, far)
    elif args.dataset_type == "synthetic_fixture":
        from .synthetic import make_synthetic_dataset
        return make_synthetic_dataset(
            white_bkgd=args.white_bkgd,
            **dict(getattr(args, "fixture_kwargs", None) or {}))
    elif args.dataset_type == "ndc_fixture":
        from .synthetic import make_ndc_fixture_dataset
        return make_ndc_fixture_dataset(
            **dict(getattr(args, "fixture_kwargs", None) or {}))
    elif args.dataset_type == "blender":
        raise NotImplementedError(
            "blender task='sr' is not ported yet (ROADMAP A12)")
    elif args.dataset_type in _NOT_PORTED:
        raise NotImplementedError(
            f"dataset_type {args.dataset_type!r} is not ported yet "
            f"(ROADMAP {_NOT_PORTED[args.dataset_type]})")
    else:
        raise NotImplementedError(
            f"Unknown dataset type {args.dataset_type} exiting")

    H, W, focal = hwf
    H, W = int(H), int(W)
    hwf = [H, W, focal]
    HW = np.array([im.shape[:2] for im in images])
    K = np.array([[focal, 0, 0.5 * W],
                  [0, focal, 0.5 * H],
                  [0, 0, 1]])
    Ks = K[None].repeat(len(poses), axis=0)
    return dict(
        hwf=hwf, HW=HW, Ks=Ks, near=near, far=far,
        i_train=i_train, i_val=i_val, i_test=i_test,
        poses=poses, render_poses=render_poses[..., :4],
        images=images, depths=None,
        irregular_shape=images.dtype is np.dtype("object"))


def load_everything(args, cfg):
    """Load and prune to the canonical data_dict keys."""
    data_dict = load_data(cfg.data)
    kept_keys = {
        "hwf", "HW", "Ks", "near", "far",
        "i_train", "i_val", "i_test", "irregular_shape",
        "poses", "render_poses", "images"}
    for k in list(data_dict.keys()):
        if k not in kept_keys:
            data_dict.pop(k)
    if data_dict["irregular_shape"]:
        data_dict["images"] = [np.asarray(im, np.float32)
                               for im in data_dict["images"]]
    else:
        data_dict["images"] = np.asarray(data_dict["images"], np.float32)
    data_dict["poses"] = np.asarray(data_dict["poses"], np.float32)
    return data_dict
