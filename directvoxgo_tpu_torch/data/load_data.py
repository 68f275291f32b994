"""Dataset hub: dispatch by ``dataset_type`` and normalize near/far, the
intrinsics and the background policy.

Near/far by dataset type:
  blender:           2 / 6
  nsvf, blendedmvs:  inward heuristic, ratio 0.05
  tankstemple, co3d: inward heuristic, ratio 0
  deepvoxels:        hemisphere radius -/+ 1
  llff:              from the bounds, or NDC's 0 / 1
The procedural fixtures bring their own data_dict.
"""

from __future__ import annotations

import numpy as np


def inward_nearfar_heuristic(cam_o, ratio=0.05):
    """near/far from the largest distance between two cameras."""
    dist = np.linalg.norm(cam_o[:, None] - cam_o, axis=-1)
    far = dist.max()
    near = far * ratio
    return near, far


def _composite_bg(images, white_bkgd):
    if images.shape[-1] == 4:
        if white_bkgd:
            return images[..., :3] * images[..., -1:] + (1.0 - images[..., -1:])
        return images[..., :3] * images[..., -1:]
    return images


def load_data(args, device=None):
    """The data_dict of the dataset ``args`` (a config's ``data``);
    ``device`` renders a procedural fixture's ground truth when it is not
    cached."""
    K = None
    images_lr = hwf_lr = None
    if args.dataset_type == "blender":
        if args.get("task") == "sr":
            from .datasets import load_blender_data_lrsr
            images_lr, images, poses, render_poses, hwf, hwf_lr, i_split = \
                load_blender_data_lrsr(basedir=args.datadir, down=args.down,
                                       testskip=args.testskip)
            print("Loaded sr blender", images.shape, images_lr.shape,
                  render_poses.shape, hwf, hwf_lr, args.datadir)
        else:
            from .load_blender import load_blender_data
            images, poses, render_poses, hwf, i_split = load_blender_data(
                args.datadir, args.half_res, args.testskip, args.down)
            print("Loaded blender", images.shape, render_poses.shape, hwf,
                  args.datadir)
        i_train, i_val, i_test = i_split
        near, far = 2.0, 6.0
        images = _composite_bg(images, args.white_bkgd)
        if images_lr is not None:
            images_lr = _composite_bg(images_lr, args.white_bkgd)
    elif args.dataset_type == "nsvf":
        from .load_nsvf import load_nsvf_data
        images, poses, render_poses, hwf, i_split = load_nsvf_data(
            args.datadir, args.down)
        print("Loaded nsvf", images.shape, render_poses.shape, hwf,
              args.datadir)
        i_train, i_val, i_test = i_split
        near, far = inward_nearfar_heuristic(poses[i_train, :3, 3])
        images = _composite_bg(images, args.white_bkgd)
    elif args.dataset_type == "blendedmvs":
        from .load_blendedmvs import load_blendedmvs_data
        images, poses, render_poses, hwf, K, i_split = load_blendedmvs_data(
            args.datadir)
        print("Loaded blendedmvs", images.shape, render_poses.shape, hwf,
              args.datadir)
        i_train, i_val, i_test = i_split
        near, far = inward_nearfar_heuristic(poses[i_train, :3, 3])
        if images.shape[-1] != 3:
            raise ValueError(f"blendedmvs views have {images.shape[-1]} "
                             "channels, not 3")
    elif args.dataset_type == "tankstemple":
        from .load_tankstemple import load_tankstemple_data
        images, poses, render_poses, hwf, K, i_split = load_tankstemple_data(
            args.datadir)
        print("Loaded tankstemple", images.shape, render_poses.shape, hwf,
              args.datadir)
        i_train, i_val, i_test = i_split
        near, far = inward_nearfar_heuristic(poses[i_train, :3, 3], ratio=0)
        images = _composite_bg(images, args.white_bkgd)
    elif args.dataset_type == "deepvoxels":
        from .load_deepvoxels import load_dv_data
        images, poses, render_poses, hwf, i_split = load_dv_data(
            scene=args.get("scene", ""), basedir=args.datadir,
            testskip=args.testskip)
        print("Loaded deepvoxels", images.shape, render_poses.shape, hwf,
              args.datadir)
        i_train, i_val, i_test = i_split
        hemi_r = np.mean(np.linalg.norm(poses[:, :3, -1], axis=-1))
        near, far = hemi_r - 1.0, hemi_r + 1.0
        if not args.white_bkgd or images.shape[-1] != 3:
            raise ValueError("deepvoxels scenes are RGB on a white "
                             "background (white_bkgd=True)")
    elif args.dataset_type == "co3d":
        from .load_co3d import load_co3d_data
        images, masks, poses, render_poses, hwf, K, i_split = \
            load_co3d_data(args)
        print("Loaded co3d", args.datadir, args.annot_path,
              args.sequence_name)
        i_train, i_val, i_test = i_split
        near, far = inward_nearfar_heuristic(poses[i_train, :3, 3], ratio=0)
        for i in range(len(images)):
            if args.white_bkgd:
                images[i] = images[i] * masks[i][..., None] \
                    + (1.0 - masks[i][..., None])
            else:
                images[i] = images[i] * masks[i][..., None]
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
            **{"device": device,
               **dict(getattr(args, "fixture_kwargs", None) or {})})
    elif args.dataset_type == "ndc_fixture":
        from .synthetic import make_ndc_fixture_dataset
        return make_ndc_fixture_dataset(
            **{"device": device,
               **dict(getattr(args, "fixture_kwargs", None) or {})})
    else:
        raise NotImplementedError(
            f"Unknown dataset type {args.dataset_type} exiting")

    H, W, focal = hwf
    H, W = int(H), int(W)
    hwf = [H, W, focal]
    HW = np.array([im.shape[:2] for im in images])
    if K is None:
        K = np.array([[focal, 0, 0.5 * W],
                      [0, focal, 0.5 * H],
                      [0, 0, 1]])
    Ks = K[None].repeat(len(poses), axis=0) if np.ndim(K) == 2 else K
    out = dict(
        hwf=hwf, HW=HW, Ks=Ks, near=near, far=far,
        i_train=i_train, i_val=i_val, i_test=i_test,
        poses=poses, render_poses=render_poses[..., :4],
        images=images, depths=None,
        irregular_shape=images.dtype is np.dtype("object"))
    if images_lr is not None:
        H_lr, W_lr, focal_lr = hwf_lr
        K_lr = np.array([[focal_lr, 0, 0.5 * W_lr],
                         [0, focal_lr, 0.5 * H_lr], [0, 0, 1]])
        out.update(
            images_lr=images_lr, hwf_lr=hwf_lr,
            HW_lr=np.array([im.shape[:2] for im in images_lr]),
            Ks_lr=K_lr[None].repeat(len(poses), axis=0))
    return out


def load_everything(args, cfg):
    """Load and prune to the canonical data_dict keys (``args.device``, when
    given, renders an uncached fixture's ground truth)."""
    data_dict = load_data(cfg.data, device=getattr(args, "device", None))
    kept_keys = {
        "hwf", "HW", "Ks", "near", "far",
        "i_train", "i_val", "i_test", "irregular_shape",
        "poses", "render_poses", "images"}
    if cfg.data.get("task") == "sr":
        kept_keys |= {"images_lr", "hwf_lr", "HW_lr", "Ks_lr"}
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
