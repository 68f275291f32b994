"""Write posed views as a scene in the NSVF, BlendedMVS, Tanks&Temples,
DeepVoxels or CO3D layout, as 8-bit PNGs, for the loaders of
:mod:`..data.load_data` to read back.

The views come as a data_dict does (:func:`..data.load_data.load_everything`
of a procedural fixture, say): float images in [0, 1], camera-to-world
poses in the OpenGL convention (x right, y up, looking down -z) and pixel
intrinsics. Each writer turns the poses into its format's convention, so
that the format's loader, with the ``inverse_y``/``flip_x``/``flip_y`` of
the format's configs, gives back the same rays:

- NSVF, BlendedMVS, Tanks&Temples (``inverse_y``): OpenCV camera axes (y
  down, looking down +z), the c2w times diag(1, -1, -1, 1);
- DeepVoxels (no flag): the loader multiplies its poses by diag(1, -1, -1,
  1), so they are written so; its views must be 512x512 (its loader's
  target; the intrinsics header gives the source resolution);
- CO3D (``inverse_y``, ``flip_x``, ``flip_y``): pytorch3d's axes (x left,
  y up, looking down +z) as a world-to-camera ``R``, ``T``, and NDC focal
  length and principal point; a view may be cropped, its principal point
  moved with it, so that views differ in size.

Usage (a fixture as a CO3D scene)::

  from directvoxgo_tpu_torch.data.synthetic import make_synthetic_dataset
  from directvoxgo_tpu_torch.tools import scene_layouts
  d = make_synthetic_dataset(H=40, W=40, n_train=10, n_val=1, n_test=2)
  scene_layouts.write_co3d("/tmp/co3d", d["images"], d["poses"], d["Ks"],
                           d["i_train"], d["i_test"])
"""

from __future__ import annotations

import gzip
import json
import os

import numpy as np

from ..data.image_io import write_png

GL_TO_CV = np.diag([1.0, -1.0, -1.0, 1.0])
GL_TO_P3D = np.diag([-1.0, 1.0, -1.0, 1.0])
DV_TARGET = 512


def to_u8(img):
    """A float image in [0, 1] as uint8, ``round(clip(x) * 255)``."""
    return np.round(np.clip(np.asarray(img, np.float64), 0.0, 1.0)
                    * 255.0).astype(np.uint8)


def _c2w4(pose):
    out = np.eye(4)
    out[:3, :4] = np.asarray(pose, np.float64)[:3, :4]
    return out


def _num(x):
    return repr(float(x))


def _savetxt(path, mat):
    np.savetxt(path, np.asarray(mat, np.float64), fmt="%.9g")


def write_prefix_split(root, images, poses, K, splits, full_k,
                       render_traj=None):
    """``rgb/<d>_<i>.png`` and ``pose/<d>_<i>.txt`` (OpenCV c2w) for the
    view indices ``splits[d]`` of split digit ``d``; ``intrinsics.txt``: a
    4x4 K (``full_k``: BlendedMVS, Tanks&Temples) or NSVF's ``f cx cy 0``
    header; ``test_traj.txt`` from ``render_traj`` (GL c2w) when given.
    Returns the written view indices in the order the loaders read them."""
    os.makedirs(os.path.join(root, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(root, "pose"), exist_ok=True)
    order = []
    for d, ids in enumerate(splits):
        for i in ids:
            name = f"{d}_{int(i):05d}"
            write_png(os.path.join(root, "rgb", name + ".png"),
                      to_u8(images[i]))
            _savetxt(os.path.join(root, "pose", name + ".txt"),
                     _c2w4(poses[i]) @ GL_TO_CV)
            order.append(int(i))
    K = np.asarray(K, np.float64)
    if full_k:
        k4 = np.eye(4)
        k4[:3, :3] = K
        _savetxt(os.path.join(root, "intrinsics.txt"), k4)
    else:
        h, w = np.asarray(images[order[0]]).shape[:2]
        with open(os.path.join(root, "intrinsics.txt"), "w") as f:
            f.write(f"{_num(K[0, 0])} {_num(K[0, 2])} {_num(K[1, 2])} 0.\n"
                    f"0. 0. 0.\n1.\n{h} {w}\n")
    if render_traj is not None:
        _savetxt(os.path.join(root, "test_traj.txt"), np.concatenate(
            [_c2w4(p) @ GL_TO_CV for p in render_traj], 0))
    return order


def write_deepvoxels(root, scene, images, poses, K_src, src_hw, splits):
    """``{train,validation,test}/<scene>/{rgb,pose}`` for the index lists
    ``splits`` (three), with ``intrinsics.txt`` (of the source resolution
    ``src_hw`` and its K) under ``train/<scene>``. ``images`` must be
    512x512; their principal point is the centre."""
    K = np.asarray(K_src, np.float64)
    for name, ids in zip(("train", "validation", "test"), splits):
        base = os.path.join(root, name, scene)
        os.makedirs(os.path.join(base, "rgb"), exist_ok=True)
        os.makedirs(os.path.join(base, "pose"), exist_ok=True)
        for i in ids:
            img = to_u8(images[i])
            if img.shape[:2] != (DV_TARGET, DV_TARGET):
                raise ValueError(f"DeepVoxels views are {DV_TARGET}^2, "
                                 f"not {img.shape[:2]}")
            write_png(os.path.join(base, "rgb", f"{int(i):05d}.png"), img)
            _savetxt(os.path.join(base, "pose", f"{int(i):05d}.txt"),
                     (_c2w4(poses[i]) @ GL_TO_CV).reshape(1, 16))
    with open(os.path.join(root, "train", scene, "intrinsics.txt"),
              "w") as f:
        f.write(f"{_num(K[0, 0])} {_num(K[0, 2])} {_num(K[1, 2])} 0.\n"
                f"0. 0. 0.\n0.\n1.\n{src_hw[0]} {src_hw[1]}\n")


def write_co3d(root, images, poses, Ks, train_ids, test_ids, masks=None,
               crops=None, category="fixture", sequence="0_0_0",
               empty_mass=()):
    """A CO3D sequence under ``root/<category>``: ``frame_annotations.jgz``
    and ``set_lists.json`` beside ``<sequence>/images`` and ``masks``.
    ``masks`` (floats in [0, 1]; default all ones), ``crops`` (per view
    None or ``(y0, x0, h, w)``: the view is cut to it and its principal
    point moves with it), ``empty_mass`` (views annotated with mask mass 0).
    Returns (annotation path, set-list path)."""
    seq_dir = os.path.join(root, category, sequence)
    os.makedirs(os.path.join(seq_dir, "images"), exist_ok=True)
    os.makedirs(os.path.join(seq_dir, "masks"), exist_ok=True)
    annots, known, unseen = [], [], []
    for i in list(train_ids) + list(test_ids):
        i = int(i)
        img = np.asarray(images[i])
        mask = np.ones(img.shape[:2]) if masks is None \
            else np.asarray(masks[i])
        K = np.asarray(Ks[i], np.float64)
        cx, cy = K[0, 2], K[1, 2]
        y0, x0, h, w = (crops[i] if crops is not None and crops[i]
                        is not None else (0, 0, *img.shape[:2]))
        img, mask = img[y0:y0 + h, x0:x0 + w], mask[y0:y0 + h, x0:x0 + w]
        # flip_x/flip_y rays read the pixel principal point from the
        # opposite corner: cx' = w + x0 - cx, cy' = h + y0 - cy
        half = np.array([w, h], np.float64) * 0.5
        pp_px = np.array([w + x0 - cx, h + y0 - cy])
        fl_px = np.array([K[0, 0], K[1, 1]])
        c2w = _c2w4(poses[i]) @ GL_TO_P3D
        R = c2w[:3, :3].T
        T = -R @ c2w[:3, 3]
        im_path = f"{category}/{sequence}/images/frame{i:06d}.png"
        mk_path = f"{category}/{sequence}/masks/frame{i:06d}.png"
        write_png(os.path.join(root, im_path), to_u8(img))
        write_png(os.path.join(root, mk_path), to_u8(mask))
        annots.append({
            "sequence_name": sequence, "frame_number": i,
            "image": {"path": im_path, "size": [int(h), int(w)]},
            "mask": {"path": mk_path, "mass": 0.0 if i in empty_mass
                     else float(mask.sum())},
            "viewpoint": {"R": R.tolist(), "T": T.tolist(),
                          "focal_length": (fl_px / half).tolist(),
                          "principal_point": (1.0 - pp_px / half).tolist()},
        })
        (known if i in set(int(t) for t in train_ids) else unseen).append(
            [sequence, i, im_path])
    annot_path = os.path.join(root, category, "frame_annotations.jgz")
    with gzip.open(annot_path, "wt", encoding="utf8") as f:
        json.dump(annots, f)
    split_path = os.path.join(root, category, "set_lists.json")
    with open(split_path, "w") as f:
        json.dump({"train_known": known, "test_unseen": unseen}, f)
    return annot_path, split_path
