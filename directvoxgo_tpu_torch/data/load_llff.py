"""LLFF (forward-facing) dataset loader, in numpy.

Parses ``poses_bounds.npy``, rescales by ``bd_factor``, recenters the
poses, optionally spherifies them, and builds a spiral render path. The
downsampled image directories (``images_{factor}``, ``images_{W}x{H}``)
are made by an area resize (OpenCV's ``INTER_AREA`` and its uint8
rounding, :func:`.image_io.area_resize_u8`), under the directory names the
upstream loader's ImageMagick step uses, so either's cache serves the
other. Images, the raw ``images/*.JPG`` included, are read by
:func:`.image_io.read_image` (PNG or sequential JPEG), without ``imageio``.
"""

from __future__ import annotations

import os

import numpy as np

from .image_io import area_resize_u8, image_size, read_image, write_png

_IMG_EXTS = (".JPG", ".jpg", ".png", ".jpeg", ".PNG")


def _list_images(d):
    return [os.path.join(d, f) for f in sorted(os.listdir(d))
            if f.endswith(_IMG_EXTS)]


def _minify(basedir, factors=(), resolutions=()):
    """Create images_{factor} / images_{W}x{H} downsampled copies (area
    resize, 8-bit RGB PNGs)."""
    need = []
    for r in factors:
        if not os.path.exists(os.path.join(basedir, f"images_{r}")):
            need.append(("factor", r))
    for r in resolutions:
        if not os.path.exists(os.path.join(basedir,
                                           f"images_{r[1]}x{r[0]}")):
            need.append(("res", r))
    if not need:
        return
    files = _list_images(os.path.join(basedir, "images"))
    for kind, r in need:
        if kind == "factor":
            out_dir = os.path.join(basedir, f"images_{r}")
        else:
            out_dir = os.path.join(basedir, f"images_{r[1]}x{r[0]}")
        os.makedirs(out_dir, exist_ok=True)
        print("minifying to", out_dir)
        for f in files:
            im = read_image(f)
            im = im[..., :3] if im.ndim == 3 else im
            if kind == "factor":
                h, w = im.shape[0] // r, im.shape[1] // r
            else:
                h, w = r[0], r[1]
            out = area_resize_u8(im, h, w)
            name = os.path.splitext(os.path.basename(f))[0] + ".png"
            write_png(os.path.join(out_dir, name), out)


def _load_poses_images(basedir, factor=None, width=None, height=None,
                       load_depths=False):
    poses_arr = np.load(os.path.join(basedir, "poses_bounds.npy"))
    if poses_arr.shape[1] == 17:
        poses = poses_arr[:, :-2].reshape([-1, 3, 5]).transpose([1, 2, 0])
    elif poses_arr.shape[1] == 14:
        poses = poses_arr[:, :-2].reshape([-1, 3, 4]).transpose([1, 2, 0])
    else:
        raise NotImplementedError(poses_arr.shape)
    bds = poses_arr[:, -2:].transpose([1, 0])

    img0 = _list_images(os.path.join(basedir, "images"))[0]
    sh = image_size(img0)

    sfx = ""
    if height is not None and width is not None:
        _minify(basedir, resolutions=[[height, width]])
        sfx = f"_{width}x{height}"
    elif factor is not None and factor != 1:
        _minify(basedir, factors=[factor])
        sfx = f"_{factor}"
    elif height is not None:
        factor = sh[0] / float(height)
        width = int(sh[1] / factor)
        _minify(basedir, resolutions=[[height, width]])
        sfx = f"_{width}x{height}"
    elif width is not None:
        factor = sh[1] / float(width)
        height = int(sh[0] / factor)
        _minify(basedir, resolutions=[[height, width]])
        sfx = f"_{width}x{height}"
    else:
        factor = 1

    imgdir = os.path.join(basedir, "images" + sfx)
    assert os.path.exists(imgdir), f"{imgdir} does not exist"
    imgfiles = _list_images(imgdir)
    assert poses.shape[-1] == len(imgfiles), (
        f"Mismatch between imgs {len(imgfiles)} and poses {poses.shape[-1]}")

    sh = image_size(imgfiles[0])
    if poses.shape[1] == 4:
        poses = np.concatenate([poses, np.zeros_like(poses[:, [0]])], 1)
        poses[2, 4, :] = np.load(
            os.path.join(basedir, "hwf_cxcy.npy"))[2]
    poses[:2, 4, :] = np.array(sh[:2]).reshape([2, 1])
    poses[2, 4, :] = poses[2, 4, :] * 1.0 / factor

    imgs = np.stack([read_image(f)[..., :3] / 255.0
                     for f in imgfiles], -1)
    if not load_depths:
        return poses, bds, imgs, None
    raise NotImplementedError("colmap .geometric.bin depth loading")


def _normalize(x):
    return x / np.linalg.norm(x)


def _viewmatrix(z, up, pos):
    vec2 = _normalize(z)
    vec0 = _normalize(np.cross(up, vec2))
    vec1 = _normalize(np.cross(vec2, vec0))
    return np.stack([vec0, vec1, vec2, pos], 1)


def _poses_avg(poses):
    hwf = poses[0, :3, -1:]
    center = poses[:, :3, 3].mean(0)
    vec2 = _normalize(poses[:, :3, 2].sum(0))
    up = poses[:, :3, 1].sum(0)
    return np.concatenate([_viewmatrix(vec2, up, center), hwf], 1)


def _recenter_poses(poses):
    out = poses.copy()
    bottom = np.reshape([0, 0, 0, 1.0], [1, 4])
    c2w = _poses_avg(poses)
    c2w = np.concatenate([c2w[:3, :4], bottom], -2)
    bottom_n = np.tile(bottom[None], [poses.shape[0], 1, 1])
    hom = np.concatenate([poses[:, :3, :4], bottom_n], -2)
    out[:, :3, :4] = (np.linalg.inv(c2w) @ hom)[:, :3, :4]
    return out


def _render_path_spiral(c2w, up, rads, focal, zrate, rots, N):
    render_poses = []
    rads = np.array(list(rads) + [1.0])
    hwf = c2w[:, 4:5]
    for theta in np.linspace(0.0, 2.0 * np.pi * rots, N + 1)[:-1]:
        c = c2w[:3, :4] @ (np.array([
            np.cos(theta), -np.sin(theta), -np.sin(theta * zrate), 1.0])
            * rads)
        z = _normalize(c - c2w[:3, :4] @ np.array([0, 0, -focal, 1.0]))
        render_poses.append(
            np.concatenate([_viewmatrix(z, up, c), hwf], 1))
    return np.stack(render_poses, 0)


def _spherify_poses(poses, bds):
    def to44(p):
        bottom = np.tile(np.eye(4)[-1].reshape(1, 1, 4), [p.shape[0], 1, 1])
        return np.concatenate([p, bottom], 1)

    rays_d = poses[:, :3, 2:3]
    rays_o = poses[:, :3, 3:4]
    a_i = np.eye(3) - rays_d * np.transpose(rays_d, [0, 2, 1])
    b_i = -a_i @ rays_o
    pt_mindist = np.squeeze(
        -np.linalg.inv((np.transpose(a_i, [0, 2, 1]) @ a_i).mean(0))
        @ b_i.mean(0))

    center = pt_mindist
    up = (poses[:, :3, 3] - center).mean(0)
    vec0 = _normalize(up)
    vec1 = _normalize(np.cross([0.1, 0.2, 0.3], vec0))
    vec2 = _normalize(np.cross(vec0, vec1))
    c2w = np.stack([vec1, vec2, vec0, center], 1)

    poses_reset = np.linalg.inv(to44(c2w[None])) @ to44(poses[:, :3, :4])
    rad = np.sqrt(np.mean(np.sum(np.square(poses_reset[:, :3, 3]), -1)))
    sc = 1.0 / rad
    poses_reset[:, :3, 3] *= sc
    bds = bds * sc
    rad *= sc

    centroid = np.mean(poses_reset[:, :3, 3], 0)
    zh = centroid[2]
    radcircle = np.sqrt(rad ** 2 - zh ** 2)
    new_poses = []
    for th in np.linspace(0.0, 2.0 * np.pi, 120):
        camorigin = np.array([radcircle * np.cos(th),
                              radcircle * np.sin(th), zh])
        up_v = np.array([0, 0, -1.0])
        vec2 = _normalize(camorigin)
        vec0 = _normalize(np.cross(vec2, up_v))
        vec1 = _normalize(np.cross(vec2, vec0))
        new_poses.append(np.stack([vec0, vec1, vec2, camorigin], 1))
    new_poses = np.stack(new_poses, 0)
    new_poses = np.concatenate([
        new_poses,
        np.broadcast_to(poses[0, :3, -1:], new_poses[:, :3, -1:].shape)], -1)
    poses_reset = np.concatenate([
        poses_reset[:, :3, :4],
        np.broadcast_to(poses[0, :3, -1:],
                        poses_reset[:, :3, -1:].shape)], -1)
    return poses_reset, new_poses, bds


def load_llff_data(basedir, factor=8, width=None, height=None, recenter=True,
                   bd_factor=0.75, spherify=False, path_zflat=False,
                   load_depths=False):
    poses, bds, imgs, depths = _load_poses_images(
        basedir, factor=factor, width=width, height=height,
        load_depths=load_depths)
    print("Loaded", basedir, bds.min(), bds.max())

    # LLFF [down right back] -> NeRF [right up back] axis fix, move the
    # image axis to the front.
    poses = np.concatenate(
        [poses[:, 1:2, :], -poses[:, 0:1, :], poses[:, 2:, :]], 1)
    poses = np.moveaxis(poses, -1, 0).astype(np.float32)
    images = np.moveaxis(imgs, -1, 0).astype(np.float32)
    bds = np.moveaxis(bds, -1, 0).astype(np.float32)

    sc = 1.0 if bd_factor is None else 1.0 / (bds.min() * bd_factor)
    poses[:, :3, 3] *= sc
    bds *= sc

    if recenter:
        poses = _recenter_poses(poses)

    if spherify:
        poses, render_poses, bds = _spherify_poses(poses, bds)
    else:
        c2w = _poses_avg(poses)
        up = _normalize(poses[:, :3, 1].sum(0))
        close_depth, inf_depth = bds.min() * 0.9, bds.max() * 5.0
        dt = 0.75
        focal = 1.0 / ((1.0 - dt) / close_depth + dt / inf_depth)
        tt = poses[:, :3, 3]
        rads = np.percentile(np.abs(tt), 90, 0)
        c2w_path = c2w
        n_views, n_rots = 120, 2
        if path_zflat:
            zloc = -close_depth * 0.1
            c2w_path[:3, 3] = c2w_path[:3, 3] + zloc * c2w_path[:3, 2]
            rads[2] = 0.0
            n_rots, n_views = 1, n_views // 2
        render_poses = _render_path_spiral(
            c2w_path, up, rads, focal, zrate=0.5, rots=n_rots, N=n_views)

    c2w = _poses_avg(poses)
    dists = np.sum(np.square(c2w[:3, 3] - poses[:, :3, 3]), -1)
    i_test = int(np.argmin(dists))
    print("HOLDOUT view is", i_test)
    return (images.astype(np.float32), depths, poses.astype(np.float32),
            bds, np.asarray(render_poses, np.float32), i_test)
