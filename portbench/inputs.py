"""The inputs the benchmark makes and hands alike to the program and to the
plain reference: the fixture's images and cameras, the model's geometry,
and its initial state from ``--seed``.

The camera and teacher arithmetic are frozen copies of the fixture code in
``directvoxgo_tpu_torch/data/synthetic.py`` and ``load_blender.py``
(``portbench/tests`` holds them equal to the port's); the images come from
the repository's ``fixture_cache/*.npz``, read with numpy. Nothing here
imports the program.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def np_seed(seed):
    """A seed numpy's generators take (any whole number, negatives too)."""
    return int(seed) % (2 ** 64)


def torch_seed(seed):
    return int(seed) % (2 ** 63)


# ----------------------------------------------------------------- cameras


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
    c2w = _translate_z(radius)
    c2w = _rotate_phi(phi / 180.0 * np.pi) @ c2w
    c2w = _rotate_theta(theta / 180.0 * np.pi) @ c2w
    flip = np.array([[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]],
                    dtype=np.float32)
    return flip @ c2w


def synthetic_cameras(n_train, n_val, n_test, H, W, seed=0):
    """(poses [n, 3, 4], K) of the inward fixture: an orbit at radius 4."""
    rng = np.random.default_rng(seed)
    focal = 0.8 * W
    K = np.array([[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]],
                 np.float32)
    n_total = n_train + n_val + n_test
    thetas = np.linspace(-180, 180, n_total, endpoint=False) \
        + rng.uniform(-2, 2, n_total)
    phis = -30.0 + 12.0 * np.sin(np.linspace(0, 3 * np.pi, n_total)) \
        + rng.uniform(-2, 2, n_total)
    poses = np.stack([pose_spherical(t, p, 4.0)
                      for t, p in zip(thetas, phis)], 0)
    return poses[:, :3, :4].astype(np.float32), K


def ndc_cameras(n_train, n_val, n_test, H, W, seed=0):
    """(poses [n, 3, 4], K) of the forward-facing fixture: cameras near
    z = 0 looking down -z."""
    rng = np.random.default_rng(seed)
    focal = 0.8 * W
    K = np.array([[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]],
                 np.float32)
    poses = []
    for _ in range(n_train + n_val + n_test):
        c2w = np.eye(4, dtype=np.float32)
        c2w[0, 3] = rng.uniform(-0.25, 0.25)
        c2w[1, 3] = rng.uniform(-0.25, 0.25)
        c2w[2, 3] = rng.uniform(-0.05, 0.05)
        poses.append(c2w)
    return np.stack(poses, 0)[:, :3, :4].astype(np.float32), K


def fixture(cfg):
    """The data of a configuration's fixture: images (f32 [n, H, W, 3]),
    poses, K, (H, W), near, far and the split indices."""
    fx = cfg["fixture"]
    n_tr, n_va, n_te = fx["n_train"], fx["n_val"], fx["n_test"]
    H, W = fx["H"], fx["W"]
    make = {"synthetic": synthetic_cameras, "ndc": ndc_cameras}[fx["kind"]]
    poses, K = make(n_tr, n_va, n_te, H, W, fx.get("seed", 0))
    with np.load(os.path.join(ROOT, "fixture_cache", fx["file"])) as z:
        images = z["images"].astype(np.float32)
    if images.shape != (n_tr + n_va + n_te, H, W, 3):
        raise ValueError(f"{fx['file']}: images {images.shape}")
    idx = np.arange(n_tr + n_va + n_te)
    near, far = (0.0, 1.0) if fx["kind"] == "ndc" else (2.0, 6.0)
    return {"images": images, "poses": poses, "K": K, "H": H, "W": W,
            "near": near, "far": far, "i_train": idx[:n_tr],
            "i_test": idx[n_tr + n_va:], "ndc": fx["kind"] == "ndc",
            "white_bkgd": bool(cfg["data"]["white_bkgd"])}


# ----------------------------------------------------------------- teacher


def teacher_grids(resolution=64, variant="blobs"):
    """Analytic density/rgb voxel grids of the fixture scene on [-1, 1]^3
    ("blobs": three broad gaussian blobs; "lego": seven compact sharp
    primitives)."""
    lin = np.linspace(-1.0, 1.0, resolution, dtype=np.float32)
    x, y, z = np.meshgrid(lin, lin, lin, indexing="ij")
    density = np.full_like(x, -6.0)
    if variant == "lego":
        blobs = [
            ((0.30, 0.10, -0.15), 0.20, 14.0, (0.9, 0.75, 0.2)),
            ((-0.28, 0.18, -0.05), 0.17, 14.0, (0.75, 0.2, 0.15)),
            ((0.05, -0.30, 0.10), 0.19, 14.0, (0.2, 0.55, 0.85)),
            ((0.02, 0.25, 0.28), 0.14, 14.0, (0.3, 0.8, 0.3)),
            ((-0.20, -0.22, -0.30), 0.15, 14.0, (0.85, 0.4, 0.1)),
            ((0.33, -0.12, 0.30), 0.12, 14.0, (0.6, 0.6, 0.65)),
            ((-0.05, 0.02, -0.02), 0.22, 14.0, (0.5, 0.5, 0.2)),
        ]
        sharp = 6.0
    else:
        blobs = [
            ((0.35, 0.0, 0.0), 0.35, 9.0, (0.9, 0.2, 0.2)),
            ((-0.3, 0.25, 0.1), 0.28, 9.0, (0.2, 0.8, 0.3)),
            ((0.0, -0.3, -0.25), 0.30, 9.0, (0.25, 0.35, 0.95)),
        ]
        sharp = 2.0
    rgb_num = np.zeros((*x.shape, 3), np.float32)
    w_sum = np.zeros_like(x)
    for (cx, cy, cz), r, peak, color in blobs:
        d2 = (x - cx) ** 2 + (y - cy) ** 2 + (z - cz) ** 2
        if sharp == 2.0:
            w = np.exp(-d2 / (2 * (r / 2) ** 2)).astype(np.float32)
        else:
            w = np.exp(-(d2 / (r / 2) ** 2) ** (sharp / 2)
                       / 2).astype(np.float32)
        density = np.maximum(density, peak * w - 6.0)
        rgb_num += w[..., None] * np.asarray(color, np.float32)
        w_sum += w
    rgb = rgb_num / np.maximum(w_sum[..., None], 1e-6)
    return density, rgb


def sample_teacher(density, pts, box_min, box_max, background=-6.0):
    """Trilinear (align-corners) samples of the teacher ``density [R, R,
    R]`` (a tensor) placed in the box at world points ``pts [..., 3]``;
    ``background`` outside the box."""
    lo = torch.as_tensor(np.asarray(box_min, np.float32), device=pts.device)
    hi = torch.as_tensor(np.asarray(box_max, np.float32), device=pts.device)
    nrm = (pts - lo) / (hi - lo) * 2.0 - 1.0          # [-1, 1] per axis
    inside = ((nrm >= -1.0) & (nrm <= 1.0)).all(-1)
    shape = pts.shape[:-1]
    grid = nrm.reshape(1, -1, 1, 1, 3)[..., [2, 1, 0]]
    out = F.grid_sample(density[None, None], grid, mode="bilinear",
                        padding_mode="border", align_corners=True)
    out = out.reshape(shape)
    return torch.where(inside, out, torch.full_like(out, background))


# ---------------------------------------------------------------- geometry


def act_shift(alpha_init):
    return float(np.log(1.0 / (1.0 - alpha_init) - 1.0))


def dvgo_world_size(xyz_min, xyz_max, num_voxels, quantum):
    """(world_size, voxel_size) as DirectVoxGO sets its grid resolution."""
    xyz_min = np.asarray(xyz_min, np.float32)
    xyz_max = np.asarray(xyz_max, np.float32)
    voxel_size = float(((xyz_max - xyz_min).prod() / num_voxels) ** (1 / 3))
    q = max(int(quantum), 1)
    ws = tuple(q * round(int(v) / q) if q > 1 and int(v) >= 64 else int(v)
               for v in (xyz_max - xyz_min) / voxel_size)
    return ws, voxel_size


def mpi_world_size(xyz_min, xyz_max, num_voxels, mpi_depth):
    """(world_size, xy voxel size) as DirectMPIGO sets its grid."""
    extent = (np.asarray(xyz_max, np.float32)
              - np.asarray(xyz_min, np.float32))
    r = float(np.sqrt(num_voxels / mpi_depth / (extent[0] * extent[1])))
    return (int(extent[0] * r), int(extent[1] * r), int(mpi_depth)), 1.0 / r


def ndc_rays_np(H, W, focal, near, rays_o, rays_d):
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d
    o0 = -1.0 / (W / (2.0 * focal)) * rays_o[..., 0] / rays_o[..., 2]
    o1 = -1.0 / (H / (2.0 * focal)) * rays_o[..., 1] / rays_o[..., 2]
    o2 = 1.0 + 2.0 * near / rays_o[..., 2]
    d0 = -1.0 / (W / (2.0 * focal)) * (
        rays_d[..., 0] / rays_d[..., 2] - rays_o[..., 0] / rays_o[..., 2])
    d1 = -1.0 / (H / (2.0 * focal)) * (
        rays_d[..., 1] / rays_d[..., 2] - rays_o[..., 1] / rays_o[..., 2])
    d2 = -2.0 * near / rays_o[..., 2]
    return np.stack([o0, o1, o2], -1), np.stack([d0, d1, d2], -1)


def pixel_rays_np(H, W, K, c2w, ndc, border=False):
    """(rays_o, rays_d, viewdirs) of every pixel centre, f32 [H, W, 3];
    with ``border`` only the image's four edges, f32 [2 (H + W), 3] (a
    row of the grid's arithmetic each). ``H`` and ``W`` enter the NDC
    arithmetic as numpy integers, as the program's pools take them from
    its ``HW`` array."""
    H, W = np.int64(H), np.int64(W)
    c2w = np.asarray(c2w, np.float32)
    K = np.asarray(K, np.float32)
    j, i = np.meshgrid(np.arange(H, dtype=np.float32),
                       np.arange(W, dtype=np.float32), indexing="ij")
    if border:
        i = np.concatenate([i[0], i[-1], i[:, 0], i[:, -1]])[None]
        j = np.concatenate([j[0], j[-1], j[:, 0], j[:, -1]])[None]
    i, j = i + 0.5, j + 0.5
    dirs = np.stack([(i - K[0][2]) / K[0][0], -(j - K[1][2]) / K[1][1],
                     -np.ones_like(i)], -1)
    rays_d = dirs @ c2w[:3, :3].T
    rays_o = np.broadcast_to(c2w[:3, 3], rays_d.shape).copy()
    viewdirs = rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)
    if ndc:
        rays_o, rays_d = ndc_rays_np(H, W, K[0][0], 1.0, rays_o, rays_d)
    out = (rays_o, rays_d, viewdirs)
    if border:
        out = tuple(x[0] for x in out)
    return tuple(x.astype(np.float32) for x in out)


def frustum_bbox(data):
    """The train views' frustum at near and far, as a run's first stage
    boxes its grid (the program's ``compute_bbox_by_cam_frustrm``). In NDC
    space a view's rays are the image of a pyramid under a projective map,
    whose extremes lie on the image's border, so only the border's rays
    are made; elsewhere (points along the unit view direction) all."""
    lo = np.full(3, np.inf, np.float32)
    hi = -lo
    ndc = data["ndc"]
    for v in data["i_train"]:
        ro, rd, vd = pixel_rays_np(data["H"], data["W"], data["K"],
                                   data["poses"][v], ndc, border=ndc)
        d = rd if ndc else vd
        pts = np.stack([ro + d * data["near"], ro + d * data["far"]])
        axes = tuple(range(pts.ndim - 1))
        lo = np.minimum(lo, pts.min(axis=axes))
        hi = np.maximum(hi, pts.max(axis=axes))
    return lo, hi


def coarse_grid(cfg, data):
    """The coarse stage's grid as a lego run leaves it: the frustum box,
    the world size at the coarse stage's ``num_voxels``, and, standing for
    the trained coarse density, the fixture's teacher at its voxels (a
    tensor on the CPU). A dict with ``xyz_min``, ``xyz_max``,
    ``world_size`` and ``density``."""
    c = cfg["coarse_model_and_render"]
    fx = cfg["fixture"]
    lo, hi = frustum_bbox(data)
    ws, _ = dvgo_world_size(lo, hi, c["num_voxels"],
                            c.get("world_size_quantum", 1))
    dens, _ = teacher_grids(fx["teacher_res"], fx["variant"])
    pts = grid_points({"xyz_min": lo, "xyz_max": hi, "world_size": ws},
                      torch.device("cpu"))
    density = sample_teacher(torch.as_tensor(dens), pts, [-1.0] * 3,
                             [1.0] * 3).contiguous()
    return {"xyz_min": lo, "xyz_max": hi, "world_size": ws,
            "density": density}


def coarse_mask_on(geo, pts):
    """The coarse geometry's occupancy (the fine stage's ``mask_cache``:
    ``alpha(maxpool3(coarse density)) >= mask_cache_thres``) looked up at
    the nearest coarse voxel of world points ``pts [..., 3]`` (False
    outside the coarse box)."""
    c = geo["coarse"]
    dens = c["density"].to(pts.device)
    alpha = -torch.expm1(-F.softplus(
        F.max_pool3d(dens[None, None], 3, 1, 1)[0, 0] + geo["act_shift"]))
    occ = alpha >= geo["mask_cache_thres"]
    idx, inb = [], None
    for a in range(3):
        n = c["world_size"][a]
        lo, hi = float(c["xyz_min"][a]), float(c["xyz_max"][a])
        k = torch.round((pts[..., a] - lo) * ((n - 1.0) / (hi - lo)))
        ok = (k >= 0) & (k <= n - 1)
        inb = ok if inb is None else inb & ok
        idx.append(torch.clamp(k, 0, n - 1).long())
    return occ[idx[0], idx[1], idx[2]] & inb


def geometry(cfg, data):
    """The model's box, grid and activation constants, worked out from the
    configuration and the fixture's cameras: a dict with ``xyz_min``, ``xyz_max``,
    ``world_size``, ``voxel_size``, ``voxel_size_base``, ``act_shift``,
    ``voxel_size_ratio`` and ``kind`` ("dvgo" or "mpi")."""
    m = cfg["fine_model_and_render"]
    fx = cfg["fixture"]
    if cfg["model"] == "mpi":
        lo, hi = frustum_bbox(data)
        ws, vs = mpi_world_size(lo, hi, m["num_voxels"], m["mpi_depth"])
        return {"kind": "mpi", "xyz_min": lo, "xyz_max": hi,
                "world_size": ws, "voxel_size": vs, "act_shift": 0.0,
                "voxel_size_ratio": 256.0 / m["mpi_depth"],
                "voxel_size_base": None}
    # The fine box as the stage takes it from the coarse geometry
    # (``compute_bbox_by_coarse_geo``: the coarse voxels whose alpha
    # passes ``bbox_thres``), then the fine stage's world_bound_scale. The
    # teacher's alpha is read at the fine model's activation throughout.
    coarse = coarse_grid(cfg, data)
    shift = act_shift(m["alpha_init"])
    alpha = -torch.expm1(-F.softplus(coarse["density"] + shift))
    pts = grid_points(coarse, torch.device("cpu"))[alpha > m["bbox_thres"]]
    lo, hi = pts.min(0).values.numpy(), pts.max(0).values.numpy()
    shift_box = (hi - lo) * (m["world_bound_scale"] - 1) / 2
    lo = (lo - shift_box).astype(np.float32)
    hi = (hi + shift_box).astype(np.float32)
    ws, vs = dvgo_world_size(lo, hi, m["num_voxels"],
                             m.get("world_size_quantum", 1))
    vs_base = float(((hi - lo).prod() / m["num_voxels_base"]) ** (1 / 3))
    return {"kind": "dvgo", "xyz_min": lo, "xyz_max": hi, "world_size": ws,
            "voxel_size": vs, "voxel_size_base": vs_base,
            "act_shift": shift, "voxel_size_ratio": vs / vs_base,
            "coarse": coarse, "mask_cache_thres": m["mask_cache_thres"]}


def grid_points(geo, device):
    """[X, Y, Z, 3] coordinates of every voxel (align-corners)."""
    axes = [torch.linspace(float(geo["xyz_min"][a]), float(geo["xyz_max"][a]),
                           geo["world_size"][a], device=device)
            for a in range(3)]
    return torch.stack(torch.meshgrid(*axes, indexing="ij"), -1)


def ndc_to_world(pts, H, W, focal):
    """World points of NDC points (near plane 1, the fixture's frame)."""
    z = 2.0 / (pts[..., 2] - 1.0)
    x = -pts[..., 0] * z * (W / (2.0 * focal))
    y = -pts[..., 1] * z * (H / (2.0 * focal))
    return torch.stack([x, y, z], -1)


# ------------------------------------------------------------ initial state


def mlp_dims(cfg):
    m = cfg["fine_model_and_render"]
    k0 = m["rgbnet_dim"]
    if cfg["model"] == "mpi":
        dim0 = 3 + 3 * m.get("viewbase_pe", 0) * 2 + k0
    else:
        dim0 = 3 + 3 * m.get("viewbase_pe", 4) * 2 + k0
    width, depth = m["rgbnet_width"], m["rgbnet_depth"]
    return [dim0] + [width] * (depth - 1) + [3]


@torch.no_grad()
def initial_state(cfg, geo, seed, device):
    """The model's initial state from the seed: density from the fixture's
    teacher resized to the grid, k0 normal, the colour MLP uniform in
    +-1/sqrt(fan_in) (last bias zero) from a generator on ``device``, and
    the occupancy mask: DirectMPIGO's ``maxpool(alpha) >=
    mask_cache_thres``, DirectVoxGO's from the coarse geometry as its fine
    stage sets it (with ``pool_mask``, the one its ray pool is drawn
    through). A dict of tensors on ``device``: ``density``, ``k0``,
    ``mask``, ``mlp`` (a list of (weight [out, in], bias)) and, for
    DirectVoxGO, ``pool_mask``."""
    m = cfg["fine_model_and_render"]
    fx = cfg["fixture"]
    pts = grid_points(geo, device)
    if geo["kind"] == "mpi":
        dens, _ = teacher_grids(fx["teacher_res"], "blobs")
        world = ndc_to_world(pts, fx["H"], fx["W"], 0.8 * fx["W"])
        box = ([-1.2, -1.2, -3.4], [1.2, 1.2, -1.0])
    else:
        dens, _ = teacher_grids(fx["teacher_res"], fx["variant"])
        world, box = pts, ([-1.0] * 3, [1.0] * 3)
    density = sample_teacher(torch.as_tensor(dens, device=device), world,
                             *box).contiguous()
    del pts, world
    gen = torch.Generator(device=device)
    gen.manual_seed(torch_seed(seed))
    k0 = torch.randn((*geo["world_size"], m["rgbnet_dim"]), generator=gen,
                     device=device)
    dims = mlp_dims(cfg)
    mlp = []
    for i in range(len(dims) - 1):
        bound = 1.0 / float(np.sqrt(dims[i]))
        w = (torch.rand((dims[i + 1], dims[i]), generator=gen,
                        device=device) * 2 - 1) * bound
        b = (torch.rand((dims[i + 1],), generator=gen, device=device)
             * 2 - 1) * bound
        if i == len(dims) - 2:
            b.zero_()
        mlp.append((w, b))
    alpha = -torch.expm1(-F.softplus(density + geo["act_shift"])
                         * geo["voxel_size_ratio"])
    pooled = F.max_pool3d(alpha[None, None], 3, 1, 1)[0, 0]
    if geo["kind"] == "mpi":
        return {"density": density, "k0": k0, "mlp": mlp,
                "mask": pooled >= m["mask_cache_thres"]}
    # the fine stage's masks: the coarse geometry's at the grid's voxels
    # (what its ray pool is drawn through) and, after a pg_scale event,
    # that and ``maxpool(alpha) > fast_color_thres``
    coarse = coarse_mask_on(geo, grid_points(geo, device))
    return {"density": density, "k0": k0, "mlp": mlp, "pool_mask": coarse,
            "mask": coarse & (pooled > m["fast_color_thres"])}


def state_to_host(state):
    """A copy of ``state`` in host memory."""
    def host(x):
        return x.detach().to("cpu", copy=True)
    return {"density": host(state["density"]), "k0": host(state["k0"]),
            "mask": host(state["mask"]),
            "mlp": [(host(w), host(b)) for w, b in state["mlp"]]}
