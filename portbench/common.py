"""What both traffic drivers share: the program's model built on the
benchmark's state, the reference's rays for the pixels a run served, and
the comparisons that decide ``correct``."""

from __future__ import annotations

import gc
import importlib

import numpy as np
import torch

from . import inputs


def program_config(cfg, data):
    """The program's config object for a configuration."""
    from directvoxgo_tpu_torch.config import Config
    return Config({
        "data": {"ndc": data["ndc"], "white_bkgd": data["white_bkgd"],
                 "inverse_y": False, "flip_x": False, "flip_y": False},
        "fine_model_and_render": dict(cfg["fine_model_and_render"]),
        "fine_train": dict(cfg["fine_train"]),
    })


def build_model(cfg, geo, state, device):
    """The program's model at the configuration's top grid, holding the
    benchmark's initial ``state``."""
    if cfg["model"] == "mpi":
        from directvoxgo_tpu_torch.models.dmpigo import DirectMPIGO as cls
    else:
        from directvoxgo_tpu_torch.models.dvgo import DirectVoxGO as cls
    kw = dict(cfg["fine_model_and_render"])
    model = cls(xyz_min=geo["xyz_min"], xyz_max=geo["xyz_max"],
                device=device, **kw)
    if tuple(int(x) for x in model.world_size) != tuple(geo["world_size"]):
        raise RuntimeError(f"the program's grid {model.world_size} is not "
                           f"the configuration's {geo['world_size']}")
    load_state(model, state)
    return model


@torch.no_grad()
def load_state(model, state):
    model.density.copy_(state["density"])
    model.k0.copy_(state["k0"])
    model.mask.copy_(state["mask"])
    for layer, (w, b) in zip(model.rgbnet.layers, state["mlp"]):
        layer.weight.copy_(w)
        layer.bias.copy_(b)


def render_kwargs(cfg, data):
    return {"near": float(data["near"]), "far": float(data["far"]),
            "bg": 1.0 if data["white_bkgd"] else 0.0,
            "stepsize": float(cfg["fine_model_and_render"]["stepsize"]),
            "inverse_y": False, "flip_x": False, "flip_y": False}


def reference_module(cfg):
    return importlib.import_module(f"portbench.reference.{cfg['reference']}")


def free_cuda():
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def to_params(host, device, dtype=torch.float32):
    """Reference parameters (fresh tensors) of a host state."""
    return {"density": host["density"].to(device, dtype).clone(),
            "k0": host["k0"].to(device, dtype).clone(),
            "mask": host["mask"].to(device).clone(),
            "mlp": [(w.to(device, dtype).clone(), b.to(device, dtype).clone())
                    for w, b in host["mlp"]]}


# ------------------------------------------------------------ the pixels


def pixel_of_pool(cfg, data, pool_o, pool_d, idx):
    """(views, rows, cols) of the training pixels behind pool entries
    ``idx``: by position for the ``flatten`` sampler (the train views'
    pixels in order), else from each ray (its origin is its camera's
    centre, its direction its pixel's)."""
    H, W = data["H"], data["W"]
    idx = np.asarray(idx).reshape(-1)
    if cfg["fine_train"]["ray_sampler"] == "flatten":
        views = data["i_train"][idx // (H * W)]
        pix = idx % (H * W)
        return views, pix // W, pix % W
    ro, rd = pool_o[idx].astype(np.float64), pool_d[idx].astype(np.float64)
    cams = data["poses"][data["i_train"], :, 3].astype(np.float64)
    views = data["i_train"][np.argmin(
        ((ro[:, None, :] - cams[None]) ** 2).sum(-1), 1)]
    rot = data["poses"][views, :, :3].astype(np.float64)
    dirs = np.einsum("nji,nj->ni", rot, rd)          # R^T d
    K = data["K"].astype(np.float64)
    cols = np.rint(dirs[:, 0] / -dirs[:, 2] * K[0, 0] + K[0, 2] - 0.5)
    rows = np.rint(-dirs[:, 1] / -dirs[:, 2] * K[1, 1] + K[1, 2] - 0.5)
    return views, rows.astype(np.int64), cols.astype(np.int64)


def rays_of_pixels(data, views, rows, cols):
    """The benchmark's own rays (origins, directions, view directions) of
    the given pixels, f32 [n, 3] each."""
    K = data["K"]
    i = cols.astype(np.float32) + 0.5
    j = rows.astype(np.float32) + 0.5
    dirs = np.stack([(i - K[0][2]) / K[0][0], -(j - K[1][2]) / K[1][1],
                     -np.ones_like(i)], -1)
    c2w = data["poses"][views]
    rays_d = np.einsum("nij,nj->ni", c2w[:, :3, :3], dirs).astype(np.float32)
    rays_o = c2w[:, :3, 3].astype(np.float32)
    viewdirs = rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)
    if data["ndc"]:
        rays_o, rays_d = inputs.ndc_rays_np(np.int64(data["H"]),
                                            np.int64(data["W"]), K[0][0],
                                            1.0, rays_o, rays_d)
    return (rays_o.astype(np.float32), rays_d.astype(np.float32),
            viewdirs.astype(np.float32))


# ----------------------------------------------------------- comparisons


def norm_gap(prog, ref, rule=None):
    """The widest gap between the program's norm and the reference's, by
    leaf, as a share of the larger of that leaf's reference norm and the
    median leaf's; ``rule`` (bools by leaf) keeps some leaves only."""
    pn = np.array([float(torch.linalg.vector_norm(x.double())) for x in prog])
    rn = np.array([float(torch.linalg.vector_norm(x.double())) for x in ref])
    keep = np.ones(len(rn), bool) if rule is None else np.asarray(rule)
    med = float(np.median(rn[keep]))
    den = np.maximum(rn, med)
    gaps = np.abs(pn - rn) / np.where(den > 0, den, 1.0)
    return float(np.max(gaps[keep])), pn, rn


def diff_norm(prog, ref):
    """The widest norm of the program's leaf less the reference's, as a
    share of the larger of that leaf's reference norm and the median
    leaf's."""
    dn = np.array([float(torch.linalg.vector_norm((x - y).double()))
                   for x, y in zip(prog, ref)])
    rn = np.array([float(torch.linalg.vector_norm(y.double())) for y in ref])
    den = np.maximum(rn, float(np.median(rn)))
    return float(np.max(dn / np.where(den > 0, den, 1.0)))


def check(name, value, limits):
    """One compared number: its name, value, limit and whether it passed
    (a number that is not finite fails)."""
    lim = float(limits[name])
    return {"name": name, "value": float(value), "limit": lim,
            "passed": bool(np.isfinite(value) and value <= lim)}
