"""Voxel-grid helpers: occupancy bbox, nearest occupancy lookup, bilinear
plane sampling and the 3x3x3 max pool. Grids are channels-last
``[X, Y, Z(, C)]`` with align-corners coordinates (``xyz_min`` -> index 0,
``xyz_max`` -> index ``dim-1``)."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def mask_bbox_vox(mask):
    """Inclusive voxel bbox (lo, hi) of a boolean mask, padded by one voxel
    per side; the full grid when the mask is empty. float64 numpy [3] each."""
    m = mask.detach().cpu().numpy() if torch.is_tensor(mask) \
        else np.asarray(mask)
    if not m.any():
        return np.zeros(3), np.asarray(m.shape, np.float64) - 1.0
    lo, hi = [], []
    for a in range(3):
        axes = tuple(x for x in range(3) if x != a)
        nz = np.flatnonzero(m.any(axis=axes))
        lo.append(max(nz[0] - 1.0, 0.0))
        hi.append(min(nz[-1] + 1.0, m.shape[a] - 1.0))
    return np.asarray(lo), np.asarray(hi)


def occupancy_lookup_parts(mask, x, y, z, xyz_min, xyz_max):
    """Nearest-voxel occupancy at world coords (x, y, z) (broadcastable
    tensors); out-of-bounds points are False. Bounds are python floats."""
    nx, ny, nz = mask.shape
    comps = []
    inb = None
    for v, lo, hi, n in zip((x, y, z), xyz_min, xyz_max, (nx, ny, nz)):
        s = (n - 1.0) / (float(hi) - float(lo))
        idx = torch.round((v - float(lo)) * s)
        ok = (idx >= 0) & (idx <= n - 1)
        inb = ok if inb is None else (inb & ok)
        comps.append(torch.clamp(idx, 0, n - 1).to(torch.int64))
    xi, yi, zi = comps
    lin = (xi * ny + yi) * nz + zi
    return mask.reshape(-1)[lin] & inb


def bilinear_sample_parts(plane, iu, iv):
    """Bilinear interpolation of a ``[U, V(, C)]`` plane at continuous
    coordinates (iu, iv), clamped to the plane's edge."""
    squeeze = plane.dim() == 2
    if squeeze:
        plane = plane[..., None]
    nu, nv, nc = plane.shape
    flat = plane.reshape(nu * nv, nc)
    iu = torch.clamp(iu, 0.0, nu - 1.0)
    iv = torch.clamp(iv, 0.0, nv - 1.0)
    u0 = torch.clamp(torch.floor(iu).to(torch.int64), 0, max(nu - 2, 0))
    v0 = torch.clamp(torch.floor(iv).to(torch.int64), 0, max(nv - 2, 0))
    fu, fv = iu - u0, iv - v0
    u1 = torch.clamp(u0 + 1, max=nu - 1)
    v1 = torch.clamp(v0 + 1, max=nv - 1)
    fu, fv = fu[..., None], fv[..., None]

    def g(a, b):
        return flat[a * nv + b]

    c0 = g(u0, v0) * (1 - fv) + g(u0, v1) * fv
    c1 = g(u1, v0) * (1 - fv) + g(u1, v1) * fv
    out = c0 * (1 - fu) + c1 * fu
    return out[..., 0] if squeeze else out


def max_pool3d_same(x):
    """3x3x3 max pool, stride 1, 'same' padding on an ``[X, Y, Z]`` grid."""
    return F.max_pool3d(x[None, None], kernel_size=3, stride=1,
                        padding=1)[0, 0]
