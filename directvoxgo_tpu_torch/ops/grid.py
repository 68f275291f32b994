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


class DeviceBox:
    """A box of ``sizes`` voxels (xyz) of a grid of ``dims`` (xyz) whose
    start voxel is device data: ``off``, an integer tensor [3] holding the
    start along the axes ``perm`` (``off[i]`` along axis ``perm[i]``; the
    sweep's permuted order, or xyz). Reads and writes go through the box's
    flat element indices, made on the device from ``off``, so that a step
    captured as a CUDA graph takes the offsets of each replay, not those of
    its capture. :meth:`take` is differentiable (its gradient is the
    full-size scatter of the box's).

    The indices address single elements, one per voxel and channel, made
    once per channel count: on the card a gather of whole voxel rows of 12
    floats ran several times slower than the element-wise one, and
    indexing with three broadcast ``off + arange`` vectors per axis
    (``t[ix, iy, iz]``, ``index_put_``) slower too (PERF.md,
    ``tools/trace_step.py``)."""

    def __init__(self, off, sizes, dims, perm=(0, 1, 2)):
        self.sizes = tuple(int(s) for s in sizes)
        self.dims = tuple(int(d) for d in dims)
        o = off.to(torch.int64)
        strides = (self.dims[1] * self.dims[2], self.dims[2], 1)
        parts = [(torch.arange(self.sizes[a], device=off.device)
                  + o[list(perm).index(a)]) * strides[a] for a in range(3)]
        self.idx = (parts[0][:, None, None] + parts[1][None, :, None]
                    + parts[2][None, None, :]).reshape(-1)
        self._by_channels = {1: self.idx}

    def _index(self, t):
        """The box's flat element indices in ``t`` ([X, Y, Z(, C)])."""
        c = t.numel() // (self.dims[0] * self.dims[1] * self.dims[2])
        if c not in self._by_channels:
            self._by_channels[c] = (self.idx[:, None] * c + torch.arange(
                c, device=self.idx.device)).reshape(-1)
        return self._by_channels[c]

    def take(self, t):
        """The box of ``t`` ([X, Y, Z(, C)]) as a new tensor."""
        return t.reshape(-1).index_select(0, self._index(t)).reshape(
            *self.sizes, *t.shape[3:])

    def put(self, t, vals):
        """Write ``vals`` (box-shaped) into the box of ``t`` (contiguous),
        in place."""
        t.view(-1).index_copy_(0, self._index(t), vals.reshape(-1))


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


def mask_bbox_vox_device(mask):
    """:func:`mask_bbox_vox` computed on the mask's device: a [2, 3] f32
    tensor (lo row, hi row), so only six scalars cross to the host."""
    lo, hi = [], []
    any_all = mask.any()
    for a in range(3):
        line = mask.any(dim=tuple(x for x in range(3) if x != a))
        n = line.shape[0]
        iota = torch.arange(n, dtype=torch.float32, device=mask.device)
        first = torch.where(line, iota, torch.full_like(iota, float(n))).min()
        last = torch.where(line, iota, torch.full_like(iota, -1.0)).max()
        zero = torch.zeros_like(first)
        lo.append(torch.where(any_all, torch.clamp(first - 1.0, min=0.0),
                              zero))
        hi.append(torch.where(any_all, torch.clamp(last + 1.0, max=n - 1.0),
                              zero + (n - 1.0)))
    return torch.stack([torch.stack(lo), torch.stack(hi)])


def _interp_matrix(n_new, n_old):
    """[n_new, n_old] linear-interpolation matrix (align-corners), built on
    the host in numpy."""
    if n_old == 1:
        return np.ones((n_new, 1), np.float32)
    w = np.zeros((n_new, n_old), np.float32)
    if n_new == 1:
        w[0, 0] = 1.0
        return w
    pos = np.arange(n_new, dtype=np.float64) * ((n_old - 1) / (n_new - 1))
    lo = np.clip(np.floor(pos).astype(np.int64), 0, n_old - 2)
    frac = (pos - lo).astype(np.float32)
    rows = np.arange(n_new)
    np.add.at(w, (rows, lo), 1.0 - frac)
    np.add.at(w, (rows, lo + 1), frac)
    return w


def resize_trilinear(grid, new_size):
    """Trilinear resize (align-corners) of an ``[X, Y, Z(, C)]`` grid to
    ``new_size`` as three separable f32 matrix products."""
    squeeze = grid.dim() == 3
    if squeeze:
        grid = grid[..., None]
    nx, ny, nz, _ = grid.shape
    mx, my, mz = (torch.as_tensor(_interp_matrix(int(n_new), n_old),
                                  dtype=grid.dtype, device=grid.device)
                  for n_new, n_old in zip(new_size, (nx, ny, nz)))
    out = torch.einsum("ax,xyzc->ayzc", mx, grid)
    out = torch.einsum("by,ayzc->abzc", my, out)
    out = torch.einsum("cz,abzd->abcd", mz, out)
    return out[..., 0] if squeeze else out
