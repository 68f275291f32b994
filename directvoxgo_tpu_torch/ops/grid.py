"""Voxel-grid helpers: occupancy bbox, nearest occupancy lookup, trilinear
point sampling (the gather forward's grid query) and its scatter, bilinear
and nearest plane sampling and the 3x3x3 max pool. Grids are channels-last
``[X, Y, Z(, C)]`` with align-corners coordinates (``xyz_min`` -> index 0,
``xyz_max`` -> index ``dim-1``).

The trilinear sampler gathers the 8 corners of each point by flat voxel
index and combines them in the JAX package's order (z, then y, then x),
with its clamps: coordinates into ``[0, dim - 1]``, the lower corner into
``[0, dim - 2]``. Its gradient is a scatter-add (``index_add_``) of the
corner weights, so that the backward of a gather step needs no sort and
can be captured in a CUDA graph."""

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


def occupancy_lookup(mask, xyz, xyz_min, xyz_max):
    """:func:`occupancy_lookup_parts` at packed coordinates ``[..., 3]``
    (bounds: sequences of floats)."""
    mn = [float(v) for v in np.asarray(xyz_min, np.float64)]
    mx = [float(v) for v in np.asarray(xyz_max, np.float64)]
    return occupancy_lookup_parts(mask, xyz[..., 0], xyz[..., 1],
                                  xyz[..., 2], mn, mx)


def world_to_grid(xyz, xyz_min, xyz_max, world_size):
    """Continuous voxel indices ``[..., 3]`` of world coordinates ``[...,
    3]`` (align-corners); ``xyz_min``/``xyz_max`` are f32 tensors [3] on
    the coordinates' device."""
    sizes = torch.tensor([float(n) for n in world_size], dtype=xyz.dtype,
                         device=xyz.device)
    unit = (xyz - xyz_min) / (xyz_max - xyz_min)
    return unit * (sizes - 1.0)


def world_to_grid_parts(x, y, z, xyz_min, xyz_max, world_size):
    """Component form of :func:`world_to_grid` with python-float bounds:
    ``(v - lo) * ((n - 1) / (hi - lo))``, the scale rounded to f32."""
    out = []
    for v, lo, hi, n in zip((x, y, z), xyz_min, xyz_max, world_size):
        s = (float(n) - 1.0) / (float(hi) - float(lo))
        out.append((v - float(lo)) * s)
    return tuple(out)


def trilinear_corners(ix, iy, iz, dims):
    """The trilinear stencil of continuous voxel coordinates in a grid of
    ``dims`` (xyz): ``(base, (fx, fy, fz), (sx, sy, sz))`` with ``base``
    the flat index (int64) of the lower corner, ``f*`` the fractions
    (f32) and ``s*`` the flat steps (python ints) to the upper corner
    along each axis (0 along an axis of one voxel). Coordinates clamp into
    ``[0, dim - 1]``, lower corners into ``[0, dim - 2]``."""
    nx, ny, nz = (int(d) for d in dims)
    idx, frac = [], []
    for v, n in zip((ix, iy, iz), (nx, ny, nz)):
        v = torch.clamp(v, 0.0, n - 1.0)
        i0 = torch.clamp(torch.floor(v).to(torch.int64), 0, max(n - 2, 0))
        idx.append(i0)
        frac.append(v - i0)
    base = (idx[0] * ny + idx[1]) * nz + idx[2]
    steps = (ny * nz if nx > 1 else 0, nz if ny > 1 else 0,
             1 if nz > 1 else 0)
    return base, tuple(frac), steps


def _corner_weights(frac, lead):
    """The 8 corner weights ``((lead * (1-fx|fx)) * (1-fy|fy)) *
    (1-fz|fz)`` by corner (dx, dy, dz), z fastest: the JAX package's
    gradient of the sampler (the cotangent times x's, y's, then z's
    factor)."""
    fx, fy, fz = frac
    wx, wy, wz = (1 - fx, fx), (1 - fy, fy), (1 - fz, fz)
    return [((dx, dy, dz), lead * wx[dx] * wy[dy] * wz[dz])
            for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)]


class _TrilinearGather(torch.autograd.Function):
    """Trilinear interpolation of a flat grid ``[V, C]`` at a stencil of
    :func:`trilinear_corners`; differentiable in the grid only (the
    coordinates of the gather paths carry no gradient)."""

    @staticmethod
    def forward(ctx, flat, base, fx, fy, fz, steps):
        sx, sy, sz = steps
        c = flat.shape[1]

        def g(dx, dy, dz):
            lin = (base + (dx * sx + dy * sy + dz * sz)).reshape(-1)
            return flat.index_select(0, lin).reshape(*base.shape, c)

        fx_, fy_, fz_ = fx[..., None], fy[..., None], fz[..., None]
        c00 = g(0, 0, 0) * (1 - fz_) + g(0, 0, 1) * fz_
        c01 = g(0, 1, 0) * (1 - fz_) + g(0, 1, 1) * fz_
        c10 = g(1, 0, 0) * (1 - fz_) + g(1, 0, 1) * fz_
        c11 = g(1, 1, 0) * (1 - fz_) + g(1, 1, 1) * fz_
        c0 = c00 * (1 - fy_) + c01 * fy_
        c1 = c10 * (1 - fy_) + c11 * fy_
        ctx.save_for_backward(base, fx, fy, fz)
        ctx.steps, ctx.n_vox = steps, flat.shape[0]
        return c0 * (1 - fx_) + c1 * fx_

    @staticmethod
    def backward(ctx, g_out):
        base, fx, fy, fz = ctx.saved_tensors
        sx, sy, sz = ctx.steps
        c = g_out.shape[-1]
        grad = torch.zeros((ctx.n_vox, c), dtype=g_out.dtype,
                           device=g_out.device)
        frac = (fx[..., None], fy[..., None], fz[..., None])
        for (dx, dy, dz), w in _corner_weights(frac, g_out):
            lin = (base + (dx * sx + dy * sy + dz * sz)).reshape(-1)
            grad.index_add_(0, lin, w.reshape(-1, c))
        return grad, None, None, None, None, None


def trilinear_sample_parts(grid, ix, iy, iz):
    """Trilinear interpolation of ``grid`` ([X, Y, Z] or [X, Y, Z, C]) at
    continuous voxel coordinates (ix, iy, iz) of one shape, clamped to the
    border; returns ``[...]`` or ``[..., C]``. Differentiable in ``grid``
    (a scatter-add of the corner weights)."""
    squeeze = grid.dim() == 3
    dims = grid.shape[:3]
    flat = grid.reshape(int(dims[0]) * int(dims[1]) * int(dims[2]), -1)
    base, (fx, fy, fz), steps = trilinear_corners(ix, iy, iz, dims)
    out = _TrilinearGather.apply(flat, base, fx, fy, fz, steps)
    return out[..., 0] if squeeze else out


def trilinear_sample_world(grid, x, y, z, xyz_min, xyz_max):
    """Trilinear query at world coordinates (component form, python-float
    bounds)."""
    ix, iy, iz = world_to_grid_parts(x, y, z, xyz_min, xyz_max,
                                     grid.shape[:3])
    return trilinear_sample_parts(grid, ix, iy, iz)


def trilinear_sample(grid, idx):
    """Trilinear interpolation at packed voxel coordinates ``idx [...,
    3]`` (:func:`trilinear_sample_parts`)."""
    return trilinear_sample_parts(grid, idx[..., 0], idx[..., 1],
                                  idx[..., 2])


def trilinear_splat_(out_flat, ix, iy, iz, dims, weight):
    """Add ``weight`` (shape of the coordinates) times each corner's
    trilinear weight into ``out_flat`` [X*Y*Z] f32, in place: the gradient
    of ``sum(trilinear_sample(g, .) * weight)`` with respect to ``g``."""
    base, frac, (sx, sy, sz) = trilinear_corners(ix, iy, iz, dims)
    for (dx, dy, dz), w in _corner_weights(frac, weight):
        lin = (base + (dx * sx + dy * sy + dz * sz)).reshape(-1)
        out_flat.index_add_(0, lin, w.reshape(-1))
    return out_flat


class DeviceBox:
    """A box of ``sizes`` voxels (xyz) of a grid of ``dims`` (xyz) whose
    start voxel is device data: ``off``, an integer tensor [3] holding the
    start along the axes ``perm`` (``off[i]`` along axis ``perm[i]``; the
    sweep's permuted order, or xyz). Reads and writes go through the box's
    flat element indices, made on the device from ``off``, so that a step
    captured as a CUDA graph takes the offsets of each replay, not those of
    its capture. A start is taken as ``jax.lax.dynamic_slice`` takes it: a
    negative one counts from the grid's end, and a box past an edge is
    shifted back inside. :meth:`take` is differentiable (its gradient is the
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
        parts = []
        for a in range(3):
            # on the device, as ``jax.lax.dynamic_slice`` and
            # ``dynamic_update_slice`` take a start: a negative one counts
            # from the end, then each is clamped into [0, dim - size]
            start = o[list(perm).index(a)]
            start = torch.where(start < 0, start + self.dims[a], start)
            start = torch.clamp(start, 0, self.dims[a] - self.sizes[a])
            parts.append((torch.arange(self.sizes[a], device=off.device)
                          + start) * strides[a])
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
        # index_select: its backward is an index_add_ (advanced indexing's
        # would be a sorted index_put_, several times slower on the card)
        return flat.index_select(0, (a * nv + b).reshape(-1)).reshape(
            *a.shape, nc)

    c0 = g(u0, v0) * (1 - fv) + g(u0, v1) * fv
    c1 = g(u1, v0) * (1 - fv) + g(u1, v1) * fv
    out = c0 * (1 - fu) + c1 * fu
    return out[..., 0] if squeeze else out


def nearest_sample_2d_parts(plane, iu, iv):
    """Nearest-texel lookup in a ``[U, V(, C)]`` plane at continuous
    coordinates (iu, iv): rounded half to even (as ``jnp.round``), then
    clamped to the plane."""
    squeeze = plane.dim() == 2
    if squeeze:
        plane = plane[..., None]
    nu, nv, nc = plane.shape
    flat = plane.reshape(nu * nv, nc)
    u = torch.clamp(torch.round(iu).to(torch.int64), 0, nu - 1)
    v = torch.clamp(torch.round(iv).to(torch.int64), 0, nv - 1)
    out = flat.index_select(0, (u * nv + v).reshape(-1)).reshape(
        *u.shape, nc)
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
