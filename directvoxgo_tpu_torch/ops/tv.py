"""Total-variation gradient injection; kernel K-F (``csrc/tv_add_grad.cu``).

Adds, for each voxel, the 6-neighbour clamped-difference gradient to the
parameter's gradient, outside autograd. One quirk is kept behind a flag:
with ``bug_compat=True`` (the default) ``wz``, not ``wx``, weights the
x-axis neighbour terms, as the upstream CUDA kernel does; with isotropic
weights this changes nothing.

:func:`total_variation_add_grad` takes the whole grid,
:func:`tv_add_grad_box` a box of it (the gradient of the box only,
neighbours read from the whole grid). On CUDA tensors both launch kernel
K-F (or raise); on CPU tensors they run the plain PyTorch body. The kernel
has two paths, picked by :func:`rows_path`: x-marching row tiles with
16-byte vectors for a dense gradient (contiguous or axis-permuted) on an
aligned run, and one thread per element through the gradient's strides for
the rest (channel slices, unaligned boxes).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

launches = 0
launches_by_path = {"rows": 0, "strided": 0}
# The rows path's limits (csrc/tv_add_grad.cu): the z halo it stages holds
# at most this many channels, and its offsets are 32-bit.
ROWS_MAX_CHANNELS = 32
ROWS_MAX_ELEMENTS = 2 ** 31 - 1


def _lib():
    """The kernel library, with every C function's signature declared."""
    lib = _build.load("tv_add_grad")
    lib.dvgo_tv_add_grad.argtypes = ([ctypes.c_void_p] * 3
                                     + [ctypes.c_int] * 10
                                     + [ctypes.c_longlong] * 4
                                     + [ctypes.c_float] * 3
                                     + [ctypes.c_int] + [ctypes.c_void_p] * 2)
    lib.dvgo_tv_add_grad.restype = ctypes.c_int
    # The rows path takes the same arguments.
    lib.dvgo_tv_add_grad_rows.argtypes = lib.dvgo_tv_add_grad.argtypes
    lib.dvgo_tv_add_grad_rows.restype = ctypes.c_int
    lib.dvgo_error_string.argtypes = [ctypes.c_int]
    lib.dvgo_error_string.restype = ctypes.c_char_p
    return lib


def _axis_term(param, axis, w):
    """``w *`` the sum over both neighbours along ``axis`` of
    ``clamp(param - neighbour, -1, 1)``, with edge-replicated neighbours
    (self - self = 0 at the border)."""
    n = param.shape[axis]
    up = torch.cat([param.narrow(axis, 1, n - 1),
                    param.narrow(axis, n - 1, 1)], axis)
    dn = torch.cat([param.narrow(axis, 0, 1),
                    param.narrow(axis, 0, n - 1)], axis)
    return w * (torch.clamp(param - up, -1.0, 1.0)
                + torch.clamp(param - dn, -1.0, 1.0))


def _axis_weights(wx, wy, wz, bug_compat):
    """The weights of the x, y and z terms: each divided by 6, ``wz`` on
    the x axis under ``bug_compat``."""
    wx, wy, wz = wx / 6.0, wy / 6.0, wz / 6.0
    return (wz if bug_compat else wx), wy, wz


def tv_term(param, wx, wy, wz, bug_compat=True):
    """The TV gradient term alone (no gradient add, no sparse gating); each
    weight is divided by 6. Plain PyTorch on any device."""
    w_x, w_y, w_z = _axis_weights(wx, wy, wz, bug_compat)
    return (_axis_term(param, 0, w_x) + _axis_term(param, 1, w_y)
            + _axis_term(param, 2, w_z))


def _gated_add(grad, tv, dense_mode):
    if not dense_mode:
        tv = torch.where(grad != 0, tv, torch.zeros_like(tv))
    return grad + tv


def _halo_box(shape3, offs, sizes):
    """(start, sizes) of the box grown by one voxel on each side, clipped
    to the grid."""
    hs = tuple(min(s + 2, g) for s, g in zip(sizes, shape3))
    start = tuple(min(max(o - 1, 0), g - h)
                  for o, g, h in zip(offs, shape3, hs))
    return start, hs


def tv_add_grad_box_plain(param, grad_box, offs, wx, wy, wz,
                          dense_mode=False, bug_compat=True):
    """Plain version of :func:`tv_add_grad_box`: the TV term of a
    1-voxel-haloed slice of ``param`` (its edge replication only takes
    effect where the box touches the grid border, since the halo start
    clamps exactly there), cropped to the box."""
    sizes = tuple(int(s) for s in grad_box.shape[:3])
    start, hs = _halo_box(tuple(param.shape[:3]), offs, sizes)
    halo = param[tuple(slice(s, s + h) for s, h in zip(start, hs))]
    tv = tv_term(halo, wx, wy, wz, bug_compat)
    tv = tv[tuple(slice(o - s, o - s + z)
                  for o, s, z in zip(offs, start, sizes))]
    return _gated_add(grad_box, tv, dense_mode)


def total_variation_add_grad_plain(param, grad, wx, wy, wz, dense_mode,
                                   bug_compat=True):
    """Plain version of :func:`total_variation_add_grad`."""
    return _gated_add(grad, tv_term(param, wx, wy, wz, bug_compat),
                      dense_mode)


def rows_path(dims, c, offs, sizes, g_strides, p_address):
    """Whether K-F takes its rows path (x-marching tiles, 16-byte vectors
    of p and out) for a box of ``sizes`` at ``offs`` (None: offsets that
    are device data, any the box admits) in a grid ``dims`` of
    ``c`` channels, whose gradient has element strides ``g_strides`` (four,
    the channel's last), p starting at byte ``p_address``: the gradient
    dense with its channels innermost (contiguous, or a permutation of its
    spatial axes, as autograd hands over the sweep's gradient of an MPI
    grid; not a channel slice) and every offset into it under 2^31, the
    grid's row, the box's offset and its run along the flat (z, c) axis
    whole vectors of 4 floats, p 16-byte aligned, at most
    ``ROWS_MAX_CHANNELS`` channels and a grid under 2^31 elements. Device
    offsets keep the box's offset in whole vectors only where every
    admissible offset does: ``c`` a multiple of 4, or the box spanning the
    grid's z (an MPI window's full station extent). Anything else takes the
    strided path."""
    if c > 1 and g_strides[3] != 1:
        return False
    dense, step = True, c
    for stride, size in sorted((st, sz) for sz, st in zip(sizes, g_strides)
                               if sz > 1):
        dense &= stride == step
        step *= size
    reach = sum((sz - 1) * st for sz, st in zip(sizes, g_strides)) + c
    n = dims[0] * dims[1] * dims[2] * c
    return (dense and c <= ROWS_MAX_CHANNELS
            and n < ROWS_MAX_ELEMENTS and reach < ROWS_MAX_ELEMENTS
            and (dims[2] * c) % 4 == 0
            and ((offs[2] * c) % 4 == 0 if offs is not None
                 else c % 4 == 0 or sizes[2] == dims[2])
            and (sizes[2] * c) % 4 == 0 and p_address % 16 == 0)


def path_of(param, grad_box, offs=(0, 0, 0)):
    """The path K-F takes for ``param`` and the box gradient ``grad_box``
    at ``offs`` (ints, or a tensor: device offsets): "rows" or "strided"
    (:func:`rows_path`; the output is a fresh allocation, which the caching
    allocator aligns)."""
    c = int(param.shape[3]) if param.dim() == 4 else 1
    g_strides = tuple(grad_box.stride()) + ((1,) if param.dim() == 3 else ())
    rows = rows_path(tuple(int(d) for d in param.shape[:3]), c,
                     None if torch.is_tensor(offs)
                     else tuple(int(o) for o in offs),
                     tuple(int(d) for d in grad_box.shape[:3]), g_strides,
                     param.data_ptr())
    return "rows" if rows else "strided"


def _launch(param, grad_box, offs, w, dense_mode):
    """K-F over the box of ``param`` (contiguous) at ``offs`` (ints, or an
    int32 [3] tensor on the device, which the kernel reads) whose gradient
    is ``grad_box`` (any strides); returns a new contiguous tensor (it
    never writes ``param`` or ``grad_box``)."""
    global launches
    if not (param.is_cuda and grad_box.device == param.device):
        raise ValueError("tv_add_grad: param and grad must be on one CUDA "
                         "device")
    if param.dtype != torch.float32 or grad_box.dtype != torch.float32:
        raise TypeError("tv_add_grad: param and grad must be float32")
    if param.dim() not in (3, 4) or grad_box.dim() != param.dim() \
            or grad_box.shape[3:] != param.shape[3:]:
        raise ValueError(f"tv_add_grad: param {tuple(param.shape)} and grad "
                         f"{tuple(grad_box.shape)} are not [X, Y, Z(, C)] "
                         "grids of one channel count")
    if not param.is_contiguous():
        raise ValueError("tv_add_grad: expects a contiguous param")
    dims = tuple(int(d) for d in param.shape[:3])
    sizes = tuple(int(d) for d in grad_box.shape[:3])
    offs_dev = None
    if torch.is_tensor(offs):
        if (offs.device != param.device or offs.dtype != torch.int32
                or offs.shape != (3,) or not offs.is_contiguous()):
            raise ValueError("tv_add_grad: device offsets must be a "
                             "contiguous int32 [3] on the grid's device")
        offs_dev, offs = offs, (0, 0, 0)
        if any(s > d for s, d in zip(sizes, dims)):
            raise ValueError(f"tv_add_grad: box {sizes} exceeds the grid "
                             f"{dims}")
    offs = tuple(int(o) for o in offs)
    if any(o < 0 or o + s > d for o, s, d in zip(offs, sizes, dims)):
        raise ValueError(f"tv_add_grad: box {sizes} at {offs} is not inside "
                         f"the grid {dims}")
    c = int(param.shape[3]) if param.dim() == 4 else 1
    g_strides = tuple(grad_box.stride()) + ((1,) if param.dim() == 3 else ())
    out = torch.empty(grad_box.shape, dtype=torch.float32,
                      device=grad_box.device)
    lib = _lib()
    stream = torch.cuda.current_stream(param.device).cuda_stream
    ptrs = (param.data_ptr(), grad_box.data_ptr(), out.data_ptr())
    path = path_of(param, grad_box, offs if offs_dev is None else offs_dev)
    fn = lib.dvgo_tv_add_grad_rows if path == "rows" else \
        lib.dvgo_tv_add_grad
    err = fn(*ptrs, *dims, c, *offs, *sizes, *g_strides,
             *(float(x) for x in w), int(bool(dense_mode)),
             None if offs_dev is None else offs_dev.data_ptr(), stream)
    if err:
        raise RuntimeError("tv_add_grad launch failed: "
                           + lib.dvgo_error_string(err).decode())
    launches += 1
    launches_by_path[path] += 1
    return out


def total_variation_add_grad(param, grad, wx, wy, wz, dense_mode,
                             bug_compat=True):
    """``grad`` plus the TV gradient of ``param`` (``[X, Y, Z(, C)]`` f32,
    channels independent). ``dense_mode=False``: only voxels with a nonzero
    incoming gradient receive the term; the others come out as ``grad``
    exactly. A new tensor; kernel K-F on CUDA tensors."""
    if param.device.type == "cpu" and grad.device.type == "cpu":
        return total_variation_add_grad_plain(param, grad, wx, wy, wz,
                                              dense_mode, bug_compat)
    if grad.shape != param.shape:
        raise ValueError(f"tv_add_grad: grad {tuple(grad.shape)} does not "
                         f"match param {tuple(param.shape)}")
    return _launch(param, grad, (0, 0, 0),
                   _axis_weights(wx, wy, wz, bug_compat), dense_mode)


def tv_add_grad_box(param, grad_box, offs, wx, wy, wz, dense_mode=False,
                    bug_compat=True):
    """The boxed form: ``grad_box`` ([bx, by, bz(, C)], the gradient of the
    box of ``param`` starting at voxel ``offs``) plus the TV term of
    ``param`` on that box, gated by ``grad_box != 0`` unless
    ``dense_mode``. The stencil reads the box's neighbours from the whole
    grid and edge-replicates only at the grid border, so the result is the
    box of :func:`total_variation_add_grad` over a full-size gradient that
    is ``grad_box`` inside the box. ``offs`` may be an int32 [3] tensor on
    the grid's device: the kernel then reads it (a train step captured as
    a CUDA graph). A new tensor; kernel K-F on CUDA tensors."""
    if not torch.is_tensor(offs):
        offs = tuple(int(o) for o in offs)
    if param.device.type == "cpu" and grad_box.device.type == "cpu":
        offs = tuple(int(o) for o in offs)
        return tv_add_grad_box_plain(param, grad_box, offs, wx, wy, wz,
                                     dense_mode, bug_compat)
    return _launch(param, grad_box, offs,
                   _axis_weights(wx, wy, wz, bug_compat), dense_mode)
