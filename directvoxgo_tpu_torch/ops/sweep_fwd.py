"""Kernel K-A: the station-sweep forward (``csrc/sweep_fwd.cu``).

``sweep_fwd(slabs, rays, k)`` samples every station slab along every ray:
``out[s, c, n] = sum_v wv * sum_u wu * slab[s, u, v, c]`` with hat weights
at ``(u, v) = (ou, ov) + t*(du, dv)``, ``t = (s/k - op)/dp``. On a CUDA
tensor it launches the kernel (or raises); on a CPU tensor it runs
:func:`sweep_fwd_plain`, the same arithmetic in plain PyTorch.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

launches = 0


def _lib():
    """The kernel library, with every C function's signature declared."""
    lib = _build.load("sweep_fwd")
    lib.dvgo_sweep_fwd.argtypes = ([ctypes.c_void_p, ctypes.c_int]
                                   + [ctypes.c_void_p] * 2
                                   + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    lib.dvgo_sweep_fwd.restype = ctypes.c_int
    lib.dvgo_sweep_fwd_max_channels.argtypes = []
    lib.dvgo_sweep_fwd_max_channels.restype = ctypes.c_int
    lib.dvgo_error_string.argtypes = [ctypes.c_int]
    lib.dvgo_error_string.restype = ctypes.c_char_p
    return lib


def sweep_fwd_plain(slabs, rays, k):
    """Plain version: per station, dense hat rows ``wu [N, Gu]`` (rounded to
    the slab dtype) times the slab in f32, then the f32 ``wv`` reduction."""
    s_total, gu, gv, c = slabs.shape
    n = rays.shape[1]
    op, ou, ov, dp, du, dv = rays
    iota_u = torch.arange(gu, dtype=torch.float32, device=rays.device)
    iota_v = torch.arange(gv, dtype=torch.float32, device=rays.device)
    out = torch.empty((s_total, c, n), dtype=torch.float32,
                      device=rays.device)
    for s in range(s_total):
        t = (torch.tensor(s, dtype=torch.float32) / k - op) / dp
        # (u, v) as fused multiply-adds (one f32 rounding), as the kernel
        u = (t.double() * du.double() + ou.double()).float()
        v = (t.double() * dv.double() + ov.double()).float()
        wu = torch.clamp(1.0 - (u[:, None] - iota_u).abs(), min=0.0)
        wu = wu.to(slabs.dtype).float()
        wv = torch.clamp(1.0 - (v[:, None] - iota_v).abs(), min=0.0)
        tmp = wu @ slabs[s].reshape(gu, gv * c).float()
        out[s] = torch.einsum("nvc,nv->cn", tmp.reshape(n, gv, c), wv)
    return out


def sweep_fwd(slabs, rays, k):
    """slabs [S, Gu, Gv, C] bf16 or f32 station slabs (channel-minor);
    rays [6, N] f32 rows (op, ou, ov, dp, du, dv), ``dp`` already nonzero;
    k stations per voxel. Returns [S, C, N] f32."""
    global launches
    if slabs.device.type == "cpu" and rays.device.type == "cpu":
        return sweep_fwd_plain(slabs, rays, k)
    if not (slabs.is_cuda and rays.device == slabs.device):
        raise ValueError("sweep_fwd: slabs and rays must be on one CUDA "
                         "device")
    if slabs.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"sweep_fwd: slab dtype {slabs.dtype}")
    if rays.dtype != torch.float32 or rays.dim() != 2 or rays.shape[0] != 6:
        raise ValueError("sweep_fwd: rays must be [6, N] float32")
    if slabs.dim() != 4 or not (slabs.is_contiguous()
                                and rays.is_contiguous()):
        raise ValueError("sweep_fwd: expects contiguous [S, Gu, Gv, C] "
                         "slabs and [6, N] rays")
    s_total, gu, gv, c = slabs.shape
    n = rays.shape[1]
    lib = _lib()
    if c > lib.dvgo_sweep_fwd_max_channels():
        raise ValueError(f"sweep_fwd: {c} channels exceed the kernel's "
                         "register budget")
    out = torch.empty((s_total, c, n), dtype=torch.float32,
                      device=slabs.device)
    err = lib.dvgo_sweep_fwd(
        slabs.data_ptr(), int(slabs.dtype == torch.bfloat16),
        rays.data_ptr(), out.data_ptr(), n, s_total, gu, gv, c, int(k),
        torch.cuda.current_stream(slabs.device).cuda_stream)
    if err:
        raise RuntimeError("sweep_fwd launch failed: "
                           + lib.dvgo_error_string(err).decode())
    launches += 1
    return out
