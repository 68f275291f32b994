"""Total-variation gradient injection (plain PyTorch).

Adds, for each voxel, the 6-neighbour clamped-difference gradient to the
parameter's gradient, outside autograd. One quirk is kept behind a flag:
with ``bug_compat=True`` (the default) ``wz``, not ``wx``, weights the
x-axis neighbour terms, as the upstream CUDA kernel does; with isotropic
weights this changes nothing.
"""

from __future__ import annotations

import torch


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


def tv_term(param, wx, wy, wz, bug_compat=True):
    """The TV gradient term alone (no gradient add, no sparse gating); each
    weight is divided by 6."""
    wx, wy, wz = wx / 6.0, wy / 6.0, wz / 6.0
    w_for_x = wz if bug_compat else wx
    return (_axis_term(param, 0, w_for_x) + _axis_term(param, 1, wy)
            + _axis_term(param, 2, wz))


def total_variation_add_grad(param, grad, wx, wy, wz, dense_mode,
                             bug_compat=True):
    """``grad`` plus the TV gradient of ``param`` (``[X, Y, Z(, C)]``,
    channels independent). ``dense_mode=False``: only voxels with a nonzero
    incoming gradient receive the term."""
    tv = tv_term(param, wx, wy, wz, bug_compat)
    if not dense_mode:
        tv = torch.where(grad != 0, tv, torch.zeros_like(tv))
    return grad + tv
