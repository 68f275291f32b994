"""Where the bf16 paths round, and gradients that skip that rounding.

The sweep's stacked grids and the colour MLP's weights are rounded to
bf16 before their products (:func:`to_dtype`). Autograd rounds their
gradients the same way on the way back: a grid's cotangent, summed in f32
over the batch's rays, reaches the f32 parameter rounded to bf16. A
data-parallel step must round the sum over all ranks once, as one card
rounds its whole batch's sum, not each rank's partial sum: it asks for
``f32_cot`` (an argument of the sweep forwards, passed down to
:func:`to_dtype`, :func:`..ops.sweep.sweep_samples` and
:func:`..models.mlp.mlp_apply_split_cl`), which keeps the same forward
values in f32 storage and lets their gradients pass through unrounded, so
that the step can reduce them over the ranks and round the mean itself.
"""

from __future__ import annotations

import torch


class _RoundF32(torch.autograd.Function):
    """``x`` rounded to ``dtype`` and kept in f32; the gradient passes
    through in f32, unrounded."""

    @staticmethod
    def forward(ctx, x, dtype):
        return x.to(dtype).to(torch.float32)

    @staticmethod
    def backward(ctx, g):
        return g, None


def to_dtype(x, dtype, f32_cot=False):
    """``x.to(dtype)``; with ``f32_cot`` the same values in f32 storage,
    whose gradient is not rounded."""
    if not f32_cot or dtype == torch.float32:
        return x.to(dtype)
    return _RoundF32.apply(x, dtype)
