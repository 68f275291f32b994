"""The color MLP and the positional view embedding.

``MLP`` keeps the layer layout of the JAX package's ``init_mlp``: ``depth``
linear layers (in -> width, (depth-2) x width -> width, width -> out) with
ReLU between them and a zero last bias. Weights are ``nn.Linear`` ([out,
in]); the JAX pytree stores ``w`` as [in, out] (see ``convert.py``).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..ops import rounding

BF16 = torch.bfloat16


def init_linear(fan_in, fan_out, zero_bias=False, generator=None,
                device=None):
    """``nn.Linear`` with the JAX package's ``init_linear``: weight and bias
    uniform in ``+-1/sqrt(fan_in)`` (the bias zero with ``zero_bias``),
    drawn on the host from ``generator``."""
    layer = nn.Linear(fan_in, fan_out, device=device)
    bound = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        for p in (layer.weight, layer.bias):
            p.copy_(torch.empty(p.shape).uniform_(-bound, bound,
                                                  generator=generator))
        if zero_bias:
            layer.bias.zero_()
    return layer


class MLP(nn.Module):
    def __init__(self, dim_in, width, depth, dim_out, generator=None,
                 device=None):
        super().__init__()
        dims = [dim_in] + [width] * (depth - 1) + [dim_out]
        # Drawn on the host (``generator`` is a CPU generator), then copied.
        self.layers = nn.ModuleList(
            init_linear(dims[i], dims[i + 1], zero_bias=i == len(dims) - 2,
                        generator=generator, device=device)
            for i in range(len(dims) - 1))


def _rnd(x, dtype):
    """Round to ``dtype`` and back to f32 (identity when dtype is None)."""
    return x if dtype is None else x.to(dtype).float()


def _rnd_param(p, dtype, f32_cot):
    """:func:`_rnd` of a parameter, whose gradient (a sum over the batch)
    stays unrounded with ``f32_cot`` (:func:`..ops.rounding.to_dtype`)."""
    return p if dtype is None else rounding.to_dtype(p, dtype,
                                                     f32_cot).float()


def split_cl_rounded(mlp):
    """The parameters whose gradients :func:`mlp_apply_split_cl` rounds to
    its compute dtype: every weight, and every bias but the last."""
    return [p for layer in mlp.layers for p in (layer.weight, layer.bias)
            ][:-1]


def mlp_apply(mlp, x):
    """The MLP over the last dim of ``x [..., dim_in]`` in f32 (the gather
    forward's colour query): ReLU between layers, logits ``[...,
    dim_out]``. On the card the products stay f32 as long as TF32 matmuls
    are off (PyTorch's default, which ``run.main`` keeps)."""
    layers = mlp.layers
    for i, layer in enumerate(layers):
        x = torch.nn.functional.linear(x, layer.weight, layer.bias)
        if i < len(layers) - 1:
            x = torch.relu(x)
    return x


def mlp_apply_split_cl(mlp, x_cl, x_shared, compute_dtype=None,
                       f32_cot=False):
    """MLP over ``concat([x_samples, x_shared])`` with channels-leading
    sample features ``x_cl [D1, N, S]`` and per-ray ``x_shared [N, D2]``;
    returns logits ``[D_out, N, S]`` f32.

    With ``compute_dtype=bf16`` operands and hidden activations are rounded
    to bf16 (products accumulate in f32), matching the JAX package's
    rounding points: the per-ray half of layer 1 is rounded once, the
    sample half after its product and again after the add. ``f32_cot``:
    the parameters' gradients are not rounded (:mod:`..ops.rounding`).
    """
    cd = compute_dtype
    layers = mlp.layers
    w1, b1 = layers[0].weight.t(), layers[0].bias
    d1 = x_cl.shape[0]
    wa = _rnd_param(w1[:d1], cd, f32_cot)
    wb = _rnd_param(w1[d1:], cd, f32_cot)
    x_cl, x_shared = _rnd(x_cl.float(), cd), _rnd(x_shared.float(), cd)
    shared = _rnd(x_shared @ wb + _rnd_param(b1, cd, f32_cot), cd)
    x = _rnd(torch.einsum("dns,dw->nsw", x_cl, wa), cd)
    x = torch.relu(_rnd(x + shared[:, None, :], cd))
    for i, layer in enumerate(layers[1:]):
        w, b = layer.weight.t(), layer.bias
        if i == len(layers) - 2:
            logit = x @ _rnd_param(w, cd, f32_cot) + b
            return logit.permute(2, 0, 1)
        x = torch.relu(_rnd(_rnd(x @ _rnd_param(w, cd, f32_cot), cd)
                            + _rnd_param(b, cd, f32_cot), cd))
    raise AssertionError("MLP needs depth >= 2")


def positional_encoding(x, n_freqs):
    """[x, sin(x*2^i), cos(x*2^i)] embedding along the last dim."""
    if n_freqs <= 0:
        return x
    # 1, 2, 4, ... made on the device (exact products of 2): a step
    # captured as a CUDA graph may not copy from the host
    freqs = torch.full((n_freqs,), 2.0, dtype=x.dtype,
                       device=x.device).cumprod(0) / 2.0
    emb = (x[..., None] * freqs).reshape(*x.shape[:-1], -1)
    return torch.cat([x, torch.sin(emb), torch.cos(emb)], -1)
