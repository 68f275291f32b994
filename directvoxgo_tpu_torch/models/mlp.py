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

BF16 = torch.bfloat16


class MLP(nn.Module):
    def __init__(self, dim_in, width, depth, dim_out, generator=None,
                 device=None):
        super().__init__()
        dims = [dim_in] + [width] * (depth - 1) + [dim_out]
        self.layers = nn.ModuleList(
            nn.Linear(dims[i], dims[i + 1], device=device)
            for i in range(len(dims) - 1))
        # Drawn on the host (``generator`` is a CPU generator), then copied.
        with torch.no_grad():
            for i, layer in enumerate(self.layers):
                bound = 1.0 / math.sqrt(layer.in_features)
                for p in (layer.weight, layer.bias):
                    p.copy_(torch.empty(p.shape).uniform_(
                        -bound, bound, generator=generator))
                if i == len(self.layers) - 1:
                    layer.bias.zero_()


def _rnd(x, dtype):
    """Round to ``dtype`` and back to f32 (identity when dtype is None)."""
    return x if dtype is None else x.to(dtype).float()


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


def mlp_apply_split_cl(mlp, x_cl, x_shared, compute_dtype=None):
    """MLP over ``concat([x_samples, x_shared])`` with channels-leading
    sample features ``x_cl [D1, N, S]`` and per-ray ``x_shared [N, D2]``;
    returns logits ``[D_out, N, S]`` f32.

    With ``compute_dtype=bf16`` operands and hidden activations are rounded
    to bf16 (products accumulate in f32), matching the JAX package's
    rounding points: the per-ray half of layer 1 is rounded once, the
    sample half after its product and again after the add.
    """
    cd = compute_dtype
    layers = mlp.layers
    w1, b1 = layers[0].weight.t(), layers[0].bias
    d1 = x_cl.shape[0]
    wa, wb = _rnd(w1[:d1], cd), _rnd(w1[d1:], cd)
    x_cl, x_shared = _rnd(x_cl.float(), cd), _rnd(x_shared.float(), cd)
    shared = _rnd(x_shared @ wb + _rnd(b1, cd), cd)
    x = _rnd(torch.einsum("dns,dw->nsw", x_cl, wa), cd)
    x = torch.relu(_rnd(x + shared[:, None, :], cd))
    for i, layer in enumerate(layers[1:]):
        w, b = layer.weight.t(), layer.bias
        if i == len(layers) - 2:
            logit = x @ _rnd(w, cd) + b
            return logit.permute(2, 0, 1)
        x = torch.relu(_rnd(_rnd(x @ _rnd(w, cd), cd) + _rnd(b, cd), cd))
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
