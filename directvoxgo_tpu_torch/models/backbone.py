"""2D convolutional encoders of the image-conditioned variants: EDSR (the
baseline of 16 residual blocks at 64 features over the 9-channel
conditioning input rgb + rays_o + rays_d) and the ResNet stem extractor.

NCHW ``nn.Conv2d`` layers with OIHW weights; the JAX package keeps HWIO
(``convert.py`` transposes). ``"SAME"`` padding is XLA's: for a stride of
1 and an odd kernel it is ``k // 2`` on each side, at a stride of 2 the
extra row or column goes after. Initial weights and biases are drawn
uniform in ``+-1/sqrt(fan_in)`` from an explicit ``torch.Generator`` (on
the host, then copied), as the JAX package draws them. Pretrained weights
come from a local file only (:func:`load_torch_edsr_weights`).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def _uniform_(p, bound, generator):
    with torch.no_grad():
        p.copy_(torch.empty(p.shape).uniform_(-bound, bound,
                                              generator=generator))


def init_conv(cin, cout, ksize, bias=True, generator=None, device=None):
    """``nn.Conv2d`` (no built-in padding) with the JAX package's init."""
    conv = nn.Conv2d(cin, cout, ksize, bias=bias, device=device)
    bound = 1.0 / math.sqrt(cin * ksize * ksize)
    _uniform_(conv.weight, bound, generator)
    if bias:
        _uniform_(conv.bias, bound, generator)
    return conv


def same_pads(size, k, stride):
    """XLA's ``"SAME"`` padding (low, high) of one spatial axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv_apply(conv, x, stride=1, padding="SAME"):
    """NCHW convolution with XLA's ``"SAME"`` (or ``"VALID"``) padding."""
    if padding == "SAME":
        kh, kw = conv.kernel_size
        ph = same_pads(x.shape[-2], kh, stride)
        pw = same_pads(x.shape[-1], kw, stride)
        if ph[0] == ph[1] and pw[0] == pw[1]:
            return F.conv2d(x, conv.weight, conv.bias, stride,
                            (ph[0], pw[0]))
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    return F.conv2d(x, conv.weight, conv.bias, stride)


def max_pool2d(x, window=2, stride=None):
    """``"VALID"`` max pool of an NCHW map."""
    return F.max_pool2d(x, window, stride or window)


def pixel_shuffle(x, r):
    """``[N, C*r*r, H, W] -> [N, C, H*r, W*r]`` (the JAX package's NHWC
    ``pixel_shuffle`` in NCHW)."""
    return F.pixel_shuffle(x, r)


# ---------------------------------------------------------------------- EDSR

class ResBlock(nn.Module):
    def __init__(self, n_feats, generator=None, device=None):
        super().__init__()
        self.c1 = init_conv(n_feats, n_feats, 3, generator=generator,
                            device=device)
        self.c2 = init_conv(n_feats, n_feats, 3, generator=generator,
                            device=device)


class EDSR(nn.Module):
    """EDSR: head conv, ``n_resblocks`` residual blocks, body tail conv and
    the long skip; with ``no_upsampling=False`` the pixel-shuffle tail to
    ``n_colors`` (power-of-two scales)."""

    def __init__(self, n_resblocks=16, n_feats=64, n_colors=9, scale=2,
                 res_scale=1.0, no_upsampling=True, generator=None,
                 device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.res_scale = float(res_scale)
        self.no_upsampling = no_upsampling
        self.head = init_conv(n_colors, n_feats, 3, **kw)
        self.body = nn.ModuleList(ResBlock(n_feats, **kw)
                                  for _ in range(n_resblocks))
        self.body_tail = init_conv(n_feats, n_feats, 3, **kw)
        if not no_upsampling:
            assert scale & (scale - 1) == 0, "power-of-two upsampling only"
            self.tail_up = nn.ModuleList(
                init_conv(n_feats, 4 * n_feats, 3, **kw)
                for _ in range(int(math.log2(scale))))
            self.tail_out = init_conv(n_feats, n_colors, 3, **kw)
        self.out_dim = n_feats if no_upsampling else n_colors

    def forward(self, x):
        return edsr_apply(self, x)


def edsr_apply(model, x):
    """``x [N, n_colors, H, W]`` -> features ``[N, n_feats, H, W]`` (or
    the upsampled colours with the tail)."""
    x = conv_apply(model.head, x)
    res = x
    for blk in model.body:
        h = torch.relu(conv_apply(blk.c1, res))
        h = conv_apply(blk.c2, h) * model.res_scale
        res = res + h
    res = conv_apply(model.body_tail, res)
    out = res + x
    if not model.no_upsampling:
        for up in model.tail_up:
            out = pixel_shuffle(conv_apply(up, out), 2)
        out = conv_apply(model.tail_out, out)
    return out


def make_edsr_baseline(n_resblocks=16, n_feats=64, res_scale=1.0, scale=2,
                       no_upsampling=True, n_colors=9, generator=None,
                       device=None):
    """(module, out_dim): the EDSR baseline of the conditioned models."""
    m = EDSR(n_resblocks, n_feats, n_colors, scale, res_scale, no_upsampling,
             generator=generator, device=device)
    return m, m.out_dim


@torch.no_grad()
def load_torch_edsr_weights(model, state_dict):
    """Copy an upstream EDSR ``state_dict`` (``head.0``, ``body.{i}.body.{0,
    2}``, ``body.{n}``; OIHW, as here) into ``model``."""
    def cv(conv, name):
        conv.weight.copy_(torch.as_tensor(state_dict[name + ".weight"]))
        if name + ".bias" in state_dict:
            conv.bias.copy_(torch.as_tensor(state_dict[name + ".bias"]))

    cv(model.head, "head.0")
    for i, blk in enumerate(model.body):
        cv(blk.c1, f"body.{i}.body.0")
        cv(blk.c2, f"body.{i}.body.2")
    cv(model.body_tail, f"body.{len(model.body)}")
    return model


# ------------------------------------------------------------- resnet stem

class FrozenBN(nn.Module):
    """Inference-mode batch norm (identity at init), the JAX package's
    ``scale``/``bias``/``mean``/``var``."""

    def __init__(self, c, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c, device=device))
        self.bias = nn.Parameter(torch.zeros(c, device=device))
        self.mean = nn.Parameter(torch.zeros(c, device=device))
        self.var = nn.Parameter(torch.ones(c, device=device))

    def forward(self, x, eps=1e-5):
        shape = (1, -1, 1, 1)
        inv = torch.rsqrt(self.var + eps)
        return ((x - self.mean.view(shape)) * inv.view(shape)
                * self.scale.view(shape) + self.bias.view(shape))


class BasicBlock(nn.Module):
    def __init__(self, width, generator=None, device=None):
        super().__init__()
        kw = dict(bias=False, generator=generator, device=device)
        self.c1 = init_conv(width, width, 3, **kw)
        self.bn1 = FrozenBN(width, device)
        self.c2 = init_conv(width, width, 3, **kw)
        self.bn2 = FrozenBN(width, device)


class ResNetExtractor(nn.Module):
    """ResNet-34 stem and layer 1: 7x7/2 conv, BN, ReLU, 3x3/2 max pool,
    then ``n_blocks`` basic blocks at ``width``."""

    def __init__(self, width=64, n_blocks=3, generator=None, device=None):
        super().__init__()
        self.stem = init_conv(3, width, 7, bias=False, generator=generator,
                              device=device)
        self.stem_bn = FrozenBN(width, device)
        self.blocks = nn.ModuleList(BasicBlock(width, generator, device)
                                    for _ in range(n_blocks))

    def forward(self, x):
        return resnet_extractor_apply(self, x)


def init_resnet_extractor(width=64, n_blocks=3, generator=None, device=None):
    return ResNetExtractor(width, n_blocks, generator, device)


def resnet_extractor_apply(model, x):
    """``x [N, 3, H, W]`` -> ``[N, width, H/4, W/4]``."""
    x = conv_apply(model.stem, x, stride=2)
    x = torch.relu(model.stem_bn(x))
    ph = same_pads(x.shape[-2], 3, 2)
    pw = same_pads(x.shape[-1], 3, 2)
    x = F.max_pool2d(F.pad(x, (pw[0], pw[1], ph[0], ph[1]),
                           value=-math.inf), 3, 2)
    for blk in model.blocks:
        h = torch.relu(blk.bn1(conv_apply(blk.c1, x)))
        h = blk.bn2(conv_apply(blk.c2, h))
        x = torch.relu(x + h)
    return x
