"""The network zoo of the conditioned variants: the skip-connected NeRF MLP,
the pose-conditioned mapping (per pixel, and convolutional), the LIIF
decoder and its pretrained-weight import, SIREN layers, the non-local
block between feature and density maps, scaled-product attention and the
late-fusion split rgbnet.

Modules hold ``nn.Linear`` ([out, in]) and ``nn.Conv2d`` (OIHW) layers
under the JAX package's parameter names, so :mod:`..convert` carries the
JAX pytrees across by name; a module's non-array settings that the JAX
pytree keeps among its leaves (``dropout``, ``skips``, ...) are listed in
its ``JAX_EXTRAS``. Maps are NCHW. Each module draws its initial
parameters from a ``key`` of the JAX package's random stream
(:mod:`.prng`), split among its layers as the JAX ``init_*`` function
splits it, so a module built from a key equals the JAX pytree built from
it. Dropout runs only when a ``torch.Generator`` is passed as ``rng``, as
the JAX package's runs only with an rng key (its ``bernoulli`` draws are
not copied); no train step passes one, so it is inert on every path.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from . import prng
from .backbone import conv_apply, init_conv, max_pool2d
from .mlp import init_linear, set_param, skip_init


def _linear(layer, x):
    return F.linear(x, layer.weight, layer.bias)


def _dropout(x, rate, rng):
    if rng is None or rate <= 0:
        return x
    keep = (torch.rand(x.shape, generator=rng) < 1.0 - rate).to(x.device)
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def _to_nhwc(x):
    return x.permute(0, 2, 3, 1)


def _to_nchw(x):
    return x.permute(0, 3, 1, 2)


# ------------------------------------------------------------------ NeRF MLP

class NerfMLP(nn.Module):
    """Skip-connected NeRF MLP with density and colour heads."""

    JAX_EXTRAS = ("skips",)

    def __init__(self, D=8, W=256, input_ch=99, input_ch_views=27,
                 skips=(2,), key=None, device=None):
        super().__init__()
        keys = prng.split_keys(key, D + 5)

        def lin(cin, cout, zero_bias=False):
            return init_linear(cin, cout, zero_bias, next(keys), device)

        self.skips = tuple(int(s) for s in skips)
        pts = [lin(input_ch, W)]
        for i in range(D - 1):
            pts.append(lin(W + input_ch if i in self.skips else W, W))
        self.pts = nn.ModuleList(pts)
        self.views = lin(input_ch_views + W, W // 2)
        self.feature = lin(W, W)
        self.density = lin(W, 1)
        self.rgb = lin(W // 2, 3, zero_bias=True)


def nerf_mlp_apply(model, emb, viewemb):
    """(rgb logits, density) from the point and view embeddings. A skip
    concatenates the input into the next layer's input (none after the
    last layer)."""
    h = emb
    n_layers = len(model.pts)
    for i, layer in enumerate(model.pts):
        h = torch.relu(_linear(layer, h))
        if i in model.skips and i < n_layers - 1:
            h = torch.cat([emb, h], -1)
    density = _linear(model.density, h)
    feature = _linear(model.feature, h)
    h = torch.relu(_linear(model.views, torch.cat([feature, viewemb], -1)))
    return _linear(model.rgb, h), density


# ------------------------------------------------------------------ Mapping

class Mapping(nn.Module):
    """Per-pixel MLP over (feature, flattened 4x4 pose); ``in_dim``
    includes the 16 pose values."""

    JAX_EXTRAS = ("dropout",)

    def __init__(self, in_dim, out_dim=12, depth=1, width=64, dropout=0.1,
                 key=None, device=None):
        super().__init__()
        keys = prng.split_keys(key, depth + 1)
        self.dropout = float(dropout)
        hidden = [init_linear(in_dim, width, key=next(keys), device=device)]
        for _ in range(max(depth - 2, 0)):
            hidden.append(init_linear(width, width, key=next(keys),
                                      device=device))
        self.hidden = nn.ModuleList(hidden)
        self.out = init_linear(width, out_dim, key=next(keys), device=device)


def mapping_apply(model, feature, pose, rng=None):
    """``feature [N, C, H, W]`` and ``pose [N, 4, 4]`` -> ``[N, out, H,
    W]``."""
    n, _, h, w = feature.shape
    pose_map = pose.reshape(n, 1, 1, -1).expand(n, h, w, pose[0].numel())
    x = torch.cat([_to_nhwc(feature), pose_map], -1)
    x = torch.relu(_linear(model.hidden[0], x))
    for layer in model.hidden[1:]:
        x = _dropout(_linear(layer, x), model.dropout, rng)
        x = torch.relu(x)
    return _to_nchw(_linear(model.out, x))


# ---------------------------------------------------------------- Interp MLP

class InterpMLP(nn.Module):
    """The LIIF local-ensemble decoder: ``depth`` linear layers."""

    JAX_EXTRAS = ("dropout",)

    def __init__(self, in_dim, out_dim, width=128, depth=5, dropout=0.1,
                 key=None, device=None):
        super().__init__()
        keys = prng.split_keys(key, depth)
        dims = [in_dim] + [width] * (depth - 1) + [out_dim]
        self.dropout = float(dropout)
        self.layers = nn.ModuleList(
            init_linear(dims[i], dims[i + 1], key=next(keys), device=device)
            for i in range(depth))


def interp_mlp_apply(model, x, rng=None):
    layers = model.layers
    x = torch.relu(_linear(layers[0], x))
    for layer in layers[1:-1]:
        x = torch.relu(_dropout(_linear(layer, x), model.dropout, rng))
    return _linear(layers[-1], x)


def load_liif_state_dict(liif_path):
    """The 4 hidden linears of a pretrained LIIF checkpoint (a local torch
    file: ``model.sd.imnet.layers.{0,2,4,6}``) as ``{"weight", "bias"}``
    tensors ([out, in], as here)."""
    sd = torch.load(liif_path, map_location="cpu",
                    weights_only=True)["model"]["sd"]
    return [{"weight": sd[f"imnet.layers.{i}.weight"].detach().float(),
             "bias": sd[f"imnet.layers.{i}.bias"].detach().float()}
            for i in (0, 2, 4, 6)]


@torch.no_grad()
def apply_liif_sd_to_interp(interp, liif_layers):
    """Overwrite the first linears of ``interp`` with the LIIF layers
    (shape-checked); the output layer keeps its init."""
    layers = interp.layers
    for i, ll in enumerate(liif_layers):
        if i >= len(layers) - 1:
            break
        if tuple(layers[i].weight.shape) != tuple(ll["weight"].shape):
            raise ValueError(
                f"LIIF layer {i} shape {tuple(ll['weight'].shape[::-1])} "
                "does not match interp layer "
                f"{tuple(layers[i].weight.shape[::-1])}; check in_dim "
                "(feat_unfold/cell_decode) and interp_width")
        layers[i].weight.copy_(ll["weight"])
        layers[i].bias.copy_(ll["bias"])
    return interp


# -------------------------------------------------------------- ConvMapping

class ConvBlock(nn.Module):
    def __init__(self, c, ksize, keys, device=None):
        super().__init__()
        self.c1 = init_conv(c, c, ksize, key=next(keys), device=device)
        self.c2 = init_conv(c, c, ksize, key=next(keys), device=device)


class ConvMapping(nn.Module):
    """Convolutional pose warp: head conv, 2x2 max pool, residual blocks,
    output conv. ``in_dim`` includes the conditioning channels."""

    JAX_EXTRAS = ("dropout",)

    def __init__(self, in_dim, out_dim=12, ksize=3, n_resblocks=5,
                 dropout=0.1, key=None, device=None):
        super().__init__()
        keys = prng.split_keys(key, 2 + 2 * n_resblocks + 1)
        self.dropout = float(dropout)
        self.head = init_conv(in_dim, in_dim, ksize, key=next(keys),
                              device=device)
        self.blocks = nn.ModuleList(ConvBlock(in_dim, ksize, keys, device)
                                    for _ in range(n_resblocks))
        self.out = init_conv(in_dim, out_dim, ksize, key=next(keys),
                             device=device)


def conv_mapping_apply(model, feature, cond, rng=None):
    """``feature [N, C, H, W]``; ``cond`` a pose ``[N, 4, 4]`` (broadcast
    per pixel) or a map ``[N, Cc, H, W]``."""
    n, _, h, w = feature.shape
    if cond.dim() == 3:
        flat = cond.reshape(n, -1)
        cond = flat[:, :, None, None].expand(n, flat.shape[1], h, w)
    x = torch.cat([feature, cond], 1)
    x = max_pool2d(conv_apply(model.head, x), 2)
    for blk in model.blocks:
        hcv = _dropout(conv_apply(blk.c1, x), model.dropout, rng)
        hcv = conv_apply(blk.c2, torch.relu(hcv))
        x = x + _dropout(hcv, model.dropout, rng)
    return conv_apply(model.out, x)


# -------------------------------------------------------------------- SIREN

def init_siren_layer(in_f, out_f, w0=30.0, is_first=False, key=None,
                     device=None):
    layer = skip_init(nn.Linear, in_f, out_f, device=device)
    kw, kb = prng.split(prng.key_or_default(key))
    b = 1.0 / in_f if is_first else math.sqrt(6.0 / in_f) / w0
    set_param(layer.weight, prng.uniform(kw, (in_f, out_f), -b, b).T)
    bound = 1.0 / math.sqrt(in_f)
    set_param(layer.bias, prng.uniform(kb, (out_f,), -bound, bound))
    return layer


class SirenRgbNet(nn.Module):
    JAX_EXTRAS = ("w0",)

    def __init__(self, num_layers, input_dim, hidden_dim, w0=30.0,
                 key=None, device=None):
        super().__init__()
        keys = prng.split_keys(key, num_layers)
        self.w0 = float(w0)
        dims = [input_dim] + [hidden_dim] * (num_layers - 1) + [3]
        self.layers = nn.ModuleList(
            init_siren_layer(dims[i], dims[i + 1], w0, i == 0, next(keys),
                             device)
            for i in range(num_layers))


def siren_rgb_net_apply(model, x):
    for layer in model.layers[:-1]:
        x = torch.sin(model.w0 * _linear(layer, x))
    return _linear(model.layers[-1], x)


# ------------------------------------------------------- non-local attention

class NLBlock(nn.Module):
    """Non-local block attending features to the density map; the output
    conv starts at zero (the block is the identity at init). Keys: the
    JAX package's ``init_nl_block`` draws ``wz`` (then zeroed) first."""

    JAX_EXTRAS = ("mode", "inter")

    def __init__(self, feat_channels, density_channels, inter_channels=None,
                 mode="embedded", key=None, device=None):
        super().__init__()
        assert mode in ("embedded", "dot")
        k_wz, k_g, k_theta, k_phi = prng.split_keys(key, 4)
        self.mode = mode
        self.inter = inter_channels or max(feat_channels // 2, 1)
        self.g = init_conv(feat_channels, self.inter, 1, key=k_g,
                           device=device)
        self.theta = init_conv(feat_channels, self.inter, 1, key=k_theta,
                               device=device)
        self.phi = init_conv(density_channels, self.inter, 1, key=k_phi,
                             device=device)
        self.wz = init_conv(self.inter, feat_channels, 1, key=k_wz,
                            device=device)
        with torch.no_grad():
            self.wz.weight.zero_()
            self.wz.bias.zero_()


def nl_block_apply(model, x, density):
    """``x [N, C, H, W]`` features; ``density [N, Cd, Hd, Wd]``."""
    n, _, h, w = x.shape
    inter = model.inter

    def seq(t):
        return _to_nhwc(t).reshape(n, -1, inter)

    g_x = seq(max_pool2d(conv_apply(model.g, x), 2))
    theta = seq(conv_apply(model.theta, x))
    phi = seq(max_pool2d(conv_apply(model.phi, density), 2))
    f = torch.einsum("nqc,nkc->nqk", theta, phi)
    f = torch.softmax(f, -1) if model.mode == "embedded" else f / f.shape[-1]
    y = torch.einsum("nqk,nkc->nqc", f, g_x)
    y = _to_nchw(y.reshape(n, h, w, inter))
    return conv_apply(model.wz, y) + x


# ------------------------------------------------------ multihead attention

class ScaledProductAttention(nn.Module):
    JAX_EXTRAS = ("heads",)

    def __init__(self, embed_dim, num_heads=1, key=None, device=None):
        super().__init__()
        keys = prng.split_keys(key, 4)
        self.heads = int(num_heads)
        self.q = init_linear(embed_dim, embed_dim, key=next(keys),
                             device=device)
        self.k = init_linear(embed_dim, embed_dim, key=next(keys),
                             device=device)
        self.v = init_linear(embed_dim, embed_dim, key=next(keys),
                             device=device)
        self.o = init_linear(embed_dim, embed_dim, key=next(keys),
                             device=device)


def scaled_product_attention_apply(model, query, kv):
    """``query [Lq, N, E]``, ``kv [Lk, N, E]`` (sequence first)."""
    heads = model.heads
    dh = query.shape[-1] // heads

    def split(x):
        lq, n, _ = x.shape
        return x.reshape(lq, n, heads, dh).permute(1, 2, 0, 3)

    q = split(_linear(model.q, query))
    k = split(_linear(model.k, kv))
    v = split(_linear(model.v, kv))
    att = torch.softmax(torch.einsum("nhqd,nhkd->nhqk", q, k)
                        / math.sqrt(dh), -1)
    out = torch.einsum("nhqk,nhkd->nhqd", att, v)
    out = out.permute(2, 0, 1, 3).reshape(query.shape)
    return _linear(model.o, out)


# -------------------------------------------------------- split late-fusion

class SplitRgbnet(nn.Module):
    """pos/view head -> concat the voxel feature -> rgb."""

    def __init__(self, input_dim, vox_dim=64, width=128, depth=4,
                 key=None, device=None):
        super().__init__()
        keys = prng.split_keys(key, 5)

        def lin(cin, cout):
            return init_linear(cin, cout, key=next(keys), device=device)

        self.head = nn.ModuleList([lin(input_dim, width), lin(width, width),
                                   lin(width, width - vox_dim)])
        self.mid = lin(width, width)
        self.rgb = lin(width, 3)


def split_rgbnet_apply(model, pos_view, vox):
    h = pos_view
    for layer in model.head:
        h = torch.relu(_linear(layer, h))
    h = torch.relu(_linear(model.mid, torch.cat([h, vox], -1)))
    return _linear(model.rgb, h)
