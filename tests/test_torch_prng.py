"""The port's copy of the JAX random stream (``models/prng.py``) against
``jax.random`` on the CPU, bit for bit, and every model's and module's
initial parameters against the JAX package's from the same seed keyword or
key, bit for bit, through ``convert``.

The port imports no JAX: its models draw from ``prng_key(seed)`` as the
JAX models draw from ``PRNGKey(seed)`` (``MultiSceneImplicitDVGO`` from
``seed + 7`` for its NeRF MLP, ``TriDVGOMultiScene`` from ``seed + 11``
and its ``fold_in`` 1, 2 and 3 for its own heads).
"""

import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from directvoxgo_tpu.models import backbone as jax_bb
from directvoxgo_tpu.models import mlp as jax_mlp
from directvoxgo_tpu.models import nets as jax_nets
from directvoxgo_tpu.models.dmpigo import DirectMPIGO as JaxDMPIGO
from directvoxgo_tpu.models.dvgo import DirectVoxGO as JaxDVGO
from directvoxgo_tpu.models.dvgo_multiscene import (
    DirectVoxGOMultiScene as JaxDVGOMS)
from directvoxgo_tpu.models.multiscene_dvgo import (
    MultiSceneImplicitDVGO as JaxImplicit)
from directvoxgo_tpu.models.sr_dvgo import SRDVGO as JaxSR
from directvoxgo_tpu.models.tri_dvgo import TriDVGO as JaxTri
from directvoxgo_tpu.models.tri_dvgo_multiscene import (
    TriDVGOMultiScene as JaxTriMS)
from directvoxgo_tpu_torch import convert
from directvoxgo_tpu_torch.models import backbone as bb
from directvoxgo_tpu_torch.models import mlp as torch_mlp
from directvoxgo_tpu_torch.models import nets
from directvoxgo_tpu_torch.models import prng
from directvoxgo_tpu_torch.models.dmpigo import DirectMPIGO
from directvoxgo_tpu_torch.models.dvgo import DirectVoxGO
from directvoxgo_tpu_torch.models.dvgo_multiscene import DirectVoxGOMultiScene
from directvoxgo_tpu_torch.models.multiscene_dvgo import (
    MultiSceneImplicitDVGO)
from directvoxgo_tpu_torch.models.sr_dvgo import SRDVGO
from directvoxgo_tpu_torch.models.tri_dvgo import TriDVGO
from directvoxgo_tpu_torch.models.tri_dvgo_multiscene import (
    TriDVGOMultiScene)

SEEDS = [0, 7, 11, 2 ** 31 - 1]


def _bits(x):
    """An array's dtype, shape and bytes (bit-for-bit comparisons)."""
    x = np.asarray(x)
    return x.dtype.str, x.shape, x.tobytes()


# ------------------------------------------------------------ the stream

@pytest.mark.parametrize("seed", SEEDS + [2 ** 31, 2 ** 32 + 5, -3])
def test_prng_key_matches_jax(seed):
    assert _bits(prng.prng_key(seed)) == _bits(jax.random.PRNGKey(seed))


@pytest.mark.parametrize("num", [2, 6])
def test_split_matches_jax(num):
    for seed in SEEDS:
        key = jax.random.PRNGKey(seed)
        assert _bits(prng.split(prng.prng_key(seed), num)) == _bits(
            jax.random.split(key, num)), seed
        sub = np.asarray(jax.random.split(key, 3)[2])
        assert _bits(prng.split(sub, num)) == _bits(
            jax.random.split(jnp.asarray(sub), num)), seed


@pytest.mark.parametrize("data", [1, 2, 3])
def test_fold_in_matches_jax(data):
    for seed in SEEDS:
        assert _bits(prng.fold_in(prng.prng_key(seed), data)) == _bits(
            jax.random.fold_in(jax.random.PRNGKey(seed), data)), seed


UNIFORM_SHAPES = [(0,), (1,), (37,), (3, 3, 5, 4), (27, 16), ()]


@pytest.mark.parametrize("shape", UNIFORM_SHAPES,
                         ids=lambda s: "x".join(map(str, s)) or "scalar")
def test_uniform_matches_jax(shape):
    """With the f32 bound of ``init_linear`` (``1 / jnp.sqrt``), the f64
    one of ``init_conv`` (``1 / math.sqrt``), and ``[0, 1)``."""
    for seed in SEEDS:
        key = jax.random.PRNGKey(seed)
        for fan_in in (1, 27, 39, 576):
            b32 = 1.0 / jnp.sqrt(fan_in)
            assert _bits(prng.linear_bound(fan_in)) == _bits(b32), fan_in
            b64 = 1.0 / math.sqrt(fan_in)
            for lo, hi in ((-b32, b32), (-b64, b64)):
                want = jax.random.uniform(key, shape, jnp.float32, lo, hi)
                got = prng.uniform(prng.prng_key(seed), shape,
                                   np.float32(lo), np.float32(hi))
                assert _bits(got) == _bits(want), (seed, fan_in)
        assert _bits(prng.uniform(prng.prng_key(seed), shape)) == _bits(
            jax.random.uniform(key, shape, jnp.float32))


def test_fma32_matches_the_contracted_product_and_sum():
    """``a * b + c`` jitted by XLA on the CPU is one fused multiply-add
    (the scale and shift of ``jax.random.uniform``); :func:`prng.fma32`
    gives it bit for bit, where numpy's two roundings differ."""
    rng = np.random.default_rng(0)
    a, b, c = (rng.uniform(-1, 1, 1 << 16).astype(np.float32)
               for _ in range(3))
    want = np.asarray(jax.jit(lambda x, y, z: x * y + z)(a, b, c))
    assert _bits(prng.fma32(a, b, c)) == _bits(want)
    assert np.sum(a * b + c != want) > 0, "no double rounding to tell apart"


# ------------------------------------------------- modules and models

def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _same_tree(got, want, what=""):
    """Every array leaf of the JAX pytree ``want`` equal bit for bit to the
    leaf at its path in ``got`` (non-array leaves skipped)."""
    if isinstance(want, dict):
        for k, v in want.items():
            _same_tree(got[k], v, f"{what}.{k}")
    elif isinstance(want, (list, tuple)) and not (
            want and isinstance(want[0], (int, str))):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _same_tree(g, w, f"{what}[{i}]")
    elif hasattr(want, "shape") and getattr(want, "ndim", 0) > 0:
        assert _bits(np.asarray(got, np.float32)) == _bits(
            np.asarray(want, np.float32)), what


def _key(seed=3):
    return jax.random.PRNGKey(seed), prng.prng_key(seed)


def _net(name):
    """(JAX pytree, port module) built from one key at narrow widths."""
    jk, tk = _key()
    if name == "mlp":
        return (jax_mlp.init_mlp(jk, 9, 16, 3, 3),
                torch_mlp.MLP(9, 16, 3, 3, key=tk))
    if name == "nerf_mlp":
        return (jax_nets.init_nerf_mlp(jk, D=4, W=32, input_ch=12,
                                       input_ch_views=6, skips=(1,)),
                nets.NerfMLP(4, 32, 12, 6, (1,), key=tk))
    if name == "mapping":
        return (jax_nets.init_mapping(jk, 24, 4, depth=3, width=16),
                nets.Mapping(24, 4, 3, 16, key=tk))
    if name == "interp":
        return (jax_nets.init_interp_mlp(jk, 8, 4, width=16, depth=4),
                nets.InterpMLP(8, 4, 16, 4, key=tk))
    if name == "conv_mapping":
        return (jax_nets.init_conv_mapping(jk, 24, 4, n_resblocks=2),
                nets.ConvMapping(24, 4, 3, 2, key=tk))
    if name == "siren":
        return (jax_nets.init_siren_rgb_net(jk, 3, 8, 16),
                nets.SirenRgbNet(3, 8, 16, key=tk))
    if name == "nl_block":
        return (jax_nets.init_nl_block(jk, 8, 1),
                nets.NLBlock(8, 1, key=tk))
    if name == "attention":
        return (jax_nets.init_scaled_product_attention(jk, 16, 2),
                nets.ScaledProductAttention(16, 2, key=tk))
    if name == "split_rgbnet":
        return (jax_nets.init_split_rgbnet(jk, 12, vox_dim=8, width=32),
                nets.SplitRgbnet(12, 8, 32, key=tk))
    if name in ("edsr", "edsr_up"):
        up = name == "edsr_up"
        return (jax_bb.make_edsr_baseline(
                    jk, n_resblocks=2, n_feats=8, n_colors=3 if up else 9,
                    no_upsampling=not up, scale=4)[0],
                bb.EDSR(2, 8, 3 if up else 9, 4, no_upsampling=not up,
                        key=tk))
    if name == "resnet":
        return (jax_bb.init_resnet_extractor(jk, width=8, n_blocks=2),
                bb.ResNetExtractor(8, 2, key=tk))
    raise KeyError(name)


NETS = ["mlp", "nerf_mlp", "mapping", "interp", "conv_mapping", "siren",
        "nl_block", "attention", "split_rgbnet", "edsr", "edsr_up",
        "resnet"]


@pytest.mark.parametrize("name", NETS)
def test_module_initial_params_match_jax(name):
    want, module = _net(name)
    _same_tree(convert.module_to_jax(module), _np(want), name)


@pytest.mark.parametrize("name", ["linear", "linear_zero_bias", "conv",
                                  "conv_no_bias", "siren_first"])
def test_layer_initializers_match_jax(name):
    jk, tk = _key(5)
    if name.startswith("linear"):
        zero = name.endswith("zero_bias")
        want = jax_mlp.init_linear(jk, 39, 7, zero_bias=zero)
        layer = torch_mlp.init_linear(39, 7, zero_bias=zero, key=tk)
        got = {"w": layer.weight.detach().numpy().T,
               "b": layer.bias.detach().numpy()}
    elif name.startswith("conv"):
        bias = name == "conv"
        want = jax_bb.init_conv(jk, 5, 6, 3, bias=bias)
        conv = bb.init_conv(5, 6, 3, bias=bias, key=tk)
        got = {"w": conv.weight.detach().numpy().transpose(2, 3, 1, 0)}
        if bias:
            got["b"] = conv.bias.detach().numpy()
    else:
        want = jax_nets.init_siren_layer(jk, 6, 16, is_first=True)
        layer = nets.init_siren_layer(6, 16, is_first=True, key=tk)
        got = {"w": layer.weight.detach().numpy().T,
               "b": layer.bias.detach().numpy()}
    _same_tree(got, _np(want), name)


BASE = dict(xyz_min=[-1, -1, -1], xyz_max=[1, 1, 1], num_voxels=16 ** 3,
            num_voxels_base=16 ** 3, alpha_init=1e-2)
SMALL = dict(rgbnet_dim=4, rgbnet_width=16, n_feats=8, n_resblocks=2,
             map_width=16, k_density=32, k_color=16)
MODELS = {
    "dvgo": (JaxDVGO, DirectVoxGO, dict(
        BASE, rgbnet_dim=6, rgbnet_depth=3, rgbnet_width=24, k_color=0)),
    "dvgo_posbase": (JaxDVGO, DirectVoxGO, dict(
        BASE, rgbnet_dim=6, rgbnet_width=24, posbase_pe=2, k_color=0,
        seed=5)),
    "dmpigo": (JaxDMPIGO, DirectMPIGO, dict(
        xyz_min=[-1, -1, -1], xyz_max=[1, 1, 1], num_voxels=16 * 16 * 8,
        mpi_depth=8, rgbnet_dim=6, rgbnet_depth=3, rgbnet_width=24,
        viewbase_pe=2, k_color=0)),
    "sr_dvgo": (JaxSR, SRDVGO, dict(BASE, rgbnet_dim=6, rgbnet_width=16,
                                    n_feats=8, n_resblocks=2)),
    "tri_dvgo": (JaxTri, TriDVGO, dict(BASE, **SMALL)),
    "tri_dvgo_liif": (JaxTri, TriDVGO, dict(
        BASE, **SMALL, liif=True, interp_width=16, interp_depth=3, seed=2)),
    "multiscene_implicit": (JaxImplicit, MultiSceneImplicitDVGO, dict(
        BASE, rgbnet_dim=4, rgbnet_depth=4, rgbnet_width=32, n_feats=8,
        n_resblocks=2, map_width=16, k_density=32)),
    "dvgo_multiscene": (JaxDVGOMS, DirectVoxGOMultiScene, dict(
        BASE, n_scene=2, rgbnet_dim=6, rgbnet_width=16, k_color=0)),
    "tri_multiscene": (JaxTriMS, TriDVGOMultiScene, dict(
        BASE, **SMALL, n_scene=2)),
    "tri_multiscene_conv_nl": (JaxTriMS, TriDVGOMultiScene, dict(
        BASE, **SMALL, n_scene=2, mlp_map=False, conv_map=True,
        use_nl=True)),
    "tri_multiscene_closed": (JaxTriMS, TriDVGOMultiScene, dict(
        BASE, **SMALL, n_scene=2, mlp_map=False, closed_map=True)),
    "tri_multiscene_anchor": (JaxTriMS, TriDVGOMultiScene, dict(
        BASE, **SMALL, n_scene=2, liif=True, use_anchor_liif=True,
        interp_width=16, interp_depth=3)),
}


@pytest.mark.parametrize("name", list(MODELS))
def test_model_initial_params_match_jax(name):
    """The port's model built from the JAX model's keywords (its default
    ``seed``, or the one given) starts from the JAX model's ``params``."""
    jcls, tcls, kw = MODELS[name]
    jm = jcls(**kw)
    tm = tcls(**kw, device="cpu")
    got, _ = convert.params_to_jax(tm)
    want = _np(jm.params)
    assert sorted(k for k, v in want.items() if v is not None) == sorted(
        k for k, v in got.items() if v is not None)
    _same_tree(got, want, name)


def test_port_models_draw_no_torch_random_state():
    """Building a model leaves torch's global random state alone."""
    state = torch.random.get_rng_state()
    TriDVGO(**BASE, **SMALL, device="cpu")
    assert torch.equal(state, torch.random.get_rng_state())
