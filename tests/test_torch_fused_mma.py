"""The host side of the fused train-step kernels K-D and K-E
(``ops/train_fused.py``, ``csrc/train_fused*.cu``) on the CPU: the operands
the kernels read, held against the weights and the JAX package's own
operands; the C entry points and their diagnostic ``mode``; the scratch
``t_chk`` against the JAX kernel's; and the hi + lo bf16 split through which
K-E sums ``d_sh1`` on the tensor cores, held against the f32 sum of the
plain version.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from directvoxgo_tpu.ops import pallas_train_fused as ptf
from directvoxgo_tpu_torch.ops import _build
from directvoxgo_tpu_torch.ops import train_fused as tf

BF16 = torch.bfloat16


@pytest.mark.parametrize("width,fdim", [(32, 12), (64, 9), (128, 12)])
def test_kernel_operands_follow_the_weights(width, fdim):
    """``_kernel_operands``: sh1 per ray, w1a padded to 16 input rows, w3
    and b3 to 16 output columns with zeros, unpacked independently and held
    against the weights and against the JAX package's ``_mlp_operands``
    (which pads to 8 columns)."""
    rng = np.random.default_rng(width + fdim)
    n = 64
    w0 = rng.normal(size=(fdim + 27, width)).astype(np.float32)
    w1 = rng.normal(size=(width, width)).astype(np.float32)
    w2 = rng.normal(size=(width, 3)).astype(np.float32)
    b = [rng.normal(size=d).astype(np.float32) for d in (width, width, 3)]
    sh1_t = torch.tensor(rng.normal(size=(width, n)).astype(np.float32))
    w1a, w2o, w3 = tf.mlp_operands(torch.tensor(w0).t(), torch.tensor(w1).t(),
                                   torch.tensor(w2).t(), fdim)
    sh1, w1a_p, w3_p, b3_p = tf._kernel_operands(sh1_t, w1a, w3,
                                                 torch.tensor(b[2]))
    assert sh1.is_contiguous() and torch.equal(sh1, sh1_t.t())
    assert w1a_p.shape == (16, width) and w1a_p.dtype == BF16
    assert torch.equal(w1a_p[:fdim], torch.tensor(w0[:fdim]).to(BF16))
    assert not w1a_p[fdim:].float().any()
    assert w3_p.shape == (width, 16) and w3_p.dtype == BF16
    assert torch.equal(w3_p[:, :3], torch.tensor(w2).to(BF16))
    assert not w3_p[:, 3:].float().any()
    assert torch.equal(b3_p[:3], torch.tensor(b[2])) and not b3_p[3:].any()
    rgbnet = {"layers": [{"w": jnp.asarray(w), "b": jnp.asarray(bb)}
                         for w, bb in zip((w0, w1, w2), b)]}
    j_w1a, j_w2, _, j_w3p, _ = ptf._mlp_operands(rgbnet, fdim, width)
    f32 = lambda x: np.asarray(jnp.asarray(x, jnp.float32))  # noqa: E731
    np.testing.assert_array_equal(w1a_p[:fdim].float().numpy(), f32(j_w1a))
    np.testing.assert_array_equal(w2o.float().numpy(), f32(j_w2))
    np.testing.assert_array_equal(w3_p[:, :8].float().numpy(), f32(j_w3p))


def _constants(path):
    src = open(path).read()
    return {m.group(1): int(m.group(2)) for m in re.finditer(
        r"constexpr int (MODE_\w+) = (\d+);", src)}


def test_modes_match_the_kernel_headers():
    """The diagnostic forms the wrappers name are the bits both the
    kernels and their first versions read."""
    want = {"MODE_NO_MLP": tf.MODE_NO_MLP,
            "MODE_NO_SCATTER": tf.MODE_NO_SCATTER,
            "MODE_NO_PHASE2": tf.MODE_NO_PHASE2,
            "MODE_GATES": tf.MODE_GATES}
    for header in ("train_fused.cuh", "train_fused_first.cuh"):
        assert _constants(f"{_build.CSRC}/{header}") == want, header
    assert len(set(want.values())) == 4 and all(
        v & (v - 1) == 0 for v in want.values())


def test_entry_points_take_a_mode(monkeypatch):
    """K-D's and K-E's C entry points, and their first versions', end in
    (mode, stream); the wrappers and ``chip_smoke.py`` declare every
    argument of the prototypes."""
    import types
    import chip_smoke

    def fake_load(name):
        src = open(f"{_build.CSRC}/{name}.cu").read()
        c_api = src[src.index('extern "C"'):]
        fns = {m.group(1): m.group(2) for m in re.finditer(
            r"^\S.*?\b(dvgo_\w+)\(([^)]*)\)\s*\{", c_api, re.M | re.S)}
        lib = types.SimpleNamespace(**{f: types.SimpleNamespace()
                                       for f in fns})
        lib.prototypes = fns
        return lib

    monkeypatch.setattr(_build, "load", fake_load)
    libs = {"fwd": tf._lib_fwd(), "bwd": tf._lib_bwd(),
            "fwd_first": chip_smoke._prev_lib("train_fused_fwd_first")[0],
            "bwd_first": chip_smoke._prev_lib("train_fused_bwd_first")[0]}
    for name, lib in libs.items():
        fn = "dvgo_train_fused_" + name[:3]
        params = [p.split()[-1].strip("*")
                  for p in lib.prototypes[fn].split(",") if p.strip()]
        assert params[-2:] == ["mode", "stream"], name
        assert len(getattr(lib, fn).argtypes) == len(params), name
        assert len(params) == (31 if name.startswith("fwd") else 42), name


def test_modes_are_refused_on_the_cpu():
    """A diagnostic form exists only as a kernel: the plain versions do not
    pretend to run it."""
    cfg = tf.FusedCfg(k=2, f=9, width=32, act_shift=-4.0, thres=1e-4,
                      bg=1.0, direct=False)
    n, s = 512, 7
    slabs = torch.zeros((s, 8, 8, 14), dtype=BF16)
    args = [slabs, torch.zeros((16, n)), torch.zeros((32, n)),
            torch.zeros((9, 32), dtype=BF16), torch.zeros((32, 32),
                                                          dtype=BF16),
            torch.zeros(32), torch.zeros((32, 3), dtype=BF16),
            torch.zeros(3), False, None]
    with pytest.raises(ValueError, match="diagnostic"):
        tf.train_fwd(*args, cfg=cfg, mode=tf.MODE_NO_MLP)
    with pytest.raises(ValueError, match="diagnostic"):
        tf.train_bwd(*args[:2], torch.zeros((8, n)), *args[2:], cfg=cfg,
                     gp=4, mode=tf.MODE_NO_PHASE2)


@pytest.mark.parametrize("desc,windowed", [(False, False), (True, True)])
def test_block_entry_t_matches_the_jax_kernels(desc, windowed):
    """What K-E keeps in its scratch ``t_chk`` (T entering every active
    march block, from the same recursion as the plain version's march) is
    what the JAX kernel keeps in row 0 of its ``t_chk``, within 2e-6 (T is
    at most 1; the two frameworks' exp and log1p differ in the last
    bits)."""
    from tests.test_torch_fused import _jax_forward, _kernel_inputs, \
        _port_operands
    win = (16, 16) if windowed else (0, 0)
    d = _kernel_inputs(7, 1024, True, desc)
    _, _, res = _jax_forward(d, *win)
    j_tchk = np.asarray(res[1])[:, 0]                    # [nsb, N]
    cfg, args, _ = _port_operands(d, *win)
    st = tf._March(args[0], args[1], cfg, desc, args[9])
    t_in = st.t_in[::cfg.s_blk].numpy()                  # [nsb, N]
    active = np.ones_like(t_in, dtype=bool)
    if windowed:
        cells = args[9][..., 2].numpy() != 0             # [nsb, N // nt]
        active = np.repeat(cells, cfg.nt, axis=1)
    assert active.any() and (t_in[active] < 1.0).any()
    np.testing.assert_allclose(t_in[active], j_tchk[active], rtol=0,
                               atol=2e-6)


@pytest.mark.parametrize("width", [32, 128])
def test_hi_lo_split_keeps_the_f32_sum(width):
    """K-E sums d_sh1 over a chunk's rows as a bf16 product: the one-hot
    [ray, row] matrix times hi = rnd(d_h1) plus times lo = rnd(d_h1 - hi),
    with f32 sums. That is the plain version's f32 ``index_add_`` within
    2^-16 of the largest term (each term within 2^-18 of itself), where hi
    alone is off by 2^-9."""
    g = torch.Generator().manual_seed(width)
    rows, rays = 64 * 6, 64
    ray = torch.randint(0, rays, (rows,), generator=g)
    ray[::7] = -1                                        # padding rows
    d_h1 = torch.randn((rows, width), generator=g) * torch.exp(
        torch.randn((rows, 1), generator=g) * 2)
    d_h1 = torch.where(torch.rand((rows, width), generator=g) < 0.4,
                       torch.zeros_like(d_h1), d_h1)     # the ReLU mask
    keep = ray >= 0
    want = torch.zeros((rays, width)).index_add_(0, ray[keep], d_h1[keep])
    hi = d_h1.to(BF16)
    lo = (d_h1 - hi.float()).to(BF16)
    onehot = (ray[None, :] == torch.arange(rays)[:, None]).to(BF16)
    got = torch.zeros((rays, width))
    for c in range(0, rows, 64):                         # chunk by chunk
        sl = slice(c, c + 64)
        got += onehot[:, sl].float() @ hi[sl].float() \
            + onehot[:, sl].float() @ lo[sl].float()
    scale = float(d_h1.abs().max())
    assert float((got - want).abs().max()) <= scale * 2.0 ** -16
    hi_only = torch.zeros((rays, width))
    hi_only.index_add_(0, ray[keep], hi[keep].float())
    assert float((hi_only - want).abs().max()) > scale * 2.0 ** -16
