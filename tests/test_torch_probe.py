"""Kernel K-G (``directvoxgo_tpu_torch.ops.probe_ops``), the per-op cost
probe, through its plain version on the CPU, against the op bodies of the
JAX package's Mosaic probe (``tools/probe_mosaic.py``) written in
``jax.numpy`` on the same inputs: for every class, the digest of G=2 blocks
of R=2 reps, to 1e-5 of the sum of |output element| (f32 sums in another
order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from directvoxgo_tpu_torch.ops import probe_ops as kg
from directvoxgo_tpu_torch.tools import probe_ops as tool

F32 = jnp.float32


def _dg(a, b, contract, batch=((), ())):
    return jax.lax.dot_general(a, b, dimension_numbers=(contract, batch),
                               preferred_element_type=F32)


# The bodies of tools/probe_mosaic.py (rep i, then the inputs).
JAX_BODIES = {
    "null": lambda i, x, w: x * 1.0001,
    "b12": lambda i, a, w: _dg(a, w[i], ((2,), (1,)), ((0,), (0,))),
    "b8geo": lambda i, a, w: _dg(a, w[i], ((2,), (1,)), ((0,), (0,))),
    "lead": lambda i, x, w: _dg(x, w[i], ((0,), (0,))),
    "mm": lambda i, a, w: jax.lax.dot(a, w[i], preferred_element_type=F32),
    "mmT": lambda i, a, w: jax.lax.dot(a[i], w, preferred_element_type=F32),
    "small": lambda i, a, w: _dg(a, w[i], ((1,), (1,))),
    "acc": lambda i, x, w: x * w[i][None],
    "r3dot": lambda i, x, w: _dg(x, w[i], ((2,), (0,))),
    "r3f": lambda i, x, w: jax.lax.dot(x, w[i], preferred_element_type=F32),
    "vpu2d": lambda i, x, w: jnp.exp(x * w[i]),
    "vpu3d8": lambda i, x, w: jnp.exp(x * w[i]),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jnp(t):
    dtype = jnp.bfloat16 if t.dtype == torch.bfloat16 else F32
    return jnp.asarray(t.float().numpy(), dtype)


@pytest.mark.parametrize("name", list(kg.CLASSES))
def test_probe_plain_digest_matches_jax_bodies(name):
    g, reps = 2, 2
    x, w = tool.make_inputs(name, seed=3)
    terms = {}
    got = kg.probe(name, x, w, g, reps)
    assert got.shape == (g,) and got.dtype == torch.float64
    ref_plain = kg.probe_plain(name, x, w, g, reps, terms=terms)
    assert torch.equal(got, ref_plain)
    xj = _jnp(x)
    wj = None if w is None else _jnp(w)
    if name == "lead":   # the unpadded contraction over 12
        k = kg.K_TRUE[name]
        xj, wj = xj[:k], wj[:, :k]
    outs = [np.asarray(JAX_BODIES[name](i, xj, wj), np.float64)
            for i in range(reps)]
    ref = g * sum(o.sum() for o in outs)
    abs_sum = g * sum(np.abs(o).sum() for o in outs)
    assert terms["abs_sum"] == pytest.approx(abs_sum, rel=1e-5)
    assert abs(float(got.sum()) - ref) <= 1e-5 * abs_sum
    # The digest is not trivially small against its terms.
    assert abs_sum > 0.0


def test_probe_reps_read_their_own_weight_slice():
    """Rep i reads w[i]: a change to slice 1 moves the digest of two reps,
    not of one."""
    x, w = tool.make_inputs("mm")
    one = float(kg.probe("mm", x, w, 1, 1).sum())
    two = float(kg.probe("mm", x, w, 1, 2).sum())
    w2 = w.clone()
    w2[1] *= 2
    assert float(kg.probe("mm", x, w2, 1, 1).sum()) == one
    assert float(kg.probe("mm", x, w2, 1, 2).sum()) != two


def test_probe_checks_its_inputs():
    x, w = tool.make_inputs("b12")
    with pytest.raises(ValueError):
        kg.probe("b12", x[:, :64], w, 2)
    with pytest.raises(ValueError):
        kg.probe("b12", x.float(), w, 2)
    with pytest.raises(ValueError):
        kg.probe("b12", x, w, 2, reps=kg.R + 1)
    meta = torch.device("meta")
    with pytest.raises(ValueError):
        kg.probe("b12", torch.empty(x.shape, dtype=x.dtype, device=meta),
                 torch.empty(w.shape, dtype=w.dtype, device=meta), 2)


# Worked out by hand from tools/probe_mosaic.py's shapes (R = 8 weight
# slices, G = 512 blocks). Per op: (operand bytes, ((operations, unit),
# ...), bytes a block brings in per op with reps inner). A matmul moves
# 2*batch*(m*k + k*n) bytes and does 2*batch*m*n*k operations, lead at
# k = 12 (its 16 stored rows hold 4 of zeros).
OP_WORK = {
    "null": (8 * 128 * 4, ((2 * 8 * 128, "f32"),), 8 * 128 * 4),
    "b12": (983040, ((62914560, "bf16 tensor"),),
            12 * 128 * 160 * 2 // 8 + 12 * 160 * 128 * 2),
    "b8geo": (1146880, ((104857600, "bf16 tensor"),),
              8 * 128 * 160 * 2 // 8 + 8 * 160 * 320 * 2),
    "lead": (396288, ((50331648, "bf16 tensor"),),
             16 * 128 * 128 * 2 // 4 + 16 * 128 * 2),
    "mm": (655360, ((78643200, "bf16 tensor"),),
           128 * 160 * 2 // 8 + 160 * 1920 * 2),
    "mmT": (655360, ((78643200, "bf16 tensor"),),
            1920 * 160 * 2 + 160 * 128 * 2 // 8),
    "small": (81920, ((5242880, "bf16 tensor"),),
              128 * 160 * 2 // 8 + 128 * 160 * 2),
    "acc": (128 ** 3 * 2 + 128 * 2,
            ((128 ** 3, "bf16"), (2 * 128 ** 3, "bf16 tensor")),
            128 ** 3 * 2 // 8 + 128 * 2),
    "r3dot": (4227072, ((536870912, "bf16 tensor"),),
              128 ** 3 * 2 // 4 + 128 * 128 * 2),
    "r3f": (4227072, ((536870912, "bf16 tensor"),),
            128 ** 3 * 2 // 4 + 128 * 128 * 2),
    "vpu2d": (2 * 128 * 128 * 4, ((12 * 128 * 128, "f32"),
                                  (128 * 128, "sfu")),
              128 * 128 * 4 // 8 + 128 * 128 * 4),
    "vpu3d8": (2 * 8 * 128 * 128 * 4, ((12 * 8 * 128 * 128, "f32"),
                                       (8 * 128 * 128, "sfu")),
               8 * 128 * 128 * 4 // 8 + 8 * 128 * 128 * 4),
}
# One launch at G = 512 and the class's reps: x once, each rep's slice
# once, 512 f64 partials; and the operations of G * reps op bodies.
LAUNCH_BYTES = {"null": 8192, "b12": 4427776, "b8geo": 6885376,
                "lead": 544768, "mm": 4960256, "mmT": 4960256,
                "small": 372736, "acc": 4200448, "r3dot": 4329472,
                "r3f": 4329472, "vpu2d": 593920, "vpu3d8": 4722688}
# Peaks: HBM 3.35 TB/s; bf16 tensor 989 TFLOP/s; packed bf16 133.8; f32
# 67; the special-function units 16 a clock on each of 132 SMs at 1980 MHz.
PEAK = {"bf16 tensor": 989e12, "bf16": 133.8e12, "f32": 67e12,
        "sfu": 16 * 132 * 1980e6}


@pytest.mark.parametrize("name", list(kg.CLASSES))
def test_op_work_and_bound_by_hand(name):
    n_bytes, ops, per_block = OP_WORK[name]
    assert tool.op_work(name) == (n_bytes, ops)
    assert tool.block_bytes(name) == per_block
    reps = kg.CLASSES[name][3]
    t_bytes = LAUNCH_BYTES[name] / 3.35e12
    t_ops = max(512 * reps * n / PEAK[unit] for n, unit in ops)
    ms, by = tool.launch_bound(name, 512, reps)
    assert ms == pytest.approx(max(t_bytes, t_ops) * 1e3, rel=1e-12)
    assert by == ("bytes" if t_bytes >= t_ops else "operations")


@pytest.mark.parametrize("name", ["vpu2d", "vpu3d8"])
def test_exp_bound_carries_the_special_function_term(name):
    """An exp costs one special-function result (16 per SM per clock), and
    that term, not the f32 one, sets the exp classes' bound; it follows
    the SM clock. The old count (3 f32 operations an element at 67
    TFLOP/s) lies below it."""
    n_el = int(np.prod(kg.CLASSES[name][0]))
    ms, by = tool.launch_bound(name, 512, 8)
    sfu = 512 * 8 * n_el / (16 * 132 * 1980e6) * 1e3
    f32 = 512 * 8 * 12 * n_el / 67e12 * 1e3
    assert by == "operations"
    assert ms == pytest.approx(sfu, rel=1e-12) and sfu > f32
    assert 512 * 8 * 3 * n_el / 67e12 * 1e3 < ms
    assert tool.launch_bound(name, 512, 8, sm_mhz=990)[0] == pytest.approx(
        2 * ms, rel=1e-12)


@pytest.mark.parametrize("name", list(kg.CLASSES))
def test_first_version_takes_the_same_inputs(name):
    """The first version's entry takes the inputs of :data:`CLASSES` as the
    redesign's does, and refuses the same wrong ones."""
    x, w = tool.make_inputs(name, seed=5)
    got = kg.probe(name, x, w, 3)
    assert torch.equal(kg.probe_first(name, x, w, 3), got)
    assert torch.equal(got, kg.probe_plain(name, x, w, 3))
    bad = x.float() if x.dtype == torch.bfloat16 else x.to(torch.bfloat16)
    for entry in (kg.probe, kg.probe_first):
        with pytest.raises(ValueError):
            entry(name, bad, w, 3)
        with pytest.raises(ValueError):
            entry(name, x, w, 3, reps=kg.R + 1)


def test_device_timer_refuses_the_cpu():
    with pytest.raises(ValueError):
        tool.device_time(lambda: None, torch.device("cpu"), 1)


def _walk_plan(name, x, w, reps):
    """The kernel's loop for a matmul class, walked from its plan alone:
    the held and streamed tiles at the plan's offsets, each step's products
    (every held tile of B against the A tile), summed in f64. Returns
    (digest, operations run)."""
    p = kg.gemm_plan(name, reps)
    a_flat, b_flat = x.double().reshape(-1), w.double().reshape(-1)
    a_tile = (p["a_rows"], p["a_cols"], p["lda"])
    b_tile = (p["b_rows"], p["b_cols"], p["ldb"])
    (s_flat, s_tile), (h_flat, h_tile) = (
        ((a_flat, a_tile), (b_flat, b_tile)) if p["a_streamed"]
        else ((b_flat, b_tile), (a_flat, a_tile)))

    def tile(flat, off, shape):
        rows, cols, ld = shape
        return flat[off + torch.arange(rows)[:, None] * ld
                    + torch.arange(cols)[None, :]]

    def as_a(t):                    # [mt, k]
        return t.t() if p["a_mn"] else t

    def as_b(t):                    # [k, n]
        return t if p["b_mn"] else t.t()

    digest, ops = 0.0, 0
    for o in range(p["n_o"]):
        held = [tile(h_flat, o * p["h_so"] + h * p["h_sh"], h_tile)
                for h in range(p["n_h"])]
        for j in range(p["n_j"]):
            st = tile(s_flat, o * p["s_so"] + j // p["s_jdiv"] * p["s_sj1"]
                      + j % p["s_jdiv"] * p["s_sj2"], s_tile)
            a, bs = ((as_a(st), [as_b(t) for t in held]) if p["a_streamed"]
                     else (as_a(held[0]), [as_b(st)]))
            assert a.shape == (p["mt"], p["k"])
            for b in bs:
                assert b.shape == (p["k"], p["n"])
                digest += float((a @ b).sum())
                ops += 2 * p["mt"] * p["n"] * p["k"]
    return digest, ops


@pytest.mark.parametrize("name", [n for n, c in kg.CLASSES.items()
                                  if c[4][0] == "gemm"])
def test_gemm_plan_runs_every_product_once(name):
    """The plan the kernel walks covers each rep's full product exactly
    once (every tile, every rep: no sum of the w[i] first, nothing
    skipped), fits the block's shared memory with a ring of two stages or
    more, and its digest is the plain version's."""
    reps = kg.CLASSES[name][3]
    x, w = tool.make_inputs(name, seed=7)
    p = kg.gemm_plan(name, reps)
    assert 2 <= p["stages"] <= kg.MAX_STAGES
    assert kg.plan_smem(p) <= kg.SMEM_LIMIT
    assert p["n"] <= 256 and p["mt"] % 128 == 0 and p["k"] % 16 == 0
    assert p["a_cols"] % (p["a_sw"] // 2) == 0
    assert p["b_cols"] % (p["b_sw"] // 2) == 0
    digest, ops = _walk_plan(name, x, w, reps)
    batch, m, n, k = kg.CLASSES[name][4][1:5]
    assert ops == reps * 2 * batch * m * n * k
    terms = {}
    ref = float(kg.probe_plain(name, x, w, 1, reps, terms=terms).sum())
    assert abs(digest - ref) <= 1e-5 * terms["abs_sum"]
