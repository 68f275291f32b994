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
