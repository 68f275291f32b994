"""The port's TV stencil (``ops/tv.py``, the plain version of kernel K-F)
against the JAX package on the CPU: the whole-grid form against
``total_variation_add_grad`` and the Pallas row kernel ``_tv_rows_pallas``
in interpret mode, and the boxed form against the halo construction of the
JAX engine's sparse-TV step. Inputs are made with numpy from a seed. The
kernel itself runs only on the card (``chip_smoke.py``); here a tensor
that is neither on the CPU nor on a CUDA device is refused, never rerouted
to the plain body.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from directvoxgo_tpu.ops import tv as jax_tv
from directvoxgo_tpu_torch.ops import tv as torch_tv

# Anisotropic weights, as DMPIGO's wxy / wz: here bug_compat matters.
W = (0.9, 0.5, 0.2)


def _inputs(seed, shape, sparse_share=0.5):
    rng = np.random.default_rng(seed)
    param = (rng.normal(size=shape) * 0.8).astype(np.float32)
    grad = (rng.normal(size=shape)
            * (rng.uniform(size=shape) < sparse_share)).astype(np.float32)
    return param, grad


@pytest.mark.parametrize("bug_compat", [True, False])
@pytest.mark.parametrize("dense", [True, False])
@pytest.mark.parametrize("shape", [(9, 7, 8), (9, 7, 8, 3)])
def test_plain_tv_matches_jax_and_pallas_interpret(shape, dense, bug_compat):
    """The plain whole-grid form against JAX's ``total_variation_add_grad``
    and against ``_tv_rows_pallas(interpret=True)`` (which takes the
    per-axis weights already divided by 6, the x one chosen by
    ``bug_compat``): within 1e-6 of the largest |TV| entry (f32 sums of six
    terms, possibly in another order), and in sparse mode exactly the
    gradient wherever it is zero."""
    param, grad = _inputs(1, shape)
    out = torch_tv.total_variation_add_grad(
        torch.tensor(param), torch.tensor(grad), *W, dense,
        bug_compat).numpy()
    ref = np.asarray(jax_tv.total_variation_add_grad(
        jnp.asarray(param), jnp.asarray(grad), *W, dense, bug_compat))
    wx, wy, wz = (w / 6.0 for w in W)
    pallas = np.asarray(jax_tv._tv_rows_pallas(
        jnp.asarray(param), jnp.asarray(grad), wz if bug_compat else wx, wy,
        wz, dense, interpret=True))
    scale = np.abs(ref - grad).max()
    assert scale > 1e-3
    for other in (ref, pallas):
        assert np.abs(out - other).max() <= 1e-6 * scale
        np.testing.assert_array_equal(out == 0, other == 0)
    if not dense:
        off = grad == 0
        assert off.any() and np.array_equal(out[off], grad[off])
    if bug_compat:
        # the quirk is visible with these weights
        plain = torch_tv.total_variation_add_grad(
            torch.tensor(param), torch.tensor(grad), *W, dense,
            False).numpy()
        assert np.abs(plain - out).max() > 1e-3 * scale


def _jax_boxed(param, grad_box, offs, sizes):
    """The JAX engine's boxed sparse-TV construction (engine/train.py,
    make_train_step): the term on a 1-voxel-haloed dynamic slice of the
    full grid, cropped to the box, gated by the box gradient."""
    full = jnp.asarray(param)
    g3 = tuple(int(d) for d in full.shape[:3])
    hs = tuple(min(s + 2, g) for s, g in zip(sizes, g3))
    start = tuple(jnp.clip(o - 1, 0, g - h) for o, g, h in zip(offs, g3, hs))
    tail = [jnp.int32(0)] * (full.ndim - 3)
    halo = jax.lax.dynamic_slice(full, (*start, *tail),
                                 (*hs, *full.shape[3:]))
    tv_h = jax_tv.tv_term(halo, *W)
    j = tuple(o - s for o, s in zip(offs, start))
    tv_box = jax.lax.dynamic_slice(tv_h, (*j, *tail),
                                   (*sizes, *full.shape[3:]))
    g = jnp.asarray(grad_box)
    return np.asarray(g + jnp.where(g != 0, tv_box, 0.0))


@pytest.mark.parametrize("shape", [(10, 8, 9), (10, 8, 9, 2)])
@pytest.mark.parametrize("offs,sizes,faces", [
    ((2, 2, 3), (5, 4, 4), 0),      # inside the grid
    ((0, 3, 2), (4, 3, 5), 1),      # on the x = 0 face
    ((6, 0, 5), (4, 5, 4), 3),      # on the x = max, y = 0 and z = max faces
])
def test_boxed_tv_matches_jax_halo(shape, offs, sizes, faces):
    """``tv_add_grad_box`` against the JAX halo construction, and against
    the box of the whole-grid form over a gradient that is zero outside
    the box: neighbours of the box's border voxels come from the grid,
    edge replication only at the grid border. Dense mode too, against the
    whole-grid dense form's box."""
    touched = sum((o == 0) + (o + s == g)
                  for o, s, g in zip(offs, sizes, shape[:3]))
    assert touched == faces
    param, grad = _inputs(2, shape)
    box = tuple(slice(o, o + s) for o, s in zip(offs, sizes))
    grad_box = np.ascontiguousarray(grad[box])
    out = torch_tv.tv_add_grad_box(torch.tensor(param),
                                   torch.tensor(grad_box), offs, *W).numpy()
    ref = _jax_boxed(param, grad_box, offs, sizes)
    full_g = np.zeros_like(grad)
    full_g[box] = grad_box
    whole = torch_tv.total_variation_add_grad(
        torch.tensor(param), torch.tensor(full_g), *W, False).numpy()[box]
    scale = np.abs(ref - grad_box).max()
    assert scale > 1e-3
    assert np.abs(out - ref).max() <= 1e-6 * scale
    np.testing.assert_array_equal(out, whole)
    np.testing.assert_array_equal(out == 0, ref == 0)
    dense = torch_tv.tv_add_grad_box(torch.tensor(param),
                                     torch.tensor(grad_box), offs, *W,
                                     dense_mode=True).numpy()
    np.testing.assert_array_equal(dense, torch_tv.total_variation_add_grad(
        torch.tensor(param), torch.tensor(full_g), *W, True).numpy()[box])


@pytest.mark.parametrize("boxed", [False, True])
def test_tv_refuses_tensors_off_the_cpu_and_cuda(boxed):
    """A tensor that is not on the CPU takes the kernel's path, which
    checks its arguments and refuses a device other than CUDA: the plain
    body never runs for it."""
    meta = torch.device("meta")
    p = torch.empty((4, 5, 6, 2), device=meta)
    with pytest.raises(ValueError, match="CUDA"):
        if boxed:
            torch_tv.tv_add_grad_box(p, torch.empty((2, 2, 2, 2),
                                                    device=meta),
                                     (1, 1, 1), *W)
        else:
            torch_tv.total_variation_add_grad(p, torch.empty_like(p), *W,
                                              True)


@pytest.mark.parametrize("case,expected", [
    # (dims, c, offs, sizes, g_strides, p_address)
    (((4, 5, 8), 3, (0, 0, 0), (4, 5, 8), (120, 24, 3, 1), 64), True),
    (((4, 5, 8), 1, (1, 2, 4), (2, 3, 4), (12, 4, 1, 1), 0), True),
    # z-major, as autograd permutes the sweep's gradient of an MPI grid
    (((4, 5, 8), 3, (0, 0, 0), (4, 5, 8), (15, 3, 60, 1), 0), True),
    # a channel slice
    (((4, 5, 8), 3, (0, 0, 0), (4, 5, 8), (240, 48, 6, 2), 0), False),
    # a gap between rows (a box view of a larger gradient)
    (((4, 5, 8), 3, (0, 0, 4), (4, 5, 4), (120, 24, 3, 1), 0), False),
    (((4, 5, 8), 3, (0, 0, 1), (4, 5, 4), (60, 12, 3, 1), 0), False),
    (((4, 5, 8), 3, (0, 0, 0), (4, 5, 5), (75, 15, 3, 1), 0), False),
    (((4, 5, 7), 1, (0, 0, 0), (4, 5, 4), (20, 4, 1, 1), 0), False),
    (((4, 5, 8), 36, (0, 0, 0), (4, 5, 8), (1440, 288, 36, 1), 0), False),
    (((4, 5, 8), 3, (0, 0, 0), (4, 5, 8), (120, 24, 3, 1), 8), False),
    (((1, 5, 8), 4, (0, 0, 0), (1, 5, 8), (7, 32, 4, 1), 0), True),
    (((2048, 1024, 1024), 1, (0, 0, 0), (2, 2, 4), (8, 4, 1, 1), 0),
     False),
])
def test_rows_path_rule(case, expected):
    """K-F's rows path (x-marching tiles, 16-byte vectors) only for a dense
    gradient with its channels innermost (contiguous or axis-permuted; a
    size-1 axis may have any stride), aligned runs of the flat (z, c) axis
    in the grid and the box, at most 32 channels, a 16-byte aligned p and a
    grid under 2^31 elements; the strided path otherwise."""
    assert torch_tv.rows_path(*case) is expected


def test_path_of_tensors():
    """The path picked for the tensors the engine hands over: a whole
    grid's contiguous gradient and the sweep's z-major permuted one take
    the rows path, autograd's channel slice and a view of a box of the
    gradient the strided one, the box's own contiguous gradient at an
    aligned offset the rows path."""
    p = torch.zeros((6, 5, 8, 3))
    g = torch.zeros((6, 5, 8, 6))
    assert torch_tv.path_of(p, torch.zeros_like(p)) == "rows"
    z_major = torch.zeros((8, 6, 5, 3)).permute(1, 2, 0, 3)
    assert torch_tv.path_of(p, z_major) == "rows"
    assert torch_tv.path_of(p, g[..., 1::2]) == "strided"
    box = torch.zeros_like(p)[1:4, 1:3, 4:8]
    assert torch_tv.path_of(p, box, (1, 1, 4)) == "strided"
    assert torch_tv.path_of(p, box.contiguous(), (1, 1, 4)) == "rows"
    assert torch_tv.path_of(p, box.contiguous()[:, :, :3],
                            (1, 1, 4)) == "strided"
