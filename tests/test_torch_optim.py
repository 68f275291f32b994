"""The port's MaskedAdam, the closed-form backward of
``alpha2weight_dense_bidir`` and the small training ops (TV, trilinear
resize, device-side mask bbox) against the JAX package on the CPU. Inputs
are made once with numpy from a seed and handed to both packages.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from directvoxgo_tpu.ops import grid as jax_grid
from directvoxgo_tpu.ops import raymarch as jax_rm
from directvoxgo_tpu.ops import tv as jax_tv
from directvoxgo_tpu.optim import MaskedAdam as JaxAdam
from directvoxgo_tpu_torch import convert
from directvoxgo_tpu_torch.models.mlp import MLP
from directvoxgo_tpu_torch.ops import grid as torch_grid
from directvoxgo_tpu_torch.ops import raymarch as torch_rm
from directvoxgo_tpu_torch.ops import tv as torch_tv
from directvoxgo_tpu_torch.optim import MaskedAdam as TorchAdam


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ MaskedAdam

GRID = (6, 7, 8)
BOX = ((1, 2, 3), (4, 3, 4))           # (offsets, sizes), xyz


def _adam_pair(case, rng):
    """A JAX optimizer + state and the port's optimizer over the same
    params: a density grid, a k0 grid and a 2-layer MLP."""
    skip = case in ("skip_zero_grad", "region")
    density = rng.normal(size=GRID).astype(np.float32)
    k0 = rng.normal(size=(*GRID, 3)).astype(np.float32)
    mlp = MLP(5, 4, 2, 3, generator=torch.Generator().manual_seed(0))
    t_params = {"density": [torch.tensor(density)], "k0": [torch.tensor(k0)],
                "rgbnet": list(mlp.parameters())}
    j_params = {"density": jnp.asarray(density), "k0": jnp.asarray(k0),
                "rgbnet": {"layers": [
                    {"w": jnp.asarray(l.weight.detach().numpy().T),
                     "b": jnp.asarray(l.bias.detach().numpy())}
                    for l in mlp.layers]}}
    lrs = {"density": 0.1, "k0": 0.05, "rgbnet": 1e-3}
    decay = 0.1 ** (1.0 / 20.0) if case == "decay" else 1.0
    j_opt = JaxAdam({n: {"lr": lr, "skip_zero_grad": skip and n != "rgbnet"}
                     for n, lr in lrs.items()}, lr_decay_factor=decay)
    t_opt = TorchAdam({n: {"params": t_params[n], "lr": lr,
                           "skip_zero_grad": skip and n != "rgbnet"}
                       for n, lr in lrs.items()}, lr_decay_factor=decay)
    j_state = j_opt.init(j_params)
    if case == "per_lr":
        count = rng.integers(0, 9, GRID).astype(np.float32)
        j_state = JaxAdam.set_pervoxel_lr(j_state, jnp.asarray(count))
        t_opt.set_pervoxel_lr(torch.tensor(count))
    return j_opt, j_params, j_state, t_opt, t_params


@pytest.mark.parametrize("case", ["plain", "skip_zero_grad", "per_lr",
                                  "region", "decay"])
def test_masked_adam_matches_jax_over_steps(case):
    """Five steps of both optimizers from the same params with the same
    gradients: params and both moments agree to f32 rounding of the scalar
    step size (computed in double here, in f32 there) - 2e-6 relative."""
    rng = np.random.default_rng(5)
    j_opt, j_params, j_state, t_opt, t_params = _adam_pair(case, rng)
    (ox, oy, oz), (sx, sy, sz) = BOX
    box = (slice(ox, ox + sx), slice(oy, oy + sy), slice(oz, oz + sz))
    for step in range(5):
        g_d = rng.normal(size=GRID).astype(np.float32)
        g_k = rng.normal(size=(*GRID, 3)).astype(np.float32)
        if case in ("skip_zero_grad", "region"):
            # gradients live in the box only, with exact zeros inside it too
            keep = np.zeros(GRID, bool)
            keep[box] = rng.uniform(size=(sx, sy, sz)) < 0.7
            g_d, g_k = g_d * keep, g_k * keep[..., None]
        g_mlp = [rng.normal(size=tuple(p.shape)).astype(np.float32)
                 for p in t_params["rgbnet"]]
        j_grads = {"density": jnp.asarray(g_d), "k0": jnp.asarray(g_k),
                   "rgbnet": {"layers": [
                       {"w": jnp.asarray(g_mlp[i].T),
                        "b": jnp.asarray(g_mlp[i + 1])}
                       for i in range(0, len(g_mlp), 2)]}}
        t_grads = {"density": [torch.tensor(g_d)], "k0": [torch.tensor(g_k)],
                   "rgbnet": [torch.tensor(g) for g in g_mlp]}
        j_regions = t_regions = None
        if case == "region":
            # the port gets the gradient box-shaped on odd steps and full on
            # even ones, as the two kinds of train step hand it over
            j_regions = {n: (jnp.asarray(BOX[0], jnp.int32), BOX[1])
                         for n in ("density", "k0")}
            t_regions = {n: BOX for n in ("density", "k0")}
            if step % 2:
                t_grads["density"] = [torch.tensor(g_d[box])]
                t_grads["k0"] = [torch.tensor(g_k[box])]
        j_params, j_state = j_opt.update(j_params, j_grads, j_state,
                                         regions=j_regions)
        t_opt.step(t_grads, regions=t_regions)

    t_state = convert.opt_state_to_jax(t_opt)
    assert int(t_state["step"]) == int(j_state["step"]) == 5
    t_tree = {"density": t_params["density"][0].numpy(),
              "k0": t_params["k0"][0].numpy(),
              "rgbnet": t_state["exp_avg"]["rgbnet"]}   # structure only
    for name in ("density", "k0"):
        np.testing.assert_allclose(t_tree[name], np.asarray(j_params[name]),
                                   rtol=2e-6, atol=2e-6)
    for i, layer in enumerate(j_params["rgbnet"]["layers"]):
        np.testing.assert_allclose(
            t_params["rgbnet"][2 * i].detach().numpy().T,
            np.asarray(layer["w"]), rtol=2e-6, atol=2e-6)
    for key in ("exp_avg", "exp_avg_sq"):
        flat_t = jax.tree_util.tree_leaves(t_state[key])
        flat_j = jax.tree_util.tree_leaves(j_state[key])
        assert len(flat_t) == len(flat_j) == 6
        for a, b in zip(flat_t, flat_j):
            np.testing.assert_allclose(a, np.asarray(b), rtol=2e-6,
                                       atol=1e-7)
    if case in ("skip_zero_grad", "region"):
        # outside the box nothing ever moved: moments still exactly zero
        outside = np.ones(GRID, bool)
        outside[box] = False
        assert np.all(t_state["exp_avg"]["density"][outside] == 0)
        assert np.all(t_state["exp_avg_sq"]["k0"][outside] == 0)


def test_masked_adam_state_round_trips_through_the_jax_layout():
    rng = np.random.default_rng(6)
    _, _, _, t_opt, t_params = _adam_pair("per_lr", rng)
    t_opt.step({n: [torch.tensor(rng.normal(size=tuple(p.shape)).astype(
        np.float32)) for p in ps] for n, ps in t_params.items()})
    state = convert.opt_state_to_jax(t_opt)
    assert set(state) == {"step", "exp_avg", "exp_avg_sq", "per_lr"}
    assert state["exp_avg"]["rgbnet"]["layers"][0]["w"].shape == (5, 4)
    _, _, _, t_opt2, _ = _adam_pair("plain", np.random.default_rng(6))
    convert.opt_state_from_jax(state, t_opt2)
    again = convert.opt_state_to_jax(t_opt2)
    for a, b in zip(jax.tree_util.tree_leaves(state),
                    jax.tree_util.tree_leaves(again)):
        np.testing.assert_array_equal(a, b)


# ------------------------------------- alpha2weight_dense_bidir backward

def test_alpha2weight_bidir_backward_matches_jax_vjp():
    """Closed-form backward against ``jax.vjp``: rows marching both ways, a
    saturated alpha (exactly 1.0) in a forward and in a backward row, and
    rows that terminate early. 1e-6: the same f32 formulas, cumulative
    sums in another order."""
    rng = np.random.default_rng(7)
    n, s = 64, 40
    alpha = rng.uniform(0, 0.4, (n, s)).astype(np.float32)
    alpha[0, 5] = alpha[1, 30] = 1.0          # saturated samples
    alpha[2:6] = rng.uniform(0.5, 0.9, (4, s))  # terminate after a few
    valid = rng.uniform(size=(n, s)) < 0.8
    fwd = rng.uniform(size=n) < 0.5
    fwd[0], fwd[1] = True, False
    d_w = rng.normal(size=(n, s)).astype(np.float32)
    d_inv = rng.normal(size=n).astype(np.float32)

    out_j, vjp = jax.vjp(lambda a: jax_rm.alpha2weight_dense_bidir(
        a, jnp.asarray(valid), jnp.asarray(fwd))[:2], jnp.asarray(alpha))
    ref = np.asarray(vjp((jnp.asarray(d_w), jnp.asarray(d_inv)))[0])

    a_t = torch.tensor(alpha, requires_grad=True)
    w_t, inv_t, live_t = torch_rm.alpha2weight_dense_bidir(
        a_t, torch.tensor(valid), torch.tensor(fwd))
    assert not live_t.requires_grad
    ((w_t * torch.tensor(d_w)).sum()
     + (inv_t * torch.tensor(d_inv)).sum()).backward()
    got = a_t.grad.numpy()
    assert np.isfinite(got).all() and np.isfinite(ref).all()
    np.testing.assert_allclose(w_t.detach().numpy(), np.asarray(out_j[0]),
                               atol=1e-6)
    assert np.abs(ref).max() > 0.1
    # 1/one_minus reaches 1e10 at the saturated samples, so compare
    # relative to each entry's size
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=1e-6)


# ------------------------------------------- TV, resize, device mask bbox

@pytest.mark.parametrize("dense", [True, False])
@pytest.mark.parametrize("channels", [0, 3])
def test_total_variation_add_grad_matches_jax(dense, channels):
    rng = np.random.default_rng(8)
    shape = (5, 6, 7) + ((channels,) if channels else ())
    param = (rng.normal(size=shape) * 2).astype(np.float32)
    grad = (rng.normal(size=shape)
            * (rng.uniform(size=shape) < 0.5)).astype(np.float32)
    ref = np.asarray(jax_tv.total_variation_add_grad(
        jnp.asarray(param), jnp.asarray(grad), 0.3, 0.2, 0.1, dense))
    out = torch_tv.total_variation_add_grad(
        torch.tensor(param), torch.tensor(grad), 0.3, 0.2, 0.1, dense).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6)    # f32 sums of 6 terms
    term = torch_tv.tv_term(torch.tensor(param), 0.3, 0.2, 0.1).numpy()
    np.testing.assert_allclose(term, np.asarray(jax_tv.tv_term(
        jnp.asarray(param), 0.3, 0.2, 0.1)), atol=1e-6)


@pytest.mark.parametrize("channels", [0, 4])
def test_resize_trilinear_matches_jax(channels):
    rng = np.random.default_rng(9)
    shape = (7, 5, 6) + ((channels,) if channels else ())
    grid = rng.normal(size=shape).astype(np.float32)
    ref = np.asarray(jax_grid.resize_trilinear(jnp.asarray(grid), (11, 9, 6)))
    out = torch_grid.resize_trilinear(torch.tensor(grid), (11, 9, 6)).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=2e-6)  # three f32 contractions


@pytest.mark.parametrize("fill", ["blob", "empty", "full"])
def test_mask_bbox_vox_device_matches_host_and_jax(fill):
    mask = np.zeros((9, 8, 7), bool)
    if fill == "blob":
        mask[3:6, 0:2, 4:7] = True
    elif fill == "full":
        mask[:] = True
    got = torch_grid.mask_bbox_vox_device(torch.tensor(mask)).numpy()
    lo, hi = torch_grid.mask_bbox_vox(torch.tensor(mask))
    np.testing.assert_array_equal(got, np.stack([lo, hi]))
    np.testing.assert_array_equal(
        got, np.asarray(jax_grid.mask_bbox_vox_device(jnp.asarray(mask))))
