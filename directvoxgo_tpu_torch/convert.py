"""Map between the JAX package's parameter pytree and the port's module
state.

The JAX pytree is ``{"density": [X, Y, Z], "k0": [X, Y, Z, C],
"rgbnet": {"layers": [{"w": [in, out], "b": [out]}, ...]}}`` with the
occupancy mask beside it; the port's :class:`..models.dvgo.DirectVoxGO`
and :class:`..models.dmpigo.DirectMPIGO` hold ``density``, ``k0``, ``mask``
and ``rgbnet.layers.{i}.{weight, bias}`` (no ``rgbnet`` without a colour MLP)
with ``nn.Linear``'s ``[out, in]`` weights, so each ``w`` is transposed
exactly once in either direction.
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_jax(params_np, mask, device=None):
    """JAX pytree (numpy leaves) + mask -> a ``state_dict`` for the port."""
    state = {
        "density": torch.tensor(np.asarray(params_np["density"],
                                           np.float32), device=device),
        "mask": torch.tensor(np.asarray(mask, bool), device=device),
    }
    if "k0" in params_np:
        state["k0"] = torch.tensor(np.asarray(params_np["k0"], np.float32),
                                   device=device)
    for i, layer in enumerate(params_np.get("rgbnet", {}).get("layers", [])):
        w = np.asarray(layer["w"], np.float32)
        state[f"rgbnet.layers.{i}.weight"] = torch.tensor(
            np.ascontiguousarray(w.T), device=device)
        state[f"rgbnet.layers.{i}.bias"] = torch.tensor(
            np.asarray(layer["b"], np.float32), device=device)
    return state


def params_to_jax(model):
    """The port's module -> (JAX pytree with numpy leaves, mask)."""
    def np_(x):
        return x.detach().cpu().numpy()

    params = {"density": np_(model.density), "k0": np_(model.k0)}
    if model.rgbnet is not None:
        params["rgbnet"] = {"layers": [
            {"w": np.ascontiguousarray(np_(layer.weight).T),
             "b": np_(layer.bias)} for layer in model.rgbnet.layers]}
    return params, np_(model.mask)


def _moments_to_jax(name, tensors):
    """One group's moment tensors -> the JAX pytree leaf for ``name``."""
    arrs = [t.detach().cpu().numpy() for t in tensors]
    if name != "rgbnet":
        return arrs[0]
    return {"layers": [{"w": np.ascontiguousarray(arrs[i].T),
                        "b": arrs[i + 1]} for i in range(0, len(arrs), 2)]}


def _moments_from_jax(name, leaf, like):
    """The JAX pytree leaf for ``name`` -> tensors shaped like ``like``
    (the group's parameters: a grid, or weight and bias per MLP layer)."""
    if name != "rgbnet":
        arrs = [np.asarray(leaf, np.float32)]
    else:
        arrs = []
        for layer in leaf["layers"]:
            arrs += [np.ascontiguousarray(np.asarray(layer["w"],
                                                     np.float32).T),
                     np.asarray(layer["b"], np.float32)]
    out = [torch.tensor(a, device=p.device) for a, p in zip(arrs, like)]
    if len(out) != len(like) or any(o.shape != p.shape
                                    for o, p in zip(out, like)):
        raise ValueError(f"optimizer state of {name!r} does not match the "
                         "model's parameters")
    return out


def opt_state_to_jax(optimizer):
    """The port's MaskedAdam state -> the JAX package's optimizer pytree
    (numpy leaves): ``step``, ``exp_avg``/``exp_avg_sq`` mirroring the
    params (MLP weights transposed to [in, out]) and ``per_lr``."""
    st = optimizer.state
    per_lr = st["per_lr"]
    return {
        "step": np.asarray(int(st["step"]), np.int32),
        "exp_avg": {n: _moments_to_jax(n, ts)
                    for n, ts in st["exp_avg"].items()},
        "exp_avg_sq": {n: _moments_to_jax(n, ts)
                       for n, ts in st["exp_avg_sq"].items()},
        "per_lr": None if per_lr is None else per_lr.cpu().numpy(),
    }


def opt_state_from_jax(state_np, optimizer):
    """Load a JAX optimizer pytree (numpy leaves) into the port's
    MaskedAdam, for the groups it trains."""
    st = optimizer.state
    st["step"].fill_(int(state_np["step"]))
    for key in ("exp_avg", "exp_avg_sq"):
        for name, group in optimizer.groups.items():
            st[key][name] = _moments_from_jax(name, state_np[key][name],
                                              group["params"])
    per_lr = state_np.get("per_lr")
    dev = next(iter(optimizer.groups.values()))["params"][0].device
    st["per_lr"] = None if per_lr is None else torch.tensor(
        np.asarray(per_lr, np.float32), device=dev)
