"""Map between the JAX package's parameter pytree and the port's module
state.

The JAX pytree is ``{"density": [X, Y, Z], "k0": [X, Y, Z, C],
"rgbnet": {"layers": [{"w": [in, out], "b": [out]}, ...]}}`` with the
occupancy mask beside it; the port's :class:`..models.dvgo.DirectVoxGO`
holds ``density``, ``k0``, ``mask`` and ``rgbnet.layers.{i}.{weight, bias}``
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
