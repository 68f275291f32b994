"""Map between the JAX package's parameter pytree and the port's module
state.

The JAX pytree is ``{"density": [X, Y, Z], "k0": [X, Y, Z, C],
"rgbnet": {"layers": [{"w": [in, out], "b": [out]}, ...]}}`` with the
occupancy mask beside it; the port's :class:`..models.dvgo.DirectVoxGO`
and :class:`..models.dmpigo.DirectMPIGO` hold ``density``, ``k0``, ``mask``
and ``rgbnet.layers.{i}.{weight, bias}`` (no ``rgbnet`` without a colour MLP)
with ``nn.Linear``'s ``[out, in]`` weights, so each ``w`` is transposed
exactly once in either direction.

The conditioned and multi-scene models (those with ``jax_groups()``) keep
nested pytrees (``encoder``, ``map``, ``interp_xy``, ...). Their modules
name their layers as the pytree does, so a parameter's dotted name is its
pytree path (list indices as numbers, ``weight``/``bias`` for ``w``/``b``):
a linear ``w`` is transposed ``[in, out]`` <-> ``[out, in]``, a convolution
``w`` HWIO <-> OIHW. A module's non-array leaves (``JAX_EXTRAS``: ``dropout``
and the like) are written into the JAX pytree, as zeros in the optimizer
moments, and skipped on the way in. ``interp_yz`` and ``interp_zx`` stay
two parameter sets.
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_jax(params_np, mask, device=None, model=None):
    """JAX pytree (numpy leaves) + mask -> a ``state_dict`` for the port
    (``model``: needed for the nested pytrees of models with
    ``jax_groups()``)."""
    if model is not None and hasattr(model, "jax_groups"):
        state = {"mask": torch.tensor(np.asarray(mask, bool), device=device)}
        for name, obj in model.jax_groups().items():
            if isinstance(obj, torch.nn.Module):
                for (pname, _), arr in zip(obj.named_parameters(),
                                           module_from_jax(obj,
                                                           params_np[name])):
                    state[f"{name}.{pname}"] = torch.tensor(arr,
                                                            device=device)
            else:
                state[name] = torch.tensor(np.asarray(params_np[name],
                                                      np.float32),
                                           device=device)
        return state
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

    if hasattr(model, "jax_groups"):
        params = {name: (module_to_jax(obj)
                         if isinstance(obj, torch.nn.Module) else np_(obj))
                  for name, obj in model.jax_groups().items()}
        return params, np_(model.mask)
    params = {"density": np_(model.density), "k0": np_(model.k0)}
    if model.rgbnet is not None:
        params["rgbnet"] = {"layers": [
            {"w": np.ascontiguousarray(np_(layer.weight).T),
             "b": np_(layer.bias)} for layer in model.rgbnet.layers]}
    return params, np_(model.mask)


# ------------------------------------------------------------ nested trees

def _leaf(module, parts):
    """(JAX key, transposed?) of a parameter: a layer's (``nn.Linear``,
    ``nn.Conv2d``) ``weight``/``bias`` are the JAX ``w``/``b``, its weight
    transposed; any other parameter keeps its name (a frozen batch norm's
    ``scale``, ``bias``, ``mean``, ``var``)."""
    owner = module.get_submodule(".".join(parts[:-1]))
    if isinstance(owner, (torch.nn.Linear, torch.nn.Conv2d)):
        return {"weight": "w", "bias": "b"}[parts[-1]], parts[-1] == "weight"
    return parts[-1], False


def _leaf_to_jax(arr, transposed):
    if transposed:
        arr = arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr.T
    return np.ascontiguousarray(arr)


def _leaf_from_jax(arr, transposed):
    if transposed:
        arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
    return np.ascontiguousarray(arr)


def _listify(node):
    """Dicts whose keys are all list indices -> lists, recursively."""
    if not isinstance(node, dict):
        return node
    node = {k: _listify(v) for k, v in node.items()}
    if node and all(isinstance(k, int) for k in node):
        return [node[i] for i in range(len(node))]
    return node


def _insert(root, path, value):
    node = root
    for c in path[:-1]:
        node = node.setdefault(int(c) if c.isdigit() else c, {})
    node[path[-1]] = value


def _zero_like(v):
    if isinstance(v, (tuple, list)):
        return type(v)(_zero_like(x) for x in v)
    if isinstance(v, bool) or isinstance(v, str):
        return v
    return np.zeros((), np.int32 if isinstance(v, int) else np.float32)


def module_to_jax(module, tensors=None, moments=False):
    """The JAX pytree of ``module``'s parameters (or of ``tensors``, shaped
    as its parameters in their order: optimizer moments, whose non-array
    leaves are zeros)."""
    named = list(module.named_parameters())
    if tensors is None:
        tensors = [p for _, p in named]
    root = {}
    for (name, _), t in zip(named, tensors):
        parts = name.split(".")
        key, transposed = _leaf(module, parts)
        _insert(root, parts[:-1] + [key],
                _leaf_to_jax(t.detach().cpu().numpy(), transposed))
    for mname, m in module.named_modules():
        for attr in getattr(m, "JAX_EXTRAS", ()):
            v = getattr(m, attr)
            _insert(root, (mname.split(".") if mname else []) + [attr],
                    _zero_like(v) if moments else v)
    return _listify(root)


def module_from_jax(module, tree):
    """numpy arrays shaped as ``module``'s parameters, in their order, read
    from the JAX pytree ``tree`` (non-array leaves are not read)."""
    out = []
    for name, p in module.named_parameters():
        parts = name.split(".")
        key, transposed = _leaf(module, parts)
        node = tree
        for c in parts[:-1]:
            node = node[int(c)] if isinstance(node, (list, tuple)) \
                else node[c]
        arr = _leaf_from_jax(np.asarray(node[key], np.float32), transposed)
        if arr.shape != tuple(p.shape):
            raise ValueError(f"{name}: JAX leaf of shape {arr.shape} for a "
                             f"parameter of shape {tuple(p.shape)}")
        out.append(arr)
    return out


# --------------------------------------------------------------- optimizer

def _moments_to_jax(name, group, tensors):
    """One group's moment tensors -> the JAX pytree leaf for ``name``."""
    if group.get("module") is not None:
        return module_to_jax(group["module"], tensors, moments=True)
    arrs = [t.detach().cpu().numpy() for t in tensors]
    if name != "rgbnet":
        return arrs[0]
    return {"layers": [{"w": np.ascontiguousarray(arrs[i].T),
                        "b": arrs[i + 1]} for i in range(0, len(arrs), 2)]}


def _moments_from_jax(name, group, leaf):
    """The JAX pytree leaf for ``name`` -> tensors shaped like the group's
    parameters (a grid, weight and bias per MLP layer, or a module's)."""
    like = group["params"]
    if group.get("module") is not None:
        arrs = module_from_jax(group["module"], leaf)
    elif name != "rgbnet":
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
        "exp_avg": {n: _moments_to_jax(n, optimizer.groups[n], ts)
                    for n, ts in st["exp_avg"].items()},
        "exp_avg_sq": {n: _moments_to_jax(n, optimizer.groups[n], ts)
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
            st[key][name] = _moments_from_jax(name, group,
                                              state_np[key][name])
    per_lr = state_np.get("per_lr")
    dev = next(iter(optimizer.groups.values()))["params"][0].device
    st["per_lr"] = None if per_lr is None else torch.tensor(
        np.asarray(per_lr, np.float32), device=dev)
