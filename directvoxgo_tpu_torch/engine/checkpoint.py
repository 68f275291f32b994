"""Checkpoint I/O in the JAX package's format, so each package loads the
other's checkpoints.

A checkpoint is a pickled dict ``{global_step, model_kwargs,
model_state_dict, optimizer_state_dict}`` of numpy arrays and plain
containers (``.tar`` names kept from the upstream project; these are not
torch checkpoints). ``model_state_dict`` holds the JAX parameter pytree
(``density``, ``k0``, ``rgbnet.layers[i].{w, b}``) plus ``mask``,
``optimizer_state_dict`` the optimizer pytree (``step``, ``exp_avg``,
``exp_avg_sq``, ``per_lr``); :mod:`..convert` maps both onto the port's
module and optimizer. Big float32 grids may be
stored as float16 and are widened back to float32 on load.

Loading goes through a restricted unpickler that only rebuilds numpy
arrays and dtypes, so a checkpoint path cannot execute code.
"""

from __future__ import annotations

import glob
import io
import os
import pickle

import numpy as np
import torch

from .. import convert

_SAFE_GLOBALS = {
    ("numpy._core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "_reconstruct"),
    ("numpy._core.multiarray", "scalar"),
    ("numpy.core.multiarray", "scalar"),
    ("numpy._core.numeric", "_frombuffer"),
    ("numpy.core.numeric", "_frombuffer"),
    ("numpy", "ndarray"),
    ("numpy", "dtype"),
}

# Float32 arrays with at least this many elements are stored as float16
# when a save asks for compaction (run-scale voxel grids).
_COMPACT_MIN_ELEMS = 1_000_000


class _RestrictedUnpickler(pickle.Unpickler):
    """Allows only the numpy-array plumbing the checkpoints use."""

    def find_class(self, module, name):
        if (module, name) in _SAFE_GLOBALS or (
                module == "numpy.dtypes" and name.endswith("DType")):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"checkpoint contains disallowed global {module}.{name} - "
            "refusing to unpickle (only numpy arrays and plain containers "
            "are expected)")


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def _cast(x, dtype):
    """``x.astype(dtype)`` between float32 and float16 through PyTorch's
    vectorised CPU cast: the same IEEE round-to-nearest-even, but numpy's
    half-precision cast takes tens of seconds for a fern-width grid and its
    Adam moments."""
    return torch.from_numpy(np.ascontiguousarray(x)).to(dtype).numpy()


def _restore_f32(tree):
    """Widen float16 arrays (compacted grids) back to float32."""
    return _map(tree, lambda x: _cast(x, torch.float32)
                if isinstance(x, np.ndarray) and x.dtype == np.float16
                else x)


def _compact(tree):
    return _map(tree, lambda x: _cast(x, torch.float16)
                if isinstance(x, np.ndarray) and x.dtype == np.float32
                and x.size >= _COMPACT_MIN_ELEMS else x)


def save_checkpoint_file(path, payload, compact=False):
    """Write ``payload`` (numpy arrays and plain containers) atomically;
    ``compact`` stores big float32 arrays as float16."""
    if compact:
        payload = _compact(payload)
    ap = os.path.abspath(path)
    tmp = ap + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, ap)


def load_checkpoint_file(path):
    with open(path, "rb") as f:
        return _restore_f32(_RestrictedUnpickler(io.BytesIO(f.read())).load())


def newest_numbered_checkpoint(logdir, stage):
    """The newest ``{stage}_{step:06d}.tar`` of an interrupted run (written
    atomically, so any file found is complete), or None."""
    numbered = sorted(glob.glob(os.path.join(logdir, f"{stage}_[0-9]*.tar")))
    return numbered[-1] if numbered else None


def save_model_checkpoint(path, model, global_step, optimizer_state=None,
                          compact=False):
    """``optimizer_state``: the JAX-layout pytree of
    :func:`..convert.opt_state_to_jax`, or None."""
    params, mask = convert.params_to_jax(model)
    state = {"mask": mask}
    state.update(params)
    save_checkpoint_file(path, {
        "global_step": global_step,
        "model_kwargs": model.get_kwargs(),
        "model_state_dict": state,
        "optimizer_state_dict": optimizer_state,
    }, compact=compact)


def load_model(model_class, path, device=None):
    """Rebuild a model from its checkpoint manifest and load its state
    (``device``: see :func:`..device.resolve_device`)."""
    st = load_checkpoint_file(path)
    model = model_class(**st["model_kwargs"], device=device)
    state = dict(st["model_state_dict"])
    mask = state.pop("mask")
    model.load_state_dict(convert.params_from_jax(state, mask,
                                                  device=model.device))
    return model
