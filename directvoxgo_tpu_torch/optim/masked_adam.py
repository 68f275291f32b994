"""MaskedAdam: Adam over named parameter groups with the voxel-grid
variants of the upstream optimizer.

* Bias correction folded into one scalar step size
  ``lr * sqrt(1 - b2^t) / (1 - b1^t)``.
* ``skip_zero_grad``: entries whose gradient is exactly zero are skipped
  entirely: parameter and both moments stay as they are.
* Per-voxel lr: a multiplier tensor applied to the step of every parameter
  whose shape matches it (:meth:`set_pervoxel_lr`: ``count / count.max()``).
* ``regions``: a ``skip_zero_grad`` grid whose gradient is zero outside a
  box is updated on that box only, in place on the box slice; the gradient
  may arrive already box-shaped.
* Per-step exponential lr decay: step ``t`` (1-based) uses
  ``lr * lr_decay_factor ** (t - 1)``; ``t`` is carried in the state.
* Regions whose start voxel is device data (:class:`..ops.grid.DeviceBox`)
  are read and written through their flat voxel indices.

``state`` mirrors the JAX package's layout: ``step``, ``exp_avg`` and
``exp_avg_sq`` (per group, one tensor per parameter) and ``per_lr``;
:mod:`..convert` maps it to and from the JAX pytree for checkpoints. The
step count is an int64 0-d tensor on the parameters' device, and the decay
and bias correction are computed from it there in f64 (as the host did in
Python floats) and rounded to f32 once: a step captured as a CUDA graph
then counts and decays on every replay. Updates run in place under
``torch.no_grad()``.
"""

from __future__ import annotations

import torch

from ..ops.grid import DeviceBox


class MaskedAdam:
    """``groups`` maps a name ('density', 'k0', 'rgbnet', or a module of
    the conditioned models: 'encoder', 'map', ...) to ``{'params':
    [tensors], 'lr': float, 'skip_zero_grad': bool}``, optionally with
    ``'module'``: the module whose parameters they are (in its order),
    which shapes the group's moments in the JAX layout (``convert.py``)."""

    def __init__(self, groups, beta1=0.9, beta2=0.99, eps=1e-8,
                 lr_decay_factor=1.0):
        self.groups = groups
        self.beta1, self.beta2, self.eps = beta1, beta2, eps
        self.lr_decay_factor = float(lr_decay_factor)
        dev = next((g["params"][0].device for g in groups.values()
                    if g["params"]), torch.device("cpu"))
        self.state = {
            "step": torch.zeros((), dtype=torch.int64, device=dev),
            "exp_avg": {n: [torch.zeros_like(p) for p in g["params"]]
                        for n, g in groups.items()},
            "exp_avg_sq": {n: [torch.zeros_like(p) for p in g["params"]]
                           for n, g in groups.items()},
            "per_lr": None,
        }

    def set_pervoxel_lr(self, count):
        self.state["per_lr"] = count.float() / count.max()

    def _new_values(self, p, g, m, v, step_size, skip, per_lr):
        """(parameter, first moment, second moment) after one step."""
        b1, b2 = self.beta1, self.beta2
        new_m = b1 * m + (1.0 - b1) * g
        new_v = b2 * v + (1.0 - b2) * g * g
        upd = step_size * new_m / (torch.sqrt(new_v) + self.eps)
        if per_lr is not None:
            upd = upd * per_lr
        new_p = p - upd
        if skip:
            touched = g != 0
            new_p = torch.where(touched, new_p, p)
            new_m = torch.where(touched, new_m, m)
            new_v = torch.where(touched, new_v, v)
        return new_p, new_m, new_v

    @torch.no_grad()
    def step(self, grads, regions=None):
        """One update from ``grads`` (name -> list of tensors aligned with
        the group's params). ``regions`` maps a grid name to ``(offsets,
        sizes)`` (xyz start voxels and extents, ints) or to a
        :class:`..ops.grid.DeviceBox`, and applies to ``skip_zero_grad``
        groups only."""
        st = self.state
        st["step"].add_(1)
        t = st["step"].to(torch.float64)
        lr_scale = torch.pow(self.lr_decay_factor, t - 1.0)
        corr = (torch.sqrt(1.0 - torch.pow(self.beta2, t))
                / (1.0 - torch.pow(self.beta1, t)))
        per_lr_arr = st["per_lr"]
        for name, group in self.groups.items():
            if name not in grads:
                continue
            step_size = (group["lr"] * lr_scale * corr).to(torch.float32)
            skip = bool(group.get("skip_zero_grad", False))
            region = (regions or {}).get(name) if skip else None
            for p, g, m, v in zip(group["params"], grads[name],
                                  st["exp_avg"][name],
                                  st["exp_avg_sq"][name]):
                per_lr = None
                if per_lr_arr is not None and p.shape == per_lr_arr.shape:
                    per_lr = per_lr_arr
                if isinstance(region, DeviceBox) and p.dim() >= 3:
                    if tuple(g.shape[:3]) != region.sizes:
                        g = region.take(g)
                    new = self._new_values(
                        region.take(p), g, region.take(m), region.take(v),
                        step_size, True,
                        None if per_lr is None else region.take(per_lr))
                    for dst, x in zip((p, m, v), new):
                        region.put(dst, x)
                    continue
                if region is not None and p.dim() >= 3:
                    offs, sizes = region
                    box = tuple(slice(int(o), int(o) + int(s))
                                for o, s in zip(offs, sizes))
                    if g.shape[:3] != tuple(int(s) for s in sizes):
                        g = g[box]
                    p, m, v = p[box], m[box], v[box]
                    per_lr = None if per_lr is None else per_lr[box]
                    skip_here = True
                else:
                    skip_here = skip
                for dst, x in zip((p, m, v), self._new_values(
                        p, g, m, v, step_size, skip_here, per_lr)):
                    dst.copy_(x)
