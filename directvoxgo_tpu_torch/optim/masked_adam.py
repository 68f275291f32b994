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

``state`` mirrors the JAX package's layout: ``step``, ``exp_avg`` and
``exp_avg_sq`` (per group, one tensor per parameter) and ``per_lr``;
:mod:`..convert` maps it to and from the JAX pytree for checkpoints.
Updates run in place under ``torch.no_grad()``.
"""

from __future__ import annotations

import math

import torch


class MaskedAdam:
    """``groups`` maps a name ('density', 'k0', 'rgbnet') to ``{'params':
    [tensors], 'lr': float, 'skip_zero_grad': bool}``."""

    def __init__(self, groups, beta1=0.9, beta2=0.99, eps=1e-8,
                 lr_decay_factor=1.0):
        self.groups = groups
        self.beta1, self.beta2, self.eps = beta1, beta2, eps
        self.lr_decay_factor = float(lr_decay_factor)
        self.state = {
            "step": 0,
            "exp_avg": {n: [torch.zeros_like(p) for p in g["params"]]
                        for n, g in groups.items()},
            "exp_avg_sq": {n: [torch.zeros_like(p) for p in g["params"]]
                           for n, g in groups.items()},
            "per_lr": None,
        }

    def set_pervoxel_lr(self, count):
        self.state["per_lr"] = count.float() / count.max()

    def _update(self, p, g, m, v, step_size, skip, per_lr):
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
        p.copy_(new_p)
        m.copy_(new_m)
        v.copy_(new_v)

    @torch.no_grad()
    def step(self, grads, regions=None):
        """One update from ``grads`` (name -> list of tensors aligned with
        the group's params). ``regions`` maps a grid name to ``(offsets,
        sizes)`` (xyz start voxels and extents) and applies to
        ``skip_zero_grad`` groups only."""
        st = self.state
        t = st["step"] + 1
        lr_scale = self.lr_decay_factor ** st["step"]
        corr = math.sqrt(1.0 - self.beta2 ** t) / (1.0 - self.beta1 ** t)
        per_lr_arr = st["per_lr"]
        for name, group in self.groups.items():
            if name not in grads:
                continue
            step_size = group["lr"] * lr_scale * corr
            skip = bool(group.get("skip_zero_grad", False))
            region = (regions or {}).get(name) if skip else None
            for p, g, m, v in zip(group["params"], grads[name],
                                  st["exp_avg"][name],
                                  st["exp_avg_sq"][name]):
                per_lr = None
                if per_lr_arr is not None and p.shape == per_lr_arr.shape:
                    per_lr = per_lr_arr
                if region is not None and p.dim() >= 3:
                    offs, sizes = region
                    box = tuple(slice(int(o), int(o) + int(s))
                                for o, s in zip(offs, sizes))
                    if g.shape[:3] != tuple(int(s) for s in sizes):
                        g = g[box]
                    self._update(p[box], g, m[box], v[box], step_size, True,
                                 None if per_lr is None else per_lr[box])
                else:
                    self._update(p, g, m, v, step_size, skip, per_lr)
        st["step"] = t
