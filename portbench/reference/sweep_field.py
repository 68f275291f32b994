"""Plain reference of the configurations' radiance fields: DirectVoxGO's
fine stage and DirectMPIGO, as the station sweep samples them, in plain
PyTorch and in one dtype throughout (float32 for the reference, bfloat16
for the control), with no kernels, windows, boxes or graphs.

Samples sit on stations: the planes ``p = s / k`` (``k = round(1 /
stepsize)``) across the sweep axis of a ray (its dominant axis in voxel
space; z for an MPI grid), over the whole grid. A sample is the
trilinear (align-corners, zero outside the grid) value of density, the
occupancy mask and k0 at the ray's point on the station. It is valid
inside the model's box and between near and far, with an interpolated
mask above 0; alpha is ``1 - exp(-softplus(density + shift) *
interval)``; samples whose alpha passes ``fast_color_thres`` composite
front to back in the ray's direction, live while the transmittance
entering them is at least ``T_TERMINATE``; the colour MLP runs on the
``sweep_color_topk`` samples of largest weight above the threshold. A
train step is the DirectVoxGO loss (MSE, the last alpha's entropy, the
per-sample colour loss weighted by the detached weights), the TV gradient
(x terms weighted by ``wz``, as the upstream CUDA kernel does; sparse:
only where the batch's gradient is nonzero) and MaskedAdam (skipping
entries whose gradient is zero in the ``skip_zero_grad`` groups).

Only geometry (sample points and interpolation weights) is computed in
float32 in every dtype; ``dtype`` holds every value of the field, its
gradients and the optimizer's state. Nothing here imports the program.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

PERMS = {0: (0, 1, 2), 1: (1, 0, 2), 2: (2, 0, 1)}
T_EPS = 1e-10
T_TERMINATE = 1e-3


class Field:
    """One configuration's field: ``cfg`` (the configuration's JSON) and
    ``geo`` (:func:`portbench.inputs.geometry`)."""

    def __init__(self, cfg, geo, near, far, bg):
        m = cfg["fine_model_and_render"]
        t = cfg["fine_train"]
        self.cfg, self.geo = cfg, geo
        self.mpi = geo["kind"] == "mpi"
        self.ws = tuple(int(x) for x in geo["world_size"])
        self.lo = [float(x) for x in geo["xyz_min"]]
        self.hi = [float(x) for x in geo["xyz_max"]]
        self.near, self.far, self.bg = float(near), float(far), float(bg)
        self.stepsize = float(m["stepsize"])
        self.k = max(int(round(1.0 / self.stepsize)), 1)
        self.fct = float(m["fast_color_thres"])
        self.topk = int(m.get("sweep_color_topk", 0))
        self.shift = float(geo["act_shift"])
        self.viewbase_pe = int(m.get("viewbase_pe", 0 if self.mpi else 4))
        if not (self.mpi or m.get("rgbnet_direct", True)):
            raise NotImplementedError("only the direct colour MLP")
        self.t = t
        self.n_rand = int(t["N_rand"])

    # --------------------------------------------------------- geometry

    def axis_of(self, rays_d):
        """[N] sweep axis of each ray."""
        if self.mpi:
            return torch.full(rays_d.shape[:1], 2, dtype=torch.int64,
                              device=rays_d.device)
        scale = torch.tensor([(self.ws[a] - 1.0) / (self.hi[a] - self.lo[a])
                              for a in range(3)], device=rays_d.device)
        return torch.argmax(torch.abs(rays_d * scale), -1)

    def stations(self, ro, rd, axis):
        """Geometry of every station of rays sweeping ``axis``: ``t [N,
        S]``, the eight corners' flat voxel indices and weights (each
        [8, N, S], weights zero outside the grid), ``inbox [N, S]`` (inside
        the box, between near and far), the station index ``s [S]`` and
        the interval of each ray's samples ``[N]`` or a float."""
        perm = PERMS[axis]
        sc = [(self.ws[a] - 1.0) / (self.hi[a] - self.lo[a]) for a in perm]
        o = [(ro[:, a] - self.lo[a]) * s for a, s in zip(perm, sc)]
        d = [rd[:, a] * s for a, s in zip(perm, sc)]
        gp, gu, gv = (self.ws[a] for a in perm)
        n_s = self.k * (gp - 1) + 1
        s = torch.arange(n_s, device=ro.device)
        p = s.to(torch.float32) / self.k
        dp = torch.where(d[0] == 0, torch.full_like(d[0], 1e-10), d[0])
        t = (p[None, :] - o[0][:, None]) / dp[:, None]
        u = o[1][:, None] + t * d[1][:, None]
        v = o[2][:, None] + t * d[2][:, None]
        p0 = torch.div(s, self.k, rounding_mode="floor")
        fp = (s - p0 * self.k).to(torch.float32) / self.k
        u0f, v0f = torch.floor(u), torch.floor(v)
        fu, fv = u - u0f, v - v0f
        u0, v0 = u0f.to(torch.int64), v0f.to(torch.int64)
        strides = [self.ws[1] * self.ws[2], self.ws[2], 1]
        st = [strides[a] for a in perm]
        idx, wts = [], []
        for cp in (0, 1):
            pp = (p0 + cp)[None, :]
            wp = (fp if cp else 1.0 - fp)[None, :]
            for cu in (0, 1):
                uu = u0 + cu
                wu = fu if cu else 1.0 - fu
                for cv in (0, 1):
                    vv = v0 + cv
                    wv = fv if cv else 1.0 - fv
                    ok = ((pp <= gp - 1) & (uu >= 0) & (uu <= gu - 1)
                          & (vv >= 0) & (vv <= gv - 1))
                    w = torch.where(ok, wp * wu * wv, torch.zeros_like(wu))
                    flat = (torch.clamp(pp, 0, gp - 1) * st[0]
                            + torch.clamp(uu, 0, gu - 1) * st[1]
                            + torch.clamp(vv, 0, gv - 1) * st[2])
                    idx.append(flat)
                    wts.append(w)
        t_lo, t_hi = self.aabb(ro, rd)
        inbox = ((t >= t_lo[:, None]) & (t <= t_hi[:, None])
                 & (t_hi > t_lo)[:, None])
        if self.mpi:
            interval = self.stepsize * self.geo["voxel_size_ratio"]
        else:
            dn = torch.sqrt(torch.sum(rd * rd, -1))
            interval = dn / (self.k * torch.clamp(d[0].abs(), min=1e-10)) \
                / self.geo["voxel_size_base"]
        return {"t": t, "idx": torch.stack(idx), "w": torch.stack(wts),
                "inbox": inbox, "s": s, "interval": interval,
                "forward": d[0] >= 0}

    def aabb(self, ro, rd):
        vec = torch.where(rd == 0, torch.full_like(rd, 1e-6), rd)
        lo = torch.tensor(self.lo, device=ro.device)
        hi = torch.tensor(self.hi, device=ro.device)
        ra, rb = (hi - ro) / vec, (lo - ro) / vec
        t_min = torch.clamp(torch.minimum(ra, rb).amax(-1), self.near,
                            self.far)
        t_max = torch.clamp(torch.maximum(ra, rb).amin(-1), self.near,
                            self.far)
        return t_min, t_max

    # ----------------------------------------------------------- forward

    def table(self, params, dtype):
        """[V, 2 + C] (density, mask, k0) in ``dtype``, differentiable in
        the parameters."""
        v = int(np.prod(self.ws))
        return torch.cat([params["density"].to(dtype).reshape(v, 1),
                          params["mask"].to(dtype).reshape(v, 1),
                          params["k0"].to(dtype).reshape(v, -1)], 1)

    def forward(self, params, table, ro, rd, vd, axis, dtype,
                counts=False):
        """Render rays that all sweep ``axis``: a dict with ``rgb [N,
        3]``, ``depth [N]``, ``ainv [N]``, ``w_sel``, ``rgb_sel`` (the
        colour samples) and the counts of the work it did (``n_inbox``,
        ``n_color``, the voxel sets ``vox_read``, ``vox_density``,
        ``vox_k0``) when ``counts``."""
        g = self.stations(ro, rd, axis)
        n, n_s = g["t"].shape
        vals = None
        for c in range(8):
            part = g["w"][c].to(dtype)[..., None] * table[g["idx"][c]]
            vals = part if vals is None else vals + part
        dens, mask_s, k0 = vals[..., 0], vals[..., 1], vals[..., 2:]
        valid = g["inbox"] & (mask_s > 0)
        interval = g["interval"]
        if torch.is_tensor(interval):
            interval = interval.to(dtype)[:, None]
        alpha = -torch.expm1(-F.softplus(dens + self.shift) * interval)
        occ = valid & (alpha > self.fct) if self.fct > 0 else valid
        fwd = g["forward"][:, None]

        def march(x):     # slab order <-> march order
            return torch.where(fwd, x, x.flip(-1))

        a_m, occ_m = march(alpha), march(occ)
        om = torch.where(occ_m, 1.0 - a_m + T_EPS, torch.ones_like(a_m))
        ones = torch.ones_like(om[:, :1])
        t_ex = torch.cumprod(torch.cat([ones, om[:, :-1]], 1), 1)
        live = t_ex >= T_TERMINATE
        w = torch.where(occ_m & live, t_ex * a_m, torch.zeros_like(a_m))
        ainv = torch.where(live, om, torch.ones_like(om)).prod(-1)
        w, live = march(w), march(live)
        wmask = w > self.fct if self.fct > 0 else (live & occ)
        w_eff = torch.where(wmask, w, torch.zeros_like(w))
        sel = None
        if (self.fct > 0 and 0 < self.topk < n_s
                and n_s > max(96, 2 * self.topk)):
            sel = torch.sort(w_eff.detach(), dim=1, descending=True,
                             stable=True)[1][:, :self.topk]
            w_sel = torch.gather(w_eff, 1, sel)
            k0_sel = torch.gather(k0, 1, sel[..., None].expand(
                -1, -1, k0.shape[-1]))
            t_sel = torch.gather(g["t"], 1, sel)
            s_sel = sel.to(torch.float32)
        else:
            w_sel, k0_sel, t_sel = w_eff, k0, g["t"]
            s_sel = g["s"].to(torch.float32)[None, :].expand(n, -1)
        emb = positional_encoding(vd, self.viewbase_pe).to(dtype)
        x = torch.cat([k0_sel, emb[:, None, :].expand(
            -1, k0_sel.shape[1], -1)], -1)
        for i, (wt, b) in enumerate(params["mlp"]):
            x = x @ wt.to(dtype).t() + b.to(dtype)
            if i < len(params["mlp"]) - 1:
                x = torch.relu(x)
        rgb_sel = torch.sigmoid(x)
        rgb = (w_sel[..., None] * rgb_sel).sum(1) + ainv[:, None] * self.bg
        if self.mpi:
            depth = (w_sel * s_sel.to(dtype)).sum(1)
        else:
            t_safe = torch.where(w_sel > 0, t_sel, torch.zeros_like(t_sel))
            depth = (w_sel * t_safe.to(dtype)).sum(1) * torch.sqrt(
                torch.sum(rd * rd, -1)).to(dtype)
        if not counts:
            return {"rgb": rgb, "depth": depth, "ainv": ainv,
                    "w_sel": w_sel, "rgb_sel": rgb_sel}
        with torch.no_grad():
            live_occ = occ & live
            contrib = g["w"] > 0
            vox_read = g["idx"][contrib & g["inbox"][None]]
            vox_density = g["idx"][contrib & live_occ[None]]
            color = torch.zeros_like(occ)
            if sel is not None:
                color.scatter_(1, sel, w_sel.detach() > 0)
            else:
                color = w_eff.detach() > 0
            vox_k0 = g["idx"][contrib & color[None]]
            counts = {"n_inbox": int(g["inbox"].sum()),
                      "n_color": int(color.sum()), "n_rays": n,
                      "vox_read": vox_read, "vox_density": vox_density,
                      "vox_k0": vox_k0}
        return {"rgb": rgb, "depth": depth, "ainv": ainv, "w_sel": w_sel,
                "rgb_sel": rgb_sel, "counts": counts}

    def render(self, params, ro, rd, vd, dtype, want_counts=False):
        """Render any rays (each swept along its own axis), in input
        order; (rgb, depth) and, with ``want_counts``, the counts summed
        and the voxel sets as unique flat indices (:func:`merge_counts`
        joins those of several calls, :func:`count_values` counts them)."""
        axes = self.axis_of(rd)
        rgb = torch.empty((ro.shape[0], 3), dtype=dtype, device=ro.device)
        depth = torch.empty((ro.shape[0],), dtype=dtype, device=ro.device)
        table = self.table(params, dtype)
        tot = {"n_inbox": 0, "n_color": 0, "n_rays": 0}
        sets = {"vox_read": [], "vox_density": [], "vox_k0": []}
        for ax in range(3):
            sel = torch.nonzero(axes == ax).flatten()
            if sel.numel() == 0:
                continue
            out = self.forward(params, table, ro[sel], rd[sel], vd[sel], ax,
                               dtype, counts=want_counts)
            rgb[sel], depth[sel] = out["rgb"], out["depth"]
            if want_counts:
                for key in tot:
                    tot[key] += out["counts"][key]
                for key in sets:
                    sets[key].append(torch.unique(out["counts"][key]))
        if not want_counts:
            return rgb, depth
        for key, parts in sets.items():
            tot[key] = torch.unique(torch.cat(parts)) if parts else \
                torch.zeros(0, dtype=torch.int64, device=ro.device)
        return rgb, depth, tot

    # -------------------------------------------------------- train step

    def loss(self, params, ro, rd, vd, target, dtype):
        """The step's loss over a batch (each ray along its own axis)."""
        t = self.t
        axes = self.axis_of(rd)
        table = self.table(params, dtype)
        n = ro.shape[0]
        sq = ent = per = 0.0
        for ax in range(3):
            sel = torch.nonzero(axes == ax).flatten()
            if sel.numel() == 0:
                continue
            out = self.forward(params, table, ro[sel], rd[sel], vd[sel], ax,
                               dtype)
            tg = target[sel].to(dtype)
            sq = sq + torch.sum((out["rgb"] - tg) ** 2)
            # the entropy's clamp, widened to the dtype's resolution
            eps = max(1e-6, float(torch.finfo(dtype).eps))
            pout = torch.clamp(out["ainv"], eps, 1 - eps)
            ent = ent - torch.sum(pout * torch.log(pout)
                                  + (1 - pout) * torch.log(1 - pout))
            rgbper = torch.sum((out["rgb_sel"] - tg[:, None, :]) ** 2, -1)
            per = per + torch.sum(rgbper * out["w_sel"].detach())
        mse = sq / (3 * n)
        loss = float(t["weight_main"]) * mse
        if float(t["weight_entropy_last"]) > 0:
            loss = loss + float(t["weight_entropy_last"]) * ent / n
        if float(t["weight_rgbper"]) > 0:
            loss = loss + float(t["weight_rgbper"]) * per / n
        return loss

    def tv_grad(self, param, grad, weight, dense):
        """``grad`` plus the TV gradient of ``param`` (the configuration's
        per-axis scales; x terms weighted as z)."""
        if self.mpi:
            sxy = max(self.ws[:2]) / 128.0
            sz = self.ws[2] / 128.0
            wx, wy, wz = weight * sxy, weight * sxy, weight * sz
        else:
            s = max(self.ws) / 128.0
            wx = wy = wz = weight * s
        wx, wy, wz = wz / 6.0, wy / 6.0, wz / 6.0
        tv = (_axis_term(param, 0, wx) + _axis_term(param, 1, wy)
              + _axis_term(param, 2, wz))
        if not dense:
            tv = torch.where(grad != 0, tv, torch.zeros_like(tv))
        return grad + tv

    def step(self, params, adam, batch, dtype, tv):
        """One train step in place on ``params`` and ``adam``
        (:func:`new_adam`); ``tv`` is None, "dense" or "sparse". Returns
        (loss, gradients as the optimizer gets them)."""
        t = self.t
        leaves = leaf_list(params)
        for x in leaves:
            x.requires_grad_(True)
        loss = self.loss(params, *batch, dtype)
        grads = list(torch.autograd.grad(loss, leaves, allow_unused=True))
        for x in leaves:
            x.requires_grad_(False)
        grads = [torch.zeros_like(x) if gr is None else gr
                 for x, gr in zip(leaves, grads)]
        with torch.no_grad():
            if tv is not None:
                for i, name in ((0, "density"), (1, "k0")):
                    w = float(t[f"weight_tv_{name}"])
                    if w > 0:
                        grads[i] = self.tv_grad(params[name], grads[i],
                                                w / self.n_rand,
                                                tv == "dense")
            adam_step(self.t, adam, leaves, grads)
        return loss.detach(), grads


def merge_counts(a, b):
    """The counts of two :meth:`Field.render` calls together."""
    if a is None:
        return b
    return {k: (torch.unique(torch.cat([a[k], b[k]])) if torch.is_tensor(a[k])
                else a[k] + b[k]) for k in a}


def count_values(c):
    """Counts with each voxel set replaced by its size."""
    return {k: (int(v.numel()) if torch.is_tensor(v) else v)
            for k, v in c.items()}


def positional_encoding(x, n_freqs):
    if n_freqs <= 0:
        return x
    freqs = 2.0 ** torch.arange(n_freqs, dtype=x.dtype, device=x.device)
    emb = (x[..., None] * freqs).reshape(*x.shape[:-1], -1)
    return torch.cat([x, torch.sin(emb), torch.cos(emb)], -1)


def _axis_term(param, axis, w):
    n = param.shape[axis]
    up = torch.cat([param.narrow(axis, 1, n - 1),
                    param.narrow(axis, n - 1, 1)], axis)
    dn = torch.cat([param.narrow(axis, 0, 1),
                    param.narrow(axis, 0, n - 1)], axis)
    return w * (torch.clamp(param - up, -1.0, 1.0)
                + torch.clamp(param - dn, -1.0, 1.0))


def leaf_list(params):
    """density, k0, then each MLP layer's weight and bias."""
    return [params["density"], params["k0"]] + [
        x for wb in params["mlp"] for x in wb]


def new_adam(params):
    return {"t": 0, "m": [torch.zeros_like(x) for x in leaf_list(params)],
            "v": [torch.zeros_like(x) for x in leaf_list(params)]}


def adam_step(cfg_train, adam, leaves, grads, beta1=0.9, beta2=0.99,
              eps=1e-8):
    """MaskedAdam: bias correction and exponential lr decay folded into one
    step size (computed in float64, rounded to float32 once); the grid
    leaves of ``skip_zero_grad`` groups keep every entry whose gradient is
    zero."""
    adam["t"] += 1
    tt = adam["t"]
    decay = 0.1 ** (1.0 / (float(cfg_train["lrate_decay"]) * 1000))
    corr = np.sqrt(1.0 - beta2 ** tt) / (1.0 - beta1 ** tt)
    skip = set(cfg_train.get("skip_zero_grad_fields", []))
    lrs = [float(cfg_train["lrate_density"]), float(cfg_train["lrate_k0"])] \
        + [float(cfg_train["lrate_rgbnet"])] * (len(leaves) - 2)
    names = ["density", "k0"] + ["rgbnet"] * (len(leaves) - 2)
    for i, (p, g) in enumerate(zip(leaves, grads)):
        step_size = float(np.float32(lrs[i] * decay ** (tt - 1) * corr))
        m, v = adam["m"][i], adam["v"][i]
        g = g.to(p.dtype)
        new_m = beta1 * m + (1.0 - beta1) * g
        new_v = beta2 * v + (1.0 - beta2) * g * g
        new_p = p - step_size * new_m / (torch.sqrt(new_v) + eps)
        if names[i] in skip:
            touched = g != 0
            new_p = torch.where(touched, new_p, p)
            new_m = torch.where(touched, new_m, m)
            new_v = torch.where(touched, new_v, v)
        p.copy_(new_p)
        m.copy_(new_m)
        v.copy_(new_v)
