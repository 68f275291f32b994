"""Traffic driver "train": fine-stage train steps at the top grid, as
``engine/train.scene_rep_reconstruction`` composes its per-chunk body
(``Draws.next_chunk`` -> ``make_train_step``, cached by key ->
``StepGraphs.run``), with the occupancy renewal and ``refresh_clip``
every :data:`RENEW_EVERY` steps of the window. The TV state is the mix's
(``tv``: "off", "dense" or "sparse"), fixed for the run.

Set-up builds the state the stage has right after its last ``pg_scale``
event: the model at the top grid holding the benchmark's initial state,
a fresh MaskedAdam, the ray pool, the draws, the clip plan and the step
graphs. It then takes three calls of every step key the draws reach (the
first runs eagerly, the second captures the key's graph), puts the
initial state back in place, and takes the three steps the reference
follows: the first draws of the seed, through the window's own calls.
The window continues from there.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import common, counts as counts_lib, inputs

CHECKED_STEPS = 3
# the stage renews the occupancy mask every 1000 steps
RENEW_EVERY = 1000
# window steps the reference counts the work of (a sample drawn from the
# seed)
COUNT_STEPS = 48


def tv_state(cfg, traffic):
    t = cfg["fine_train"]
    on = traffic["tv"] != "off" and (float(t["weight_tv_density"]) > 0
                                     or float(t["weight_tv_k0"]) > 0)
    return on, traffic["tv"] == "dense"


def reachable_draws(draws, clip_plan, apply_tv):
    """One draw of every step key ``draws.next_chunk(1, apply_tv)`` can
    return, each class forced through the draw function the loop would
    take, on a throwaway generator: [(sels [1, N], axis, key, offsets)]."""
    out = []
    real = draws.rng
    draws.rng = np.random.default_rng(0)
    try:
        no_window = draws.n_dispatch > 1 or (apply_tv and draws.fused_tiles)
        for ax in range(3):
            g = draws.group_idx[ax]
            if len(g) == 0:
                continue
            found = False
            if not no_window and draws.windowed \
                    and (draws.bucket_ok or draws.bucket2d_ok):
                bk = draws._buckets_of(ax)
                if bk:
                    keys = [k for k in bk if isinstance(k, tuple)]
                    if draws.fused_tiles:
                        fn = draws._draw_fused
                    elif any(k[0] == "blk" for k in keys):
                        fn = draws._draw_blocked
                    elif keys:
                        fn = draws._draw_2d
                    else:
                        fn = draws._draw_1d
                    for cls in bk:
                        got = fn(ax, {cls: bk[cls]})
                        if got is not None:
                            sel, axis, key, off = got
                            out.append((np.asarray(sel)[None], axis, key,
                                        None if off is None
                                        else np.asarray(off)[None]))
                            found = True
            if not found:
                sel = np.random.default_rng(ax).choice(g, draws.n_rand)
                out.append((sel[None], ax, None, None))
    finally:
        draws.rng = real
    return out


def run(ctx):
    from directvoxgo_tpu_torch.engine import train as train_lib
    from directvoxgo_tpu_torch.engine.draws import Draws
    from directvoxgo_tpu_torch.engine.graphs import StepGraphs
    from directvoxgo_tpu_torch.ops import grid as grid_ops

    cfg, traffic, dev = ctx.cfg, ctx.traffic, ctx.device
    data = inputs.fixture(cfg)
    ctx.mark("fixture")
    geo = inputs.geometry(cfg, data)
    ctx.mark("geometry")
    state = inputs.initial_state(cfg, geo, ctx.seed, dev)
    host0 = inputs.state_to_host(state)
    ctx.mark("initial state")
    pcfg = common.program_config(cfg, data)
    cfg_train, cfg_model = pcfg.fine_train, pcfg.fine_model_and_render
    model = common.build_model(cfg, geo, state, dev)
    pool_mask = state.get("pool_mask")
    del state
    ctx.mark("model")
    optimizer = train_lib.create_optimizer_or_freeze_model(model, cfg_train)
    rk = common.render_kwargs(cfg, data)
    n_img = len(data["poses"])
    data_dict = {"images": data["images"], "poses": data["poses"],
                 "HW": np.array([[data["H"], data["W"]]] * n_img),
                 "Ks": np.repeat(data["K"][None], n_img, 0),
                 "i_train": data["i_train"], "irregular_shape": False}
    if pool_mask is not None:
        # the stage draws its pool through the coarse geometry's mask
        with torch.no_grad():
            model.mask.copy_(pool_mask)
    rgb_tr, ro_tr, rd_tr, vd_tr, _ = train_lib.gather_training_rays(
        model, pcfg, cfg_train, data_dict, rk)
    if pool_mask is not None:
        with torch.no_grad():
            model.mask.copy_(host0["mask"].to(dev))
        del pool_mask
    pool_o = np.asarray(ro_tr, np.float32).reshape(-1, 3)
    pool_d = np.asarray(rd_tr, np.float32).reshape(-1, 3)
    pool_v = np.asarray(vd_tr, np.float32).reshape(-1, 3)
    pool_rgb = np.asarray(rgb_tr, np.float32).reshape(-1, 3)
    ctx.mark("ray pool")

    def to_dev(x):
        return torch.as_tensor(np.ascontiguousarray(x), device=dev)

    pool = {"rgb": to_dev(pool_rgb), "rays_o": to_dev(pool_o),
            "rays_d": to_dev(pool_d), "viewdirs": to_dev(pool_v)}
    rng = np.random.default_rng(inputs.np_seed(ctx.seed))
    clip_plan = {}
    draws = Draws(model, cfg_train, cfg_model, pool_o, pool_d, rk["near"],
                  rk["far"], rng, clip_plan, dev, "fine")

    def refresh_clip():
        # the loop's refresh_clip (engine/train.scene_rep_reconstruction)
        bb = grid_ops.mask_bbox_vox_device(model.mask).cpu().numpy()
        bbox = (bb[0].astype(np.float64), bb[1].astype(np.float64))
        for ax in range(3):
            new = model.sweep_clip_for_axis(ax, bbox=bbox)
            old = clip_plan.get(ax)
            if old is not None and old[0] is not None \
                    and new[0] is not None and old[0] != new[0] \
                    and np.prod(new[0]) > 0.7 * np.prod(old[0]):
                kept = model.sweep_clip_for_axis(ax, fixed_sizes=old[0],
                                                 bbox=bbox)
                if kept[0] is not None:
                    new = kept
            clip_plan[ax] = new

    refresh_clip()
    draws.set_grid()
    ctx.mark("draws and buckets")
    steps = StepGraphs(dev, graphed=dev.type == "cuda")
    steps.reset(scratch=(int(np.prod(model.world_size)), 2 + model.k0_dim))
    apply_tv, tv_dense = tv_state(cfg, traffic)
    train_steps = {}

    def one_step(sels, axis, clip_sizes, offs):
        n_sub = sels.shape[0]
        if clip_sizes is None:
            clip_sizes, clip_off = clip_plan[axis]
            offs = np.broadcast_to(np.asarray(clip_off, np.int32),
                                   (n_sub, 3))
        key = (axis, clip_sizes)
        if key not in train_steps:
            train_steps[key] = train_lib.make_train_step(
                model, optimizer, cfg_train, rk, apply_tv, tv_dense,
                axis=axis, clip_sizes=clip_sizes)
        return steps.run(key, train_steps[key], pool, sels, offs,
                         eager=clip_sizes is not None
                         and clip_sizes[0] == "fblk")

    # every key the draws reach: eager, captured, replayed
    warm = reachable_draws(draws, clip_plan, apply_tv)
    for sels, axis, key, offs in warm:
        for _ in range(3):
            one_step(sels, axis, key, offs)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    ctx.mark(f"warm-up of {len(warm)} step keys")
    # back to the initial state, in place (the graphs read it there)
    with torch.no_grad():
        common.load_state(model, {k: (v.to(dev) if k != "mlp" else
                                      [(w.to(dev), b.to(dev)) for w, b in v])
                                  for k, v in host0.items()})
        st = optimizer.state
        st["step"].zero_()
        for d in (st["exp_avg"], st["exp_avg_sq"]):
            for ts in d.values():
                for t in ts:
                    t.zero_()

    def leaves():
        return [model.density, model.k0] + list(model.rgbnet.parameters())

    def moments():
        st = optimizer.state["exp_avg"]
        return [st["density"][0], st["k0"][0]] + list(st["rgbnet"])

    checked, losses = [], []
    for i in range(CHECKED_STEPS):
        sels, axis, key, offs = draws.next_chunk(1, apply_tv)
        res = one_step(sels, axis, key, offs)
        checked.append((np.asarray(sels[0]), axis))
        losses.append(res[0, 0])
        if i == 0:
            m1 = [x.detach().to("cpu", copy=True) for x in moments()]
    p3 = [x.detach().to("cpu", copy=True) for x in leaves()]
    losses = [float(x) for x in losses]
    ctx.mark("checked steps")

    # ------------------------------------------------------------ window
    spans = ctx.spans
    stats0 = dict(steps.stats)
    window_sels, keys, renewed = [], {}, []
    n = 0
    with ctx.window() as win:
        t0 = time.perf_counter()
        while True:
            if n and n % RENEW_EVERY == 0:
                with spans.span("renewal"):
                    model.update_occupancy_cache()
                    refresh_clip()
                # refresh_clip reads the mask's box back, so every step
                # sent so far has run
                renewed.append(time.perf_counter() - t0)
            with spans.span("draw"):
                sels, axis, key, offs = draws.next_chunk(1, apply_tv)
            with spans.span("step"):
                one_step(sels, axis, key, offs)
            if ctx.trace:
                window_sels.append((np.asarray(sels[0], np.int32), axis))
            keys[(axis, key)] = keys.get((axis, key), 0) + 1
            n += 1
            if time.perf_counter() - t0 >= ctx.seconds:
                break
        with spans.span("sync"):
            if dev.type == "cuda":
                torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    stats = {k: steps.stats[k] - stats0.get(k, 0) for k in steps.stats}
    memory_peak = ctx.memory_peak()
    k0_dim, world_voxels = model.k0_dim, int(np.prod(model.world_size))
    del model, optimizer, steps, train_steps, pool, draws
    common.free_cuda()

    # --------------------------------------------------------- reference
    t_ref = time.perf_counter()
    ref = common.reference_module(cfg)
    field = ref.Field(cfg, geo, rk["near"], rk["far"], rk["bg"])
    tv = (("dense" if tv_dense else "sparse") if apply_tv else None)
    batches, pool_gap = [], 0.0
    for sel, _ in checked:
        views, rows, cols = common.pixel_of_pool(cfg, data, pool_o, pool_d,
                                                 sel)
        ro, rd, vd = common.rays_of_pixels(data, views, rows, cols)
        tgt = data["images"][views, rows, cols]
        pool_gap = max(pool_gap, *(float(np.max(np.abs(a - b))) for a, b in (
            (ro, pool_o[sel]), (rd, pool_d[sel]), (vd, pool_v[sel]),
            (tgt, pool_rgb[sel]))))
        batches.append(tuple(torch.as_tensor(x, device=dev)
                             for x in (ro, rd, vd, tgt)))
    readings = follow(ref, field, host0, batches, dev, tv, torch.float32)
    ref_params = readings.pop("params")
    prog = {"losses": losses, "grads": [m / (1.0 - 0.9) for m in m1],
            "change": [p - q for p, q in zip(p3, ref.leaf_list(host0))]}
    numbers = compare(ref, readings, prog)
    numbers["pool_gap"] = pool_gap
    reference_s = time.perf_counter() - t_ref
    checks = [common.check(k, v, ctx.limits) for k, v in numbers.items()
              if k in ctx.limits]

    rec = {"window_s": window_s, "units": n, "unit": "step",
           "reference_s": reference_s,
           "segments_s": np.diff([0.0] + renewed).tolist(),
           "stats": stats, "memory_peak_bytes": memory_peak,
           "pool_rays": int(pool_o.shape[0]),
           "step_keys": {f"axis {a} {'no window' if k is None else k}": c
                         for (a, k), c in keys.items()},
           "checks": checks, "numbers": numbers,
           "batches": batches, "host0": host0, "readings": readings,
           "tv": tv}
    if ctx.trace:
        rec["counts"] = count_window(ctx, cfg, data, ref, field, ref_params,
                                     pool_o, pool_d, window_sels, k0_dim,
                                     world_voxels, apply_tv, tv_dense)
    return rec


def follow(ref, field, host0, batches, dev, tv, dtype):
    """The reference's steps from the initial state over ``batches``:
    each step's loss, the first step's gradients as the optimizer gets
    them, each leaf's change after the last step, and the parameters."""
    params = common.to_params(host0, dev, dtype)
    adam = ref.new_adam(params)
    losses, grads1 = [], None
    for i, batch in enumerate(batches):
        loss, grads = field.step(params, adam, batch, dtype, tv)
        losses.append(float(loss))
        if i == 0:
            grads1 = [g.detach().to("cpu", torch.float32, copy=True)
                      for g in grads]
    change = [(p.detach().to("cpu", torch.float32) - q) for p, q in zip(
        ref.leaf_list(params), ref.leaf_list(host0))]
    return {"losses": losses, "grads": grads1, "change": change,
            "params": params}


def compare(ref, readings, prog):
    """The numbers compared: the widest relative gap of the steps'
    losses; by leaf, of the first gradient's norm and of the change's
    norm (``*_gap``), and the norm of the program's first gradient less
    the reference's (``grad_diff``), each against the larger of the
    leaf's and the median leaf's reference norm. The change leaves out
    leaves whose reference gradient is under a thousandth of the median
    leaf's (they move by round-off)."""
    lr = np.array(readings["losses"])
    lp = np.array(prog["losses"])
    loss_gap = float(np.max(np.abs(lp - lr) / np.abs(lr)))
    grad_gap, _, gn = common.norm_gap(prog["grads"], readings["grads"])
    grad_diff = common.diff_norm(prog["grads"], readings["grads"])
    moving = gn >= 1e-3 * np.median(gn)
    change_gap, _, _ = common.norm_gap(prog["change"], readings["change"],
                                       moving)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "grad_diff": grad_diff, "change_gap": change_gap}


def count_window(ctx, cfg, data, ref, field, params, pool_o, pool_d,
                 window_sels, k0_dim, world_voxels, apply_tv, tv_dense):
    """Mean work per window step, from the reference's evaluation (at its
    state after the checked steps) of a sample of the window's batches
    drawn from the seed: FLOPs, and the bytes of K-A, K-C and K-F."""
    if not window_sels:
        return None
    rs = np.random.default_rng(inputs.np_seed(ctx.seed) + 1)
    pick = rs.choice(len(window_sels), min(len(window_sels), COUNT_STEPS),
                     replace=False)
    dims = inputs.mlp_dims(cfg)
    tot = {"flops": 0.0, "ka": 0.0, "kc": 0.0, "kf": 0.0}
    with torch.no_grad():
        for i in pick:
            sel, _ = window_sels[i]
            views, rows, cols = common.pixel_of_pool(cfg, data, pool_o,
                                                     pool_d, sel)
            ro, rd, vd = (torch.as_tensor(x, device=ctx.device) for x in
                          common.rays_of_pixels(data, views, rows, cols))
            _, _, c = field.render(params, ro, rd, vd, torch.float32,
                                   want_counts=True)
            c = ref.count_values(c)
            tot["flops"] += counts_lib.step_flops(c, dims, 2 + k0_dim, True)
            tot["ka"] += counts_lib.ka_bytes(c, k0_dim)
            tot["kc"] += counts_lib.kc_bytes(c, k0_dim)
            if apply_tv:
                tot["kf"] += counts_lib.kf_bytes(c, world_voxels, k0_dim,
                                                 tv_dense)
    return {k: v / len(pick) for k, v in tot.items()}
