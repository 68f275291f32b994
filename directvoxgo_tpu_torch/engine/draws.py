"""Batch draws of the training loop: axis groups, window buckets, classes.

Every batch shares one sweep axis: the pool is grouped by each ray's
dominant axis (a model's ``forced_sweep_axis`` takes every ray). The
draws come in chunks, as the JAX package's engine takes them
(:meth:`Draws.next_chunk`, its ``next_chunk(n_sub, no_window)`` with the
loop's ``no_window`` rule): the axis of a chunk is drawn once, in
proportion to its group's size, and all of the chunk's batches come from
that group. Within the group the draw follows that engine:

- On grids whose steps the JAX engine batches (at most 1.1 M voxels, or
  any ``steps_per_dispatch`` above 1: :meth:`Draws.dispatch_width` above 1)
  every batch is uniform within the group, as that engine's scanned steps
  draw. It never draws a window class or a fused tile there: its
  ``no_window`` holds whenever a chunk has more than one step or the
  dispatch width is above 1, and for the fused trainer's TV steps.
- On the others (one step a chunk) a batch is one spatially sorted segment
  of one window class and trains as a composed clip box (kernels K-A and
  K-C read only the window): forced-axis (MPI) pools as 2D (u, v) windows
  with the station extent pinned to the grid's, perspective pools as 2D
  windows over the occupancy box, as per-p-block windows under
  ``bucket_blocked`` (the ``('blk', B, eu, ev)`` step) or as v-windows
  with ``bucket_2d`` off. With the fused trainer (``DVGO_FUSED_TRAIN``)
  same-class tiles come first and the remainder, which trains unfused, is
  re-bucketed through 2D windows, then blocked windows
  (:func:`rebucket_remainder`). A class is drawn in proportion to its ray
  count and a segment uniformly within it. Windows compose with the clip
  box: a window that overhangs the box is shifted back inside, which is
  exact because the rows it uncovers have an interpolated mask of 0.

The buckets are built synchronously, at the stage start and after each
progressive rescale, and again at a draw that finds the clip box moved by
a renewal (the forced-axis build measures no box and is kept); each build
prints its seconds.
A TV step of the fused trainer draws uniformly (its step needs full-size
gradients, which the fused step does not give).

With all axes ready, a chunk consumes the stage's generator exactly as the
JAX engine's steady state does: one ``rng.choice(3, p=group_p)``, then
the group's draws.

A gather model (``query_mode='gather'``) has no sweep axis: as in the JAX
engine (``use_sweep`` false) every batch is drawn from the whole pool, by
``batch_indices_generator(n_pool, N_rand, rng)`` for the ``flatten`` and
``in_maskcache`` samplers (when the pool holds a batch), else by
``rng.integers(0, n_pool, N_rand)``; chunks keep the dispatch width, and
there are no axis groups, windows or fused tiles.
"""

from __future__ import annotations

import time

import numpy as np

from .. import rays as ray_lib
from ..ops import sweep as sweep_ops
from ..ops import train_fused as fused_ops

# Grids up to this many voxels run the JAX engine's batched dispatch
# (8 steps a call by default), which never windows.
SMALL_GRID_VOXELS = 1_100_000
WINDOW_WIDTHS = (32, 48, 64, 96)


def rebucket_remainder(keep, g, rays_o, rays_d, xyz_min, xyz_max,
                       world_size, axis, n_rand, box6,
                       widths2d=(48, 64, 96), n_blocks=6):
    """Re-bucket the fused trainer's remainder tiles (``keep[('fblk', 0, 0,
    0)]``, pool indices [n_tiles, 512]) in place: padded to one segment
    with rays of the group ``g`` (``np.random.default_rng(0)``), through
    :func:`..ops.sweep.build_ray_segments_2d` (keys ``(wu, wv)``: pool
    indices, u and v offsets), then what is left through
    :func:`..ops.sweep.build_ray_segments_blocked` (keys ``('blk', wu,
    wv)``). Rays no class takes stay in the remainder key."""
    rk0 = ("fblk", 0, 0, 0)
    if keep.get(rk0) is None:
        return keep
    rr = np.asarray(keep[rk0]).reshape(-1)
    if rr.size < n_rand:
        pad = np.random.default_rng(0).choice(g, size=n_rand - rr.size)
        rr = np.concatenate([rr, pad])
    geo = (xyz_min, xyz_max, world_size, axis)
    b2 = sweep_ops.build_ray_segments_2d(
        rays_o[rr], rays_d[rr], *geo, n_rand=n_rand, widths=tuple(widths2d),
        max_classes=3, clip_box=box6)
    if b2:
        keep.pop(rk0, None)
        for wuv, (idx2, ulo, vlo) in b2.items():
            if idx2.shape[0] == 0:
                continue
            if wuv == (0, 0):
                keep[rk0] = rr[idx2].reshape(-1, fused_ops.NT)
            else:
                keep[wuv] = (rr[idx2], ulo, vlo)
    left = keep.get(rk0)
    if left is not None and left.size > 0:
        lff = np.asarray(left).reshape(-1)
        bb = sweep_ops.build_ray_segments_blocked(
            rays_o[lff], rays_d[lff], *geo, n_rand=n_rand,
            n_blocks=int(n_blocks), widths=WINDOW_WIDTHS, max_classes=4,
            clip_box=box6)
        if bb:
            keep.pop(rk0, None)
            for wuv, (bi, uo, vo) in bb.items():
                if bi.shape[0] == 0:
                    continue
                if wuv == (0, 0):
                    keep[rk0] = lff[bi].reshape(-1, fused_ops.NT)
                else:
                    keep[("blk", *wuv)] = (lff[bi], uo, vo)
    return keep


class Draws:
    """The draws of one stage: ``next_chunk(n_sub, apply_tv)`` returns
    ``(pool indices [n_sub, N_rand], axis, step key or None, clip offsets
    [n_sub, ...] or None)``; a None key means the stage's clip box
    (``clip_plan[axis]``). Call :meth:`set_grid` at the stage start and
    after every progressive rescale, once ``clip_plan`` is fresh."""

    def __init__(self, model, cfg_train, cfg_model, rays_o, rays_d, near,
                 far, rng, clip_plan, device, stage, world=1):
        self.model, self.cfg_train, self.cfg_model = model, cfg_train, \
            cfg_model
        self.rays_o = np.asarray(rays_o).reshape(-1, 3)
        self.rays_d = np.asarray(rays_d).reshape(-1, 3)
        self.near, self.far, self.rng = near, far, rng
        self.clip_plan, self.device, self.stage = clip_plan, device, stage
        self.n_rand = n_rand = int(cfg_train.N_rand)
        self.n_dispatch, self.windowed = 1, False
        self.buckets = {}        # axis -> (built for, bucket dict or None)
        self.gather = getattr(model, "query_mode", "sweep") != "sweep"
        if self.gather:
            n_pool = self.rays_d.shape[0]
            if cfg_train.ray_sampler in ("flatten", "in_maskcache") \
                    and n_pool >= n_rand:
                gen = ray_lib.batch_indices_generator(n_pool, n_rand,
                                                      rng=rng)
                self.gather_gen = lambda: np.asarray(next(gen))
            else:
                self.gather_gen = lambda: rng.integers(0, n_pool, n_rand)
            self.bucket_ok = self.bucket2d_ok = self.fused_tiles = False
            return

        groups = sweep_ops.sweep_axes(model, self.rays_d)
        self.group_idx = [np.flatnonzero(groups == ax) for ax in range(3)]
        p = np.array([len(g) for g in self.group_idx], np.float64)
        self.group_p = p / p.sum()
        print("gather_training_rays: sweep axis groups",
              [len(g) for g in self.group_idx])
        self.group_gens = []
        for g in self.group_idx:
            if len(g) >= n_rand:
                gen = ray_lib.batch_indices_generator(len(g), n_rand,
                                                      rng=rng)
                self.group_gens.append(
                    lambda g=g, gen=gen: g[np.asarray(next(gen))])
            elif len(g) > 0:
                self.group_gens.append(
                    lambda g=g: g[rng.integers(0, len(g), n_rand)])
            else:
                self.group_gens.append(None)

        self.forced = getattr(model, "forced_sweep_axis", None)
        bucket_tiles = bool(cfg_train.get("bucket_tiles", True))
        # Data-parallel steps (``world`` ranks) split each batch: a rank's
        # share must still be whole ray tiles (and whole fused tiles), and
        # forced-axis 2D buckets are off, as in the JAX engine.
        self.bucket_ok = (bucket_tiles and self.forced is None
                          and n_rand % (sweep_ops.TILE_N * world) == 0)
        self.bucket2d_ok = (bucket_tiles and self.forced is not None
                            and world == 1)
        self.persp2d = self.bucket_ok and bool(
            cfg_train.get("bucket_2d", True))
        self.fused_tiles = (self.persp2d
                            and bool(cfg_train.get("fused_tiles", True))
                            and n_rand % (fused_ops.NT * world) == 0
                            and fused_ops.fused_enabled(device)
                            and model.supports_fused_step())

    # ------------------------------------------------------------ builds

    def dispatch_width(self):
        """Steps the JAX engine takes a dispatch on the current grid (its
        ``dispatch_width()``): ``steps_per_dispatch``, by default 8 on
        grids of up to 1.1 M voxels and 1 above."""
        small = int(np.prod(self.model.world_size)) <= SMALL_GRID_VOXELS
        return max(int(self.cfg_train.get(
            "steps_per_dispatch", 8 if small else 1)), 1)

    def windows_engage(self):
        """Whether the JAX engine would take one step a dispatch on the
        current grid (:meth:`dispatch_width` 1): windows engage only
        then."""
        return Draws.dispatch_width(self) == 1

    def set_grid(self):
        """Re-evaluate the dispatch width and the window rule, and build the
        segment buckets for the current grid and clip boxes (the fused
        tiles build in line)."""
        self.n_dispatch = self.dispatch_width()
        self.windowed = self.n_dispatch == 1
        if self.windowed and not self.fused_tiles \
                and (self.bucket_ok or self.bucket2d_ok):
            for ax in ([int(self.forced)] if self.bucket2d_ok
                       else range(3)):
                self._buckets_of(ax)

    def box(self, ax):
        """((bp, bu, bv), offsets int32[3]) of axis ``ax``: its clip box,
        or the whole grid at zero offsets."""
        csz, coff = self.clip_plan[ax]
        if csz is not None:
            return (tuple(int(x) for x in csz),
                    np.asarray(coff, np.int32))
        return (tuple(int(self.model.world_size[a])
                      for a in sweep_ops._PERMS[ax]),
                np.zeros(3, np.int32))

    def _box6(self, ax):
        """Inclusive (p, u, v) bounds of the clip box of ``ax``, or None."""
        if self.clip_plan[ax][0] is None:
            return None
        sizes, offs = self.box(ax)
        return tuple(float(x) for o, b in zip(offs, sizes)
                     for x in (o, o + b - 1))

    def _buckets_of(self, ax):
        """The bucket dict of axis ``ax``, built when the grid, the clip box
        or the window rule changed since its last build."""
        sizes, offs = self.box(ax)
        # the forced-axis build measures no box, so only the grid counts
        built_for = (tuple(self.model.world_size), self.windowed) + (
            () if self.bucket2d_ok else (sizes, tuple(int(o) for o in offs)))
        if ax in self.buckets and self.buckets[ax][0] == built_for:
            return self.buckets[ax][1]
        g = self.group_idx[ax]
        out = None
        if len(g) >= self.n_rand:
            t0 = time.time()
            out = (self._build_fused(ax, g) if self.fused_tiles
                   else self._build_segments(ax, g))
            if out and self.windowed:
                rays = {k: (v if isinstance(v, np.ndarray) else v[0]).size
                        for k, v in out.items()}
                print(f"scene_rep_reconstruction ({self.stage}): segment "
                      f"classes ax{ax}: " + " ".join(
                          f"{k}:{c / sum(rays.values()):.2f}" for k, c in
                          sorted(rays.items(), key=lambda kv: -kv[1]))
                      + f" (built in {time.time() - t0:.2f} s)")
        self.buckets[ax] = (built_for, out)
        return out

    def _build_segments(self, ax, g):
        m, ct = self.model, self.cfg_train
        geo = (m.xyz_min, m.xyz_max,
               tuple(int(x) for x in m.world_size), ax)
        ro, rd = self.rays_o[g], self.rays_d[g]
        if self.bucket2d_ok:
            b = sweep_ops.build_ray_segments_2d(
                ro, rd, *geo, n_rand=self.n_rand, widths=WINDOW_WIDTHS)
        elif self.persp2d and bool(ct.get("bucket_blocked", False)):
            b = sweep_ops.build_ray_segments_blocked(
                ro, rd, *geo, n_rand=self.n_rand,
                n_blocks=int(ct.get("bucket_blocks", 6)),
                widths=WINDOW_WIDTHS, max_classes=6,
                clip_box=self._box6(ax))
            b = {("blk", *k): v for k, v in b.items()}
        elif self.persp2d:
            b = sweep_ops.build_ray_segments_2d(
                ro, rd, *geo, n_rand=self.n_rand, widths=WINDOW_WIDTHS,
                max_classes=6, clip_box=self._box6(ax))
        else:
            box6 = self._box6(ax)
            b = sweep_ops.build_ray_segments(
                ro, rd, *geo, n_rand=self.n_rand, clip_box=None
                if box6 is None else box6[:2] + box6[4:])
        return {k: (g[v[0]], *v[1:]) for k, v in b.items()
                if v[0].shape[0] > 0} or None

    def _build_fused(self, ax, g):
        m, ct = self.model, self.cfg_train
        t0 = time.time()
        (bp, bu, bv), _ = self.box(ax)
        box6 = self._box6(ax)
        tiles = sweep_ops.build_ray_tiles_blocktile(
            self.rays_o[g], self.rays_d[g], m.xyz_min, m.xyz_max,
            tuple(int(x) for x in m.world_size), ax, self.near, self.far,
            self.cfg_model.stepsize, nt=fused_ops.NT,
            max_classes=int(ct.get("fused_tile_classes", 4)),
            clip_box=box6)
        fdim = m.k0_dim if m.rgbnet_direct else m.k0_dim - 3
        keep, rest = {}, []
        for kk, idx in tiles.items():
            if idx.shape[0] == 0:
                continue
            # a class the fused step does not take trains unfused
            if kk[:2] == (0, 0) or fused_ops.fused_available(
                    self.n_rand, bu, bv, fdim, int(m.rgbnet_width),
                    float(m.fast_color_thres), int(m.rgbnet_depth),
                    wu=int(kk[0]), wv=int(kk[1]), device=self.device):
                keep[("fblk", *kk)] = g[idx]
            else:
                rest.append(g[idx])
        rk0 = ("fblk", 0, 0, 0)
        if rest:
            keep[rk0] = np.concatenate(rest + ([keep[rk0]] if rk0 in keep
                                               else []), axis=0)
        n_tiled = sum(v.size for v in keep.values())
        print(f"scene_rep_reconstruction ({self.stage}): fused tiles axis "
              f"{ax}, box {(bp, bu, bv)}: "
              f"{ {k[1:]: int(v.shape[0]) for k, v in keep.items()} } "
              f"tiles per class, remainder "
              f"{keep[rk0].size / n_tiled if rk0 in keep else 0.0:.3f} "
              f"of rays, built in {time.time() - t0:.1f} s")
        if self.windowed:
            rebucket_remainder(
                keep, g, self.rays_o, self.rays_d, m.xyz_min, m.xyz_max,
                tuple(int(x) for x in m.world_size), ax, self.n_rand, box6,
                widths2d=ct.get("remainder2d_widths", (48, 64, 96)),
                n_blocks=ct.get("bucket_blocks", 6))
        return keep or None

    # ------------------------------------------------------------- draws

    def next_chunk(self, n_sub, apply_tv):
        """The batches of a chunk of ``n_sub`` steps (a gather model's: from
        the whole pool, axis None): the axis drawn once,
        then ``n_sub`` batches of that group. Under the JAX loop's
        ``no_window`` (``n_sub > 1``, a dispatch width above 1, or a TV step
        of the fused trainer) each is uniform within the group; else (one
        step where windows engage) the window classes and fused tiles
        draw."""
        if self.gather:
            return (np.stack([self.gather_gen() for _ in range(n_sub)]),
                    None, None, None)
        ax = int(self.rng.choice(3, p=self.group_p))
        no_window = (n_sub > 1 or self.n_dispatch > 1
                     or (apply_tv and self.fused_tiles))
        if not no_window and self.windowed \
                and (self.bucket_ok or self.bucket2d_ok):
            bk = self._buckets_of(ax)
            out = None
            if bk:
                keys = [k for k in bk if isinstance(k, tuple)]
                # a fused build keeps its branch when the re-bucketing
                # took every remainder ray (no 'fblk' key left)
                if self.fused_tiles:
                    out = self._draw_fused(ax, bk)
                elif any(k[0] == "blk" for k in keys):
                    out = self._draw_blocked(ax, bk)
                elif keys:
                    out = self._draw_2d(ax, bk)
                else:
                    out = self._draw_1d(ax, bk)
            if out is not None:
                sel, ax, key, off = out
                return (np.asarray(sel)[None], ax, key,
                        None if off is None else np.asarray(off)[None])
        return (np.stack([self.group_gens[ax]() for _ in range(n_sub)]),
                ax, None, None)

    def _pick(self, cands, counts):
        counts = np.asarray(counts, np.float64)
        return cands[int(self.rng.choice(len(cands),
                                         p=counts / counts.sum()))]

    def _segment(self, idx):
        return int(self.rng.integers(0, idx.shape[0]))

    @staticmethod
    def _eff(k, bu, bv):
        """A class's window extents in a box of (bu, bv): a 0 slot, or a
        window at least the box's extent, is the full extent."""
        return (k[0] if 0 < k[0] < bu else bu,
                k[1] if 0 < k[1] < bv else bv)

    def _grid_uv(self, ax):
        perm = sweep_ops._PERMS[ax]
        return (int(self.model.world_size[perm[1]]),
                int(self.model.world_size[perm[2]]))

    def _draw_fused(self, ax, bk):
        """Same-class 512-ray tiles (``('fblk', wu, wv, sign)``; the
        remainder ``('fblk', 0, 0, 0)`` trains unfused over the clip box),
        2D windows ``(wu, wv)`` and blocked windows ``('blk', wu, wv)`` of
        the re-bucketed remainder."""
        (bp, bu, bv), offs3 = self.box(ax)
        gu, gv = self._grid_uv(ax)
        cands, counts = [], []
        for kk in bk:
            if kk[0] == "fblk":
                skey = None if kk[1:3] == (0, 0) else \
                    ("fblk", int(kk[1]), int(kk[2]), bp, bu, bv)
                cands.append((kk, skey))
                counts.append(bk[kk].size)
            elif kk[0] == "blk":
                # the blocked step sweeps the whole grid: its windows and
                # offsets are the grid's
                nb = bk[kk][1].shape[1]
                cands.append((kk, ("blk", nb, *self._eff(kk[1:], gu, gv))))
                counts.append(bk[kk][0].size)
            elif self._eff(kk, bu, bv) != (bu, bv):
                cands.append((kk, (bp, *self._eff(kk, bu, bv))))
                counts.append(bk[kk][0].size)
        if all(s is None for _, s in cands):
            return None
        kk, skey = self._pick(cands, counts)
        if kk[0] == "blk":
            idx, uo, vo = bk[kk]
            r = self._segment(idx)
            return idx[r], ax, skey, np.stack([uo[r], vo[r]], 1).astype(
                np.int32)
        if kk[0] != "fblk":
            idx, ulo, vlo = bk[kk]
            r = self._segment(idx)
            return idx[r], ax, skey, self._clamped(
                offs3, (bu, bv), skey[1:], ulo[r], vlo[r])
        idx = bk[kk]
        n_draw = self.n_rand // fused_ops.NT
        rows = self.rng.choice(idx.shape[0], size=n_draw,
                               replace=idx.shape[0] < n_draw)
        return idx[rows].reshape(-1), ax, skey, (
            None if skey is None else offs3)

    def _draw_blocked(self, ax, bk):
        """Per-p-block windows ``('blk', wu, wv)``; the fallback class
        ``('blk', 0, 0)`` trains its segments over the clip box."""
        gu, gv = self._grid_uv(ax)
        cands, counts = [], []
        for kk in bk:
            nb = bk[kk][1].shape[1]
            cands.append((kk, None if kk[1:] == (0, 0) else
                          ("blk", nb, *self._eff(kk[1:], gu, gv))))
            counts.append(bk[kk][0].size)
        if all(s is None for _, s in cands):
            return None
        kk, skey = self._pick(cands, counts)
        idx, uo, vo = bk[kk]
        r = self._segment(idx)
        if skey is None:
            return idx[r], ax, None, None
        return idx[r], ax, skey, np.stack([uo[r], vo[r]], 1).astype(np.int32)

    def _draw_2d(self, ax, bk):
        """2D windows ``(wu, wv)`` as composed boxes (bp, eu, ev); the
        fallback class (0, 0) is not drawn while a window class exists.
        Forced-axis (MPI) boxes keep the grid's whole station extent, so
        that a renewal which shrinks the p clip leaves the keys alone."""
        (bp, bu, bv), offs3 = self.box(ax)
        if self.forced is not None:
            bp = int(self.model.world_size[sweep_ops._PERMS[ax][0]])
            offs3 = np.asarray([0, offs3[1], offs3[2]], np.int32)
        ws = [k for k in bk if k != (0, 0)
              and self._eff(k, bu, bv) != (bu, bv)]
        if not ws:
            return None
        key = self._pick(ws, [bk[k][0].size for k in ws])
        eu, ev = self._eff(key, bu, bv)
        idx, ulo, vlo = bk[key]
        r = self._segment(idx)
        return idx[r], ax, (bp, eu, ev), self._clamped(
            offs3, (bu, bv), (eu, ev), ulo[r], vlo[r])

    def _draw_1d(self, ax, bk):
        """v-windows of width W as composed boxes (bp, bu, W)."""
        (bp, bu, bv), offs3 = self.box(ax)
        ws = [w for w in bk if 0 < int(w) < bv]
        if not ws:
            return None
        w = int(self._pick(ws, [bk[k][0].size for k in ws]))
        idx, svlo, _ = bk[w]
        r = self._segment(idx)
        return idx[r], ax, (bp, bu, w), self._clamped(
            offs3, (bu, bv), (bu, w), offs3[1], svlo[r])

    @staticmethod
    def _clamped(offs3, box_uv, win_uv, ulo, vlo):
        """[p, u, v] offsets of a window of extents ``win_uv`` starting at
        (``ulo``, ``vlo``), shifted into the box (``offs3``, ``box_uv``)."""
        bpo, buo, bvo = (int(x) for x in offs3)
        (bu, bv), (eu, ev) = box_uv, win_uv
        return np.asarray([bpo, min(max(int(ulo), buo), buo + bu - eu),
                           min(max(int(vlo), bvo), bvo + bv - ev)],
                          np.int32)
