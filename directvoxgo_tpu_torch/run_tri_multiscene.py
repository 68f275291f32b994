"""Joint multi-scene conditioned driver v1: v2's stages, with the scenes'
ray pools gathered lazily instead of all up front.

Scenes are visited in shuffled epochs (every scene once per epoch,
``batch_size`` steps each, read in order as a data loader reads them); a
small LRU of gathered pools, and a background thread that gathers the
next scheduled scene while the current one trains. Pools are wrap-tiled
to a power-of-two number of rays, so that a uniform draw over the padded
pool stays near-uniform over the real rays.

  python -m directvoxgo_tpu_torch.run_tri_multiscene \\
      --config configs/nerf/tri_multiscene.py [--render_test] [--device cpu]
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from .engine import train_conditioned as cond_lib
from .run_tri import render_kwargs_of
from .run_tri_multiscene_v2 import (aux_weights_of, fine_model, main as
                                    main_v2, make_cond_source)


def _round_up_pow2(n):
    p = 1
    while p < n:
        p *= 2
    return p


class LazyScenePools:
    """``scene_id -> pool``, gathered on demand; at most ``max_cached``
    pools (and scenes' views) kept, :meth:`prefetch` gathers in a
    background thread."""

    def __init__(self, dataset, model, cfg, cfg_train, render_kwargs,
                 max_cached=2):
        self.dataset = dataset
        self.model = model
        self.cfg = cfg
        self.cfg_train = cfg_train
        self.render_kwargs = render_kwargs
        self.max_cached = max_cached
        self._pools = {}      # scene_id -> pool, oldest first
        self._scene_cache = {}
        self._lock = threading.Lock()
        self._threads = {}

    def scene(self, scene_id):
        with self._lock:
            if scene_id not in self._scene_cache:
                if len(self._scene_cache) >= self.max_cached:
                    self._scene_cache.pop(next(iter(self._scene_cache)))
                self._scene_cache[scene_id] = self.dataset.scene_data(
                    scene_id)
            return self._scene_cache[scene_id]

    def _gather(self, scene_id):
        pool = cond_lib.gather_scene_ray_pool(
            self.model, self.cfg, self.cfg_train, self.scene(scene_id),
            self.render_kwargs, scene_id=scene_id)
        n = pool["rgb"].shape[0]
        n_pad = _round_up_pow2(max(n, 1))
        if n_pad > n:
            idx = torch.arange(n_pad, device=pool["rgb"].device) % n
            pool = {k: v[idx] for k, v in pool.items()}
        return pool

    def prefetch(self, scene_id):
        with self._lock:
            if scene_id in self._pools or scene_id in self._threads:
                return

            def work():
                p = self._gather(scene_id)
                with self._lock:
                    self._pools[scene_id] = p
                    self._threads.pop(scene_id, None)

            t = threading.Thread(target=work, daemon=True)
            self._threads[scene_id] = t
            t.start()

    def __call__(self, scene_id):
        with self._lock:
            t = self._threads.get(scene_id)
        if t is not None:
            t.join()
        with self._lock:
            pool = self._pools.get(scene_id)
        if pool is None:
            pool = self._gather(scene_id)
        with self._lock:
            self._pools.pop(scene_id, None)
            self._pools[scene_id] = pool
            while len(self._pools) > self.max_cached:
                self._pools.pop(next(iter(self._pools)))
        return pool

    def join(self):
        """Wait for the prefetch threads still running."""
        with self._lock:
            threads = list(self._threads.values())
        for t in threads:
            t.join()


class EpochSchedule:
    """Shuffled-epoch scene order (every scene once per epoch,
    ``batch_per_scene`` steps each) with a one-ahead prefetch."""

    def __init__(self, n_scene, pools, batch_per_scene=1, seed=0):
        self.n_scene = n_scene
        self.pools = pools
        self.batch_per_scene = max(int(batch_per_scene), 1)
        self.rng = np.random.default_rng(seed)
        self.order = []
        self.i = 0

    def __call__(self, rng, step):
        slot = self.i // self.batch_per_scene
        if not self.order or slot >= len(self.order):
            self.order = list(self.rng.permutation(self.n_scene))
            self.i = 0
            slot = 0
        sid = self.order[slot]
        if slot + 1 < len(self.order):
            self.pools.prefetch(self.order[slot + 1])
        self.i += 1
        return sid


def fine_stage(args, cfg, dataset, xyz_min, xyz_max, device):
    """The fine stage over lazily gathered pools in shuffled epochs."""
    model, optimizer = fine_model(args, cfg, dataset, xyz_min, xyz_max,
                                  device)
    sc0 = dataset.scene_data(0)
    render_kwargs = render_kwargs_of(cfg, sc0['near'], sc0['far'])
    pools = LazyScenePools(dataset, model, cfg, cfg.fine_train,
                           render_kwargs,
                           max_cached=int(cfg.data.get('cache_scenes', 2)))
    schedule = EpochSchedule(dataset.n_scene, pools,
                             batch_per_scene=int(cfg.data.get('batch_size',
                                                              1)),
                             seed=args.seed)
    try:
        cond_lib.train_conditioned_stage(
            args, cfg, cfg.fine_train, model, optimizer, pools,
            make_cond_source(cfg, pools.scene, device), render_kwargs,
            stage='fine', aux_weights=aux_weights_of(cfg.fine_train),
            multiscene=True, n_scene=dataset.n_scene,
            scene_sampler=schedule)
    finally:
        pools.join()
    return model


def main(argv=None):
    main_v2(argv, fine=fine_stage)


if __name__ == '__main__':
    main()
