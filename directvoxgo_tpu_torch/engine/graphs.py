"""Step batching as CUDA graphs of the unfused train step.

The JAX engine runs up to 8 train steps in one dispatch
(``make_train_step(n_steps)``, a ``lax.scan``) because a dispatch cost more
than a step. The port's unfused steps are bound by the host the same way:
some 430 eager launches a step. Its counterpart of one dispatch is one CUDA
graph replay: on a CUDA device every step key of the stage gets one graph
of its step, replayed once per step of a chunk (one graph a step, not a
chunk: the chunks of 8 and their single-step edges share it).

- The first call of a key is an ordinary eager step, run on the stage's
  side stream (the warm-up: kernel builds, library workspaces, K-C's
  scratch), and it is that step's real update.
- The key's second call captures the step (a capture records, it does not
  run) and replays the graph at once for that step's update; every later
  call replays.
- The graph reads its batch indices and clip offsets from a static device
  buffer, one row of ``N_rand`` indices and the offsets, int64. A chunk's
  rows go up in one copy from pinned host memory; before each replay its
  row is copied into the buffer. Loss and PSNR leave the graph as one [2]
  tensor, copied into the chunk's results before the next replay.
- All graphs of a stage share one memory pool; :meth:`StepGraphs.reset`
  drops them with it (at every pg_scale event and TV flip, where the loop
  drops its steps) and grows K-C's scratch to the stage's grid first.
- The kernels' launch counters (:data:`COUNTERS`) count per replay: what a
  capture counted is taken back and added again at each replay.

A failed capture or replay raises; nothing falls back to eager steps on
the card. ``graphed=False`` runs every step eagerly (the tests, and
``chip_smoke.py``'s comparison of the two); the CPU always runs eagerly.
A graphed step does the same arithmetic as the eager one.
"""

from __future__ import annotations

import collections
import time

import numpy as np
import torch

from ..ops import sweep_bwd, sweep_fwd
from ..ops import tv as tv_ops

# (owner, attribute) of every launch counter a step may bump: an int, or a
# dict of ints (changed in place). Whoever counts launches by other means
# may append its own.
COUNTERS = [(sweep_fwd, "launches"), (sweep_fwd, "launches_windowed"),
            (sweep_fwd, "launches_by_form"), (sweep_bwd, "launches"),
            (sweep_bwd, "launches_by_form"), (tv_ops, "launches"),
            (tv_ops, "launches_by_path")]


def _counts():
    out = []
    for owner, name in COUNTERS:
        v = getattr(owner, name)
        out.append(dict(v) if isinstance(v, dict) else int(v))
    return out


def _restore(counts):
    for (owner, name), v in zip(COUNTERS, counts):
        if isinstance(v, dict):
            cur = getattr(owner, name)
            cur.clear()
            cur.update(v)
        else:
            setattr(owner, name, v)


def _delta(before, after):
    return [{k: n - b.get(k, 0) for k, n in a.items() if n != b.get(k, 0)}
            if isinstance(a, dict) else a - b
            for b, a in zip(before, after)]


def _add(delta):
    for (owner, name), d in zip(COUNTERS, delta):
        if isinstance(d, dict):
            cur = getattr(owner, name)
            for k, n in d.items():
                cur[k] = cur.get(k, 0) + n
        elif d:
            setattr(owner, name, getattr(owner, name) + d)


class _Entry:
    """One step key: its step, calls so far, and once captured its graph,
    static input row, [2] output and the counters one replay adds."""

    def __init__(self, step):
        self.step, self.calls = step, 0
        self.graph = self.row = self.out = self.delta = self.keep = None


class StepGraphs:
    """The steps of one stage, replayed as CUDA graphs on a CUDA device
    (``graphed``), else run eagerly. ``stats`` counts the steps by how they
    ran (``eager``, ``capture``: the capture and its first replay,
    ``replay``); ``capture_s`` holds each capture's seconds by key."""

    def __init__(self, device, graphed=True):
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.graphed = bool(graphed) and self.device.type == "cuda"
        self.stats = collections.Counter()
        self.capture_s = {}
        self.entries = {}
        self.pool = None
        if self.graphed:
            self.stream = torch.cuda.Stream(self.device)

    def reset(self, scratch=None):
        """Drop every graph and their pool. ``scratch`` = (voxels, channels):
        grow K-C's scratch to that size now, so that no step of the stage
        reallocates it under a graph."""
        self.entries = {}
        if self.graphed:
            self.pool = torch.cuda.graph_pool_handle()
            if scratch is not None:
                sweep_bwd.reserve_scratch(self.device, *scratch)

    def run(self, key, step, pool, sels, offs, eager=False):
        """A chunk of ``key``'s step: ``sels`` [n, N] pool indices and
        ``offs`` [n, ...] clip offsets (host integers). ``eager``: run it
        eagerly with host offsets (the fused keys). Returns the [n, 2]
        (loss, psnr) tensor, not synchronised."""
        n = sels.shape[0]
        offs = np.asarray(offs)
        packed = np.concatenate([np.asarray(sels, np.int64).reshape(n, -1),
                                 offs.astype(np.int64).reshape(n, -1)], 1)
        # pinned memory is not reused before its copy has left
        rows = (torch.from_numpy(packed).pin_memory().to(
            self.device, non_blocking=True) if self.graphed
            else torch.as_tensor(packed, device=self.device))
        res = torch.empty((n, 2), dtype=torch.float32, device=self.device)
        for i in range(n):
            self.call(key, step, pool, rows[i], sels.shape[1],
                      offs.shape[1:], res[i],
                      host_off=offs[i] if eager else None)
        return res

    def call(self, key, step, pool, row, n_rand, off_shape, out,
             host_off=None):
        """One step of ``key`` on the packed input ``row`` (device int64:
        ``n_rand`` pool indices, then the offsets of shape ``off_shape``);
        (loss, psnr) into ``out`` [2]. Returns how it ran: "eager",
        "capture" or "replay"."""
        def packed(x):
            off = (host_off if host_off is not None else
                   x[n_rand:].to(torch.int32).reshape(off_shape))
            return torch.stack(step(pool, x[:n_rand], off))

        entry = self.entries.get(key)
        if entry is None or entry.step is not step:
            entry = self.entries[key] = _Entry(step)
        entry.calls += 1
        if not self.graphed or host_off is not None:
            out.copy_(packed(row))
            how = "eager"
        elif entry.calls == 1:
            self.stream.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(self.stream):
                out.copy_(packed(row))
            torch.cuda.current_stream(self.device).wait_stream(self.stream)
            how = "eager"
        elif entry.graph is None:
            self._capture(key, entry, packed, row)
            how = "capture"
        else:
            how = "replay"
        if entry.graph is not None:
            entry.row.copy_(row)
            entry.graph.replay()
            _add(entry.delta)
            out.copy_(entry.out)
        self.stats[how] += 1
        return how

    def _capture(self, key, entry, packed, row):
        t0 = time.perf_counter()
        entry.row = torch.empty_like(row)
        entry.row.copy_(row)
        # The graph writes K-C's scratch where it lies now: keep it alive
        # with the graph.
        entry.keep = sweep_bwd._scratch.get(self.device)
        before = _counts()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, pool=self.pool, stream=self.stream):
                entry.out = packed(entry.row)
        finally:
            after = _counts()
            _restore(before)
        entry.delta = _delta(before, after)
        entry.graph = graph
        self.capture_s[key] = time.perf_counter() - t0
