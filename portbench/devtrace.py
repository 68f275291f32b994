"""Spans and the device trace of a run.

:class:`Spans` times the benchmark's own spans around each call into a
layer of the program (host clock), and names them in the profiler's
timeline when tracing. :class:`TraceWindow` runs the measured window under
``torch.profiler`` (CPU and CUDA activities) and reduces the trace to what
the metrics read: the device's busy time as the union of its kernel, copy
and fill intervals (overlapping streams counted once), the idle gaps with
the span the host was in, and device time by kernel name.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import time

import torch

PREFIX = "portbench."
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")


class Spans:
    """Host-clock durations (seconds) of named spans; with ``traced`` each
    span is also a ``record_function`` range named ``portbench.<name>``."""

    def __init__(self, traced=False):
        self.traced = traced
        self.times = collections.defaultdict(list)

    @contextlib.contextmanager
    def span(self, name):
        rf = (torch.profiler.record_function(PREFIX + name) if self.traced
              else contextlib.nullcontext())
        t0 = time.perf_counter()
        with rf:
            yield
        self.times[name].append(time.perf_counter() - t0)


def _ns(ev, what):
    fn = getattr(ev, f"{what}_ns", None)
    if fn is not None:
        return int(fn())
    return int(getattr(ev, f"{what}_us")() * 1000)


def _activity(ev):
    fn = getattr(ev, "activity_type", None)
    if fn is None:
        return None
    try:
        return str(fn())
    except (RuntimeError, TypeError):
        return None


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def reduce_events(events, window_ns):
    """The trace summary of raw profiler events (objects with ``name()``,
    ``device_type()``, ``start_ns()``/``duration_ns()`` or their ``_us``
    forms): ``busy_s``, ``window_s``, ``kernel_s`` (device seconds by
    kernel name), ``idle_gaps`` ([label, seconds], the ten longest) and
    ``idle_by_span`` (idle seconds by the host span)."""
    from torch.autograd import DeviceType
    dev, spans, ops = [], [], []
    for ev in events:
        name = ev.name()
        start = _ns(ev, "start")
        dur = _ns(ev, "duration")
        if ev.device_type() == DeviceType.CUDA:
            act = _activity(ev)
            if name.startswith(PREFIX) or (
                    act is not None and not any(a in act.lower()
                                                for a in DEVICE_ACTIVITIES)):
                continue
            dev.append((start, start + dur, name))
        elif name.startswith(PREFIX):
            spans.append((start, start + dur, name[len(PREFIX):]))
        else:
            ops.append((start, start + dur, name))
    if not dev:
        return None
    by_kernel = collections.Counter()
    for a, b, name in dev:
        by_kernel[name] += (b - a) / 1e9
    merged = _merge([[a, b] for a, b, _ in dev])
    busy = sum(b - a for a, b in merged) / 1e9
    spans.sort()
    span_starts = [s[0] for s in spans]
    ops.sort()
    op_starts = [o[0] for o in ops]

    def inner(items, starts, t):
        """The shortest item that holds time ``t``."""
        best = None
        i = bisect.bisect_right(starts, t)
        for j in range(i - 1, max(i - 64, -1), -1):
            a, b, name = items[j]
            if a <= t <= b and (best is None or b - a < best[1] - best[0]):
                best = (a, b, name)
        return best[2] if best else None

    gaps = [(b0, a1) for (_, b0), (a1, _) in zip(merged, merged[1:])]
    idle_by_span = collections.Counter()
    for a, b in gaps:
        idle_by_span[inner(spans, span_starts, a) or "other"] += (b - a) / 1e9
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    idle_gaps = []
    for a, b in longest:
        label = inner(spans, span_starts, a) or "other"
        op = inner(ops, op_starts, a)
        idle_gaps.append([label + (f"/{op}" if op else ""), (b - a) / 1e9])
    return {"busy_s": min(busy, window_ns / 1e9), "window_s": window_ns / 1e9,
            "kernel_s": dict(by_kernel), "idle_gaps": idle_gaps,
            "idle_by_span": dict(idle_by_span), "n_device_events": len(dev)}


def kineto_events(prof):
    """The raw events of a finished ``torch.profiler.profile``."""
    res = getattr(prof.profiler, "kineto_results", None)
    if res is not None:
        return res.events()
    raise RuntimeError("the profiler kept no kineto results")


class TraceWindow:
    """``with TraceWindow(on) as tw:`` profiles the block when ``on``;
    ``tw.summary`` is :func:`reduce_events`' result (None when off or when
    the trace holds no device time)."""

    def __init__(self, on):
        self.on = on
        self.summary = None

    def __enter__(self):
        if self.on:
            from torch.profiler import ProfilerActivity, profile
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if not self.on:
            return False
        torch.cuda.synchronize()
        window = time.perf_counter_ns() - self.t0
        self.prof.__exit__(*exc)
        if exc[0] is None:
            self.summary = reduce_events(kineto_events(self.prof), window)
        return False


def top_kernels(summary, n=10):
    """[[name, seconds], ...] of the ``n`` kernels with most device time."""
    rows = sorted(summary["kernel_s"].items(), key=lambda kv: -kv[1])[:n]
    return [[name[:120], s] for name, s in rows]


def kernel_seconds(summary, patterns):
    """Device seconds of the kernels whose name holds any of
    ``patterns``."""
    return sum(s for name, s in summary["kernel_s"].items()
               if any(p in name for p in patterns))
