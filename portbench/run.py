"""Run one cell of BENCHMARK.json once and print its result line.

  python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
      --trace <0|1>

The cell names its configuration (``configs/<config>.json``) and its
traffic mix (``traffic/<traffic>.json``, which names its driver,
``traffic/<driver>.py``); its limits are ``limits/<cell>.json`` and each
metric is read by ``metrics/<metric>.py``. Set-up runs from the process's
start to the window's; the window runs ``--seconds``; then the reference
judges what the window produced. With ``--trace 0`` the result carries
the cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics,
the window then running under ``torch.profiler``. The last line on
standard output is the JSON result; the compared numbers and their limits
are the last lines on standard error. Exits 2 without a result when there
is no CUDA device or fewer than the cell asks for, and 3 when ``jax``,
``jaxlib``, ``flax`` or ``directvoxgo_tpu`` is loaded once the window has
closed.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import os
import subprocess
import sys
import time


def _process_start_wall():
    """The wall-clock time this process started (Linux /proc), else now."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start_ticks = int(fields[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f
                         if line.startswith("btime"))
        return btime + start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


T_PROCESS = _process_start_wall()
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if sys.path and os.path.abspath(sys.path[0] or ".") == HERE:
    sys.path[0] = ROOT          # run as a script: import portbench.*
elif ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# Build and kernel caches at fixed paths inside the checkout.
CACHE = os.path.join(ROOT, ".portbench_cache")
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                   ("CUDA_CACHE_PATH", "cuda")):
    os.environ[_var] = os.path.join(CACHE, _sub)
os.environ["USE_FLAX"] = "0"

FORBIDDEN = ("jax", "jaxlib", "flax", "directvoxgo_tpu")


def forbidden_modules(modules=None):
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN`,
    compared as whole names."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def load_file(kind, name, root=HERE):
    """The module ``<root>/<kind>/<name>.py`` (a traffic driver or a metric
    reader), found by name and loaded from its file."""
    path = os.path.join(root, kind, f"{name}.py")
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    modname = f"portbench.{kind}.{name.replace('.', '__')}"
    if root == HERE and modname in sys.modules:
        return sys.modules[modname]
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    if root == HERE:
        sys.modules[modname] = mod
    spec.loader.exec_module(mod)
    return mod


def read_json(path):
    with open(path) as f:
        return json.load(f)


def applies(metric, cell, bench):
    """Whether ``cell`` reports ``metric``: the cells its ``workloads``
    list, else every cell (an end-to-end metric) or every cell that
    reports the end-to-end metric it moves (a per-layer metric)."""
    if "workloads" in metric:
        return cell["name"] in metric["workloads"]
    if "moves" not in metric:
        return True
    moved = next(m for m in bench["end_to_end"] if m["name"] == metric["moves"])
    return applies(moved, cell, bench)


class Context:
    """What a traffic driver gets: the cell's configuration, mix, limits
    and arguments, the device, the spans, and the window to run under."""

    def __init__(self, bench, cell, seed, seconds, trace, device, root=HERE):
        from portbench import devtrace
        self.bench, self.cell = bench, cell
        self.cfg = read_json(os.path.join(root, "configs",
                                          f"{cell['config']}.json"))
        self.traffic = read_json(os.path.join(root, "traffic",
                                              f"{cell['traffic']}.json"))
        self.limits = read_json(os.path.join(root, "limits",
                                             f"{cell['name']}.json"))
        self.seed, self.seconds, self.trace = int(seed), float(seconds), \
            bool(trace)
        self.device = device
        self.spans = devtrace.Spans(traced=self.trace)
        self.window_start = None
        self.trace_summary = None
        self.setup_parts = []
        self._last = time.time()

    def mark(self, part):
        """Close the set-up part ``part`` (host seconds since the last)."""
        now = time.time()
        self.setup_parts.append([part, now - self._last])
        self._last = now

    @contextlib.contextmanager
    def window(self):
        from portbench import devtrace
        self.window_start = time.time()
        with devtrace.TraceWindow(self.trace) as tw:
            yield tw
        self.trace_summary = tw.summary

    def memory_peak(self):
        import torch
        if self.device.type != "cuda":
            return 0
        return int(torch.cuda.max_memory_allocated(self.device))


def run_cell(bench, cell, seed, seconds, trace, device, root=HERE):
    """Run one cell on ``device``: (result dict, record)."""
    ctx = Context(bench, cell, seed, seconds, trace, device, root)
    ctx.setup_parts.append(["process start to cell", ctx._last - T_PROCESS])
    driver = load_file("traffic", ctx.traffic["driver"], root)
    rec = driver.run(ctx)
    rec["setup_s"] = ctx.window_start - T_PROCESS
    rec["setup_parts"] = ctx.setup_parts
    rec["spans"] = ctx.spans.times
    rec["trace"] = ctx.trace_summary
    rec["peaks"] = peaks_of(device)
    metrics = {}
    group = bench["per_layer"] if trace else bench["end_to_end"]
    for m in group:
        if not applies(m, cell, bench):
            continue
        reader = load_file("metrics", m["name"], root)
        value = reader.read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    checks = rec["checks"]
    correct = bool(checks) and all(c["passed"] for c in checks)
    out = {"correct": correct, "attempted": int(rec["units"]),
           "failed": sum(not c["passed"] for c in checks),
           "metrics": metrics, "device": device_info(device, cell, rec)}
    if trace and rec["trace"] is not None:
        from portbench import devtrace
        out["breakdown"] = {"device_ops": devtrace.top_kernels(rec["trace"]),
                            "idle_gaps": rec["trace"]["idle_gaps"]}
    out["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                     for c in checks}
    return out, rec


def peaks_of(device):
    """The card's row of ``peaks.json`` (matched by a part of its name),
    or None."""
    if device.type != "cuda":
        return None
    import torch
    kind = torch.cuda.get_device_name(device)
    for key, row in read_json(os.path.join(HERE, "peaks.json")).items():
        if key in kind:
            return row
    return None


def device_info(device, cell, rec):
    import torch
    info = {"platform": "gpu" if device.type == "cuda" else device.type,
            "kind": (torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu"),
            "count": int(cell["chips"]),
            "memory_peak_bytes": int(rec["memory_peak_bytes"])}
    if rec["trace"] is not None:
        info["busy_s"] = rec["trace"]["busy_s"]
        info["window_s"] = rec["trace"]["window_s"]
    if device.type == "cuda":
        try:
            info["power_limit_w"] = float(subprocess.run(
                ["nvidia-smi", "--query-gpu=power.limit",
                 "--format=csv,noheader,nounits", "-i", "0"],
                capture_output=True, text=True, timeout=20).stdout.split()[0])
        except (OSError, ValueError, IndexError,
                subprocess.TimeoutExpired):
            pass
    return info


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = read_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = next((w for w in bench["workloads"] if w["name"] == args.workload),
                None)
    if cell is None:
        print(f"portbench: no workload {args.workload!r}", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < int(cell["chips"]):
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA "
              "device(s)", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    out, rec = run_cell(bench, cell, args.seed, args.seconds, args.trace,
                        device)
    found = forbidden_modules()
    if found:
        print(f"portbench: loaded in this process: {', '.join(found)}",
              file=sys.stderr)
        return 3
    if rec["trace"] is not None:
        print("portbench: idle by span " + json.dumps(
            rec["trace"]["idle_by_span"]), file=sys.stderr)
    print("portbench: set-up parts (s) " + json.dumps(rec["setup_parts"]),
          file=sys.stderr)
    for name, t in rec["spans"].items():
        print(f"portbench: span {name} n {len(t)} mean {sum(t) / len(t)!r} "
              f"min {min(t)!r} max {max(t)!r}", file=sys.stderr)
    if "step_keys" in rec:
        print(f"portbench: pool {rec['pool_rays']} rays; window steps by "
              "key " + json.dumps(rec["step_keys"]), file=sys.stderr)
    if rec.get("segments_s"):
        print("portbench: seconds from the window's start to each renewal "
              "and between renewals " + json.dumps(rec["segments_s"]),
              file=sys.stderr)
    print(f"portbench: reference {rec['reference_s']!r} s", file=sys.stderr)
    print("portbench: numbers " + json.dumps(rec["numbers"]),
          file=sys.stderr)
    for c in rec["checks"]:
        print(f"check {c['name']} {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['passed'] else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
