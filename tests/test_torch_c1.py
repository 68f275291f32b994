"""C1: the port's test PSNR against the JAX package's, trained on the CPU
from the same seeds (opt-in; skipped unless ``DVGO_C1`` is set).

    DVGO_C1=tiny JAX_PLATFORMS=cpu python -m pytest tests/test_torch_c1.py -s
    DVGO_C1=fern ...   (the cut fern schedule, ~25 min a JAX run)
    DVGO_C1=all  ...

The cuts, seeds and bars are ``chip_smoke.py``'s (``TINY_CUT``,
``FERN_CUT``, ``C1_SEEDS``, ``C1_BAR_DB``, ``C1_PART_DB``), whose phase 14
trains the same cuts on the card and holds them to the rows this test
writes into ``tests/data/c1/cpu_runs.json`` (``chip_smoke.C1_REF``). The
port's run is ``chip_smoke.c1_run`` on the CPU, the card's on the card.

The JAX engine builds its window buckets in a background thread
(``segment-sort``) and compiles its step programs in a background pool
(``step-compile``). Until a bucket lands it draws without windows, and
until an axis's program lands it draws from the axes whose programs did:
how long that lasts depends on the machine, not on the seed. Here both are
joined, without editing the JAX package: the thread is joined as it
starts, and the pool runs each job as it is submitted. The engines then
draw by the same rules, which the port copies, and both start from the
same initial weights (the port draws them from its copy of the JAX random
stream, ``models/prng.py``), so their seed means must agree within
``BAR_DB``. Each case prints, per seed, both engines' test PSNR, their
train loss and PSNR per 100 steps and their draws per step key (axis,
clip or window box), and writes both rows into the reference file (under
a lock: one seed per process lets the seeds run side by side).
``DVGO_C1_SEEDS`` picks the seeds (default 777, 1, 2); ``DVGO_C1_SIDES``
the engines (default ``port,jax``; ``port`` reruns the port's rows and
keeps the JAX rows the file holds).
"""

import collections
import concurrent.futures as cf
import contextlib
import fcntl
import json
import os
import random
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch

import chip_smoke

REPO = chip_smoke.REPO
SEEDS = chip_smoke.C1_SEEDS
BAR_DB = chip_smoke.C1_BAR_DB
PART_DB = chip_smoke.C1_PART_DB
TINY_CUT = chip_smoke.TINY_CUT
FERN_CUT = chip_smoke.FERN_CUT


def _seeds():
    """The seeds of a run: ``DVGO_C1_SEEDS`` (a comma list), else
    ``SEEDS``; one seed per process lets the seeds run side by side."""
    v = os.environ.get("DVGO_C1_SEEDS", "")
    return tuple(int(x) for x in v.split(",")) if v else SEEDS


def _sides():
    return os.environ.get("DVGO_C1_SIDES", "port,jax").split(",")


def _wanted(case):
    v = os.environ.get("DVGO_C1", "")
    return v == "all" or case in v.split(",")


@contextlib.contextmanager
def jax_background_joined():
    """The JAX engine's ``segment-sort`` thread joined as it starts, and
    its ``step-compile`` pool running each job as it is submitted."""
    real_thread, real_pool = threading.Thread, cf.ThreadPoolExecutor

    class Joined(real_thread):
        def start(self):
            super().start()
            if self.name == "segment-sort":
                self.join()

    class Inline(cf.Executor):
        def submit(self, fn, /, *args, **kwargs):
            fut = cf.Future()
            try:
                fut.set_result(fn(*args, **kwargs))
            except BaseException as e:  # noqa: BLE001 - kept in the future
                fut.set_exception(e)
            return fut

    def pool(*args, **kwargs):
        if kwargs.get("thread_name_prefix") == "step-compile":
            return Inline()
        return real_pool(*args, **kwargs)

    threading.Thread, cf.ThreadPoolExecutor = Joined, pool
    try:
        yield
    finally:
        threading.Thread, cf.ThreadPoolExecutor = real_thread, real_pool


class _CountedStep:
    """A JAX step function (or its AOT-compiled form) that counts the
    steps each call takes under its key."""

    def __init__(self, fn, key, n_steps, counts):
        self.fn, self.key, self.n, self.counts = fn, key, n_steps, counts

    def __call__(self, *args, **kwargs):
        self.counts[self.key] += self.n
        return self.fn(*args, **kwargs)

    def lower(self, *args, **kwargs):
        low = self.fn.lower(*args, **kwargs)
        return types.SimpleNamespace(compile=lambda: _CountedStep(
            low.compile(), self.key, self.n, self.counts))

    def __getattr__(self, name):
        return getattr(self.fn, name)


def _args(seed):
    return types.SimpleNamespace(seed=seed, no_reload=True,
                                 no_reload_optimizer=False, ft_path="",
                                 i_print=chip_smoke.C1_I_PRINT,
                                 i_weights=10 ** 9)


def jax_run(case, basedir, seed):
    """The JAX package trained from ``seed`` with its background work
    joined, its test views rendered; its row as ``chip_smoke.c1_run``'s
    (test PSNR, train lines, steps per step key, ``in_maskcache`` pools,
    seconds)."""
    from directvoxgo_tpu.config import Config
    from directvoxgo_tpu.data import load_everything
    from directvoxgo_tpu.engine import checkpoint as ckpt_lib
    from directvoxgo_tpu.engine import train as train_lib
    from directvoxgo_tpu.engine.render import render_viewpoints
    path, cut, _ = chip_smoke.C1_CASES[case]
    cfg = Config.fromfile(os.path.join(REPO, path))
    for k, v in dict(cut, basedir=str(basedir)).items():
        chip_smoke.c1_set(cfg, k, v)
    np.random.seed(seed)
    random.seed(seed)
    data = load_everything(args=_args(seed), cfg=cfg)
    counts, pools = collections.Counter(), []
    real, real_rays = train_lib.make_train_step, train_lib.gather_training_rays

    def counted(*args, axis=None, clip_sizes=None, n_steps=1, **kwargs):
        fn = real(*args, axis=axis, clip_sizes=clip_sizes, n_steps=n_steps,
                  **kwargs)
        return _CountedStep(fn, chip_smoke.c1_key((axis, clip_sizes)),
                            n_steps, counts)

    def pooled(model, cfg_, cfg_train, *a, **k):
        out = real_rays(model, cfg_, cfg_train, *a, **k)
        if cfg_train.ray_sampler == "in_maskcache":
            pools.append(int(len(out[0])))
        return out

    tee = chip_smoke.TrainLines(sys.stdout)
    t0 = time.time()
    train_lib.make_train_step = counted
    train_lib.gather_training_rays = pooled
    try:
        with jax_background_joined(), contextlib.redirect_stdout(tee):
            train_lib.train(_args(seed), cfg, data)
    finally:
        train_lib.make_train_step = real
        train_lib.gather_training_rays = real_rays
    seconds = time.time() - t0
    ckpt_lib.wait_for_pending_saves()
    model = ckpt_lib.load_model(
        train_lib._model_class_for(cfg),
        os.path.join(cfg.basedir, cfg.expname, "fine_last.tar"))
    t0 = time.time()
    _, _, stats = render_viewpoints(model=model,
                                    **chip_smoke.c1_views(cfg, data))
    return {"psnr": float(np.mean(stats["psnr"])),
            "view_psnrs": [float(p) for p in stats["psnr"]],
            "train": tee.rows, "draws": dict(sorted(counts.items())),
            "pool": pools, "seconds": seconds,
            "render_seconds": time.time() - t0}


def port_run(case, basedir, seed):
    """The port trained from ``seed`` on the CPU (``chip_smoke.c1_run``),
    with the torch threads it ran on."""
    row = chip_smoke.c1_run(case, basedir, seed, "cpu")
    row["torch_threads"] = torch.get_num_threads()
    return row


def _means(entry):
    """The seed means of a case's rows in the reference file."""
    return {f"{side}_mean": (chip_smoke.c1_mean(list(entry[side].values()))
                             if entry[side] else None)
            for side in ("port", "jax")}


def record(case, seed, rows):
    """Write ``rows`` ({side: row}) of ``case`` at ``seed`` into
    ``chip_smoke.C1_REF`` under a lock, the case's config, cut and seed
    means with them; returns the case's entry as written."""
    os.makedirs(os.path.dirname(chip_smoke.C1_REF), exist_ok=True)
    with open(chip_smoke.C1_REF + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        ref = {"cases": {}}
        if os.path.exists(chip_smoke.C1_REF):
            with open(chip_smoke.C1_REF) as f:
                ref = json.load(f)
        path, cut, _ = chip_smoke.C1_CASES[case]
        entry = ref["cases"].setdefault(case, {"port": {}, "jax": {}})
        entry.update(config=path, overrides=cut,
                     i_print=chip_smoke.C1_I_PRINT)
        for side, row in rows.items():
            entry[side][str(seed)] = row
        entry.update(_means(entry))
        ref["about"] = ("C1 on the CPU: the port's and the JAX package's "
                        "runs of each case's cut, per seed; written by "
                        "tests/test_torch_c1.py, read by chip_smoke.py's "
                        "phase 14")
        tmp = chip_smoke.C1_REF + ".tmp"
        with open(tmp, "w") as f:
            json.dump(ref, f, indent=1, sort_keys=True)
            f.write("\n")
        os.replace(tmp, chip_smoke.C1_REF)
    return entry


def shares(counts):
    tot = max(sum(counts.values()), 1)
    return {k: v / tot for k, v in sorted(counts.items(),
                                          key=lambda kv: -kv[1])}


def compare(case, tmp_path):
    """Each engine of ``DVGO_C1_SIDES`` from each seed; prints and records
    the rows, returns (port mean, JAX mean, {seed: (port row, JAX row)})
    over the seeds run (a side not run: the file's row)."""
    pairs = {}
    for seed in _seeds():
        rows = {}
        if "port" in _sides():
            rows["port"] = port_run(case, tmp_path / f"port_{seed}", seed)
        if "jax" in _sides():
            rows["jax"] = jax_run(case, tmp_path / f"jax_{seed}", seed)
        entry = record(case, seed, rows)
        p, j = entry["port"].get(str(seed)), entry["jax"].get(str(seed))
        pairs[seed] = (p, j)
        if p is None or j is None:
            continue
        keys = set(p["draws"]) | set(j["draws"])
        ps, js = shares(p["draws"]), shares(j["draws"])
        tv = 0.5 * sum(abs(ps.get(k, 0.0) - js.get(k, 0.0)) for k in keys)
        train = "\n".join(
            f"  {a[0]} {a[1]:6d}: loss {a[2]:.9f} / {b[2]:.9f}, train PSNR "
            f"{a[3]:5.2f} / {b[3]:5.2f}"
            for a, b in zip(p["train"], j["train"]))
        print(f"C1 {case} seed {seed}: port {p['psnr']:.4f} dB "
              f"({p['seconds']:.0f} s), JAX {j['psnr']:.4f} dB "
              f"({j['seconds']:.0f} s), draws apart by {tv:.4f} (total "
              f"variation); pools {p['pool']} / {j['pool']}; per 100 "
              f"steps, port / JAX:\n{train}\n  train PSNRs first part at "
              f"{chip_smoke.c1_first_parting(p['train'], j['train'])}\n"
              f"  port {ps}\n  JAX  {js}", flush=True)
    both = [v for v in pairs.values() if None not in v]
    port = chip_smoke.c1_mean([p for p, _ in both]) if both else None
    jax_ = chip_smoke.c1_mean([j for _, j in both]) if both else None
    if both:
        print(f"C1 {case}: seed means port {port:.4f} dB, JAX {jax_:.4f} "
              f"dB, difference {port - jax_:+.4f} (bar {BAR_DB})",
              flush=True)
    return port, jax_, pairs


def test_c1_tiny_fixture_seed_means_agree(tmp_path):
    """C1 step 3: the JAX package's own end-to-end configuration
    (``tests/test_train_e2e.py``), both engines from seeds 777, 1 and 2:
    the seed means within ``BAR_DB``."""
    if not _wanted("tiny"):
        pytest.skip("opt-in: set DVGO_C1=tiny (or all)")
    port, jax_, pairs = compare("tiny", tmp_path)
    assert all(np.isfinite(p["psnr"]) for p, _ in pairs.values())
    assert port is None or abs(port - jax_) <= BAR_DB, (port, jax_)


def test_c1_fern_cut_schedule_seed_means_agree(tmp_path):
    """C1 step 2: fern (``configs/synthetic/fixture_ndc_fern.py``) on the
    cut schedule ``FERN_CUT``, window draws engaged from the first pg
    event, both engines from seeds 777, 1 and 2: the seed means within
    ``BAR_DB``."""
    if not _wanted("fern"):
        pytest.skip("opt-in: set DVGO_C1=fern (or all)")
    port, jax_, pairs = compare("fern", tmp_path)
    assert all(np.isfinite(p["psnr"]) for p, _ in pairs.values())
    assert port is None or abs(port - jax_) <= BAR_DB, (port, jax_)
