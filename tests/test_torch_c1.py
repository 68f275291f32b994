"""C1: the port's test PSNR against the JAX package's, trained on the CPU
from the same seeds (opt-in; skipped unless ``DVGO_C1`` is set).

    DVGO_C1=tiny JAX_PLATFORMS=cpu python -m pytest tests/test_torch_c1.py -s
    DVGO_C1=fern ...   (the cut fern schedule, ~25 min a JAX run)
    DVGO_C1=all  ...

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
clip or window box), and writes them to ``logs/c1/<case>_<seeds>.json``.
``DVGO_C1_SEEDS`` picks the seeds (default 777, 1, 2).
"""

import collections
import concurrent.futures as cf
import contextlib
import json
import os
import random
import re
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEEDS = (777, 1, 2)
BAR_DB = 0.2
# the engines' train PSNRs (printed to 0.01 dB, the mean of the i_print
# window's steps) are said to part at the first i_print step where they
# differ by more than this; the one batch's loss printed beside them drifts
# by up to a few percent within 100 steps from float orders alone
PART_DB = 0.05
FERN_CFG = os.path.join(REPO, "configs", "synthetic", "fixture_ndc_fern.py")
# The fern schedule cut to 25 minutes of JAX on an 8-core CPU (29 on four
# cores): the grid's final size cut from 256^3 to 160^3 voxels
# (352x371x128 planes to 174x183x128), the iterations from 25000 to
# FERN_ITERS, and two pg_scale events of four, at the same share of the
# schedule (2000/25000 and 4000/25000 of it), the dense-TV span scaled
# with them (10000/25000).
# Windows engage past 1.1 M voxels: from the first pg event (2.05 M
# voxels) on.
FERN_ITERS = 600
FERN_CUT = {"fine_train.N_iters": FERN_ITERS,
            "fine_train.pg_scale": [48, 96],
            "fine_train.tv_dense_before": 240,
            "fine_model_and_render.num_voxels": 160 ** 3}


def _seeds():
    """The seeds of a run: ``DVGO_C1_SEEDS`` (a comma list), else
    ``SEEDS``; one seed per process lets the seeds run side by side."""
    v = os.environ.get("DVGO_C1_SEEDS", "")
    return tuple(int(x) for x in v.split(",")) if v else SEEDS


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


TRAIN_LINE = re.compile(r"scene_rep_reconstruction \((\w+)\): iter\s+(\d+) "
                        r"/ Loss: ([-+.\deE]+) / PSNR:\s*([-+.\deE]+)")


class _TrainLines:
    """A stdout that passes everything on and keeps each engine's
    ``i_print`` line as (stage, step, loss, train PSNR)."""

    def __init__(self, out):
        self.out, self.rows, self.buf = out, [], ""

    def write(self, text):
        self.buf += text
        *lines, self.buf = self.buf.split("\n")
        for line in lines:
            m = TRAIN_LINE.search(line)
            if m:
                self.rows.append((m[1], int(m[2]), float(m[3]),
                                  float(m[4])))
        return self.out.write(text)

    def flush(self):
        self.out.flush()


@contextlib.contextmanager
def train_lines():
    tee = _TrainLines(sys.stdout)
    with contextlib.redirect_stdout(tee):
        yield tee.rows


def _plain(x):
    """A step key's parts as plain Python values (numpy ints to int)."""
    if isinstance(x, (tuple, list)):
        return tuple(_plain(v) for v in x)
    if isinstance(x, (np.integer,)):
        return int(x)
    return x


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


def _set(cfg, dotted, value):
    *path, last = dotted.split(".")
    node = cfg
    for p in path:
        node = getattr(node, p)
    setattr(node, last, value)


def _args(seed):
    return types.SimpleNamespace(seed=seed, no_reload=True,
                                 no_reload_optimizer=False, ft_path="",
                                 i_print=100, i_weights=10 ** 9)


def _render_kw(cfg, data):
    return dict(ndc=cfg.data.ndc, render_kwargs={
        "near": data["near"], "far": data["far"],
        "bg": 1 if cfg.data.white_bkgd else 0,
        "stepsize": cfg.fine_model_and_render.stepsize,
        "inverse_y": cfg.data.inverse_y, "flip_x": cfg.data.flip_x,
        "flip_y": cfg.data.flip_y, "render_depth": True},
        flip_x=cfg.data.flip_x, flip_y=cfg.data.flip_y)


def _views(data):
    i = data["i_test"]
    return dict(render_poses=data["poses"][i], HW=data["HW"][i],
                Ks=data["Ks"][i],
                gt_imgs=[np.asarray(data["images"][j]) for j in i])


def jax_run(cfg_path, overrides, basedir, seed):
    """The JAX package trained from ``seed`` with its background work
    joined; returns (test PSNR, {step key: steps}, seconds, train lines)."""
    from directvoxgo_tpu.config import Config
    from directvoxgo_tpu.data import load_everything
    from directvoxgo_tpu.engine import checkpoint as ckpt_lib
    from directvoxgo_tpu.engine import train as train_lib
    from directvoxgo_tpu.engine.render import render_viewpoints
    cfg = Config.fromfile(cfg_path)
    for k, v in dict(overrides, basedir=str(basedir)).items():
        _set(cfg, k, v)
    np.random.seed(seed)
    random.seed(seed)
    data = load_everything(args=_args(seed), cfg=cfg)
    counts = collections.Counter()
    real = train_lib.make_train_step

    def counted(*args, axis=None, clip_sizes=None, n_steps=1, **kwargs):
        fn = real(*args, axis=axis, clip_sizes=clip_sizes, n_steps=n_steps,
                  **kwargs)
        return _CountedStep(fn, _plain((axis, clip_sizes)), n_steps, counts)

    t0 = time.time()
    train_lib.make_train_step = counted
    try:
        with jax_background_joined(), train_lines() as rows:
            train_lib.train(_args(seed), cfg, data)
    finally:
        train_lib.make_train_step = real
    seconds = time.time() - t0
    ckpt_lib.wait_for_pending_saves()
    model = ckpt_lib.load_model(
        train_lib._model_class_for(cfg),
        os.path.join(cfg.basedir, cfg.expname, "fine_last.tar"))
    _, _, stats = render_viewpoints(model=model, verbose=False,
                                    **_views(data), **_render_kw(cfg, data))
    return float(np.mean(stats["psnr"])), dict(counts), seconds, rows


def port_run(cfg_path, overrides, basedir, seed):
    """The port trained from ``seed`` on the CPU; as :func:`jax_run`."""
    from directvoxgo_tpu_torch.config import Config
    from directvoxgo_tpu_torch.data import load_everything
    from directvoxgo_tpu_torch.engine import checkpoint as ckpt_lib
    from directvoxgo_tpu_torch.engine import graphs
    from directvoxgo_tpu_torch.engine import train as train_lib
    from directvoxgo_tpu_torch.engine.render import render_viewpoints
    cfg = Config.fromfile(cfg_path)
    for k, v in dict(overrides, basedir=str(basedir)).items():
        _set(cfg, k, v)
    np.random.seed(seed)
    random.seed(seed)
    torch.manual_seed(seed)
    data = load_everything(args=_args(seed), cfg=cfg)
    counts = collections.Counter()
    real = graphs.StepGraphs.run

    def counted(self, key, fn, pool, sels, offs, **kwargs):
        counts[_plain(key)] += len(sels)
        return real(self, key, fn, pool, sels, offs, **kwargs)

    t0 = time.time()
    graphs.StepGraphs.run = counted
    try:
        with train_lines() as rows:
            train_lib.train(_args(seed), cfg, data, device="cpu")
    finally:
        graphs.StepGraphs.run = real
    seconds = time.time() - t0
    model = ckpt_lib.load_model(
        train_lib.model_class_for(cfg),
        os.path.join(cfg.basedir, cfg.expname, "fine_last.tar"),
        device="cpu")
    _, _, stats = render_viewpoints(model=model, verbose=False,
                                    **_views(data), **_render_kw(cfg, data))
    return float(np.mean(stats["psnr"])), dict(counts), seconds, rows


def shares(counts):
    tot = max(sum(counts.values()), 1)
    return {str(k): v / tot for k, v in sorted(
        counts.items(), key=lambda kv: -kv[1])}


def first_parting(port_lines, jax_lines):
    """The first ``i_print`` line (stage, step) whose train PSNRs differ
    between the engines by more than ``PART_DB``, or None."""
    for p, j in zip(port_lines, jax_lines):
        if p[:2] != j[:2] or abs(p[3] - j[3]) > PART_DB:
            return p[:2]
    return None


def compare(case, cfg_path, overrides, tmp_path):
    """Both engines from each seed; prints and writes the table, returns
    (port mean, JAX mean, rows)."""
    rows, seeds = [], _seeds()
    for seed in seeds:
        p_psnr, p_counts, p_s, p_lines = port_run(
            cfg_path, overrides, tmp_path / f"port_{seed}", seed)
        j_psnr, j_counts, j_s, j_lines = jax_run(
            cfg_path, overrides, tmp_path / f"jax_{seed}", seed)
        keys = set(map(str, p_counts)) | set(map(str, j_counts))
        ps, js = shares(p_counts), shares(j_counts)
        tv = 0.5 * sum(abs(ps.get(k, 0.0) - js.get(k, 0.0)) for k in keys)
        parting = first_parting(p_lines, j_lines)
        rows.append(dict(seed=seed, port_psnr=p_psnr, jax_psnr=j_psnr,
                         port_s=p_s, jax_s=j_s, port_draws=ps, jax_draws=js,
                         draw_share_distance=tv, port_train=p_lines,
                         jax_train=j_lines, first_parting=parting))
        train = "\n".join(
            f"  {p[0]} {p[1]:6d}: loss {p[2]:.9f} / {j[2]:.9f}, train PSNR "
            f"{p[3]:5.2f} / {j[3]:5.2f}" for p, j in zip(p_lines, j_lines))
        print(f"C1 {case} seed {seed}: port {p_psnr:.4f} dB ({p_s:.0f} s), "
              f"JAX {j_psnr:.4f} dB ({j_s:.0f} s), draws apart by {tv:.4f} "
              f"(total variation); per 100 steps, port / JAX:\n{train}\n"
              f"  train PSNRs first part at {parting}\n  port {ps}\n"
              f"  JAX  {js}", flush=True)
    port = float(np.mean([r["port_psnr"] for r in rows]))
    jax_ = float(np.mean([r["jax_psnr"] for r in rows]))
    out = os.path.join(REPO, "logs", "c1")
    os.makedirs(out, exist_ok=True)
    name = f"{case}_{'_'.join(map(str, seeds))}.json"
    with open(os.path.join(out, name), "w") as f:
        json.dump(dict(case=case, overrides=overrides, port_mean=port,
                       jax_mean=jax_, rows=rows), f, indent=1)
    print(f"C1 {case}: seed means port {port:.4f} dB, JAX {jax_:.4f} dB, "
          f"difference {port - jax_:+.4f} (bar {BAR_DB})", flush=True)
    return port, jax_, rows


TINY_CUT = {"expname": "tiny_e2e", "data.dataset_type": "synthetic_fixture",
            "data.white_bkgd": True, "coarse_train.N_iters": 150,
            "coarse_train.N_rand": 512, "coarse_train.lrate_density": 0.3,
            "fine_train.N_iters": 150, "fine_train.N_rand": 512,
            "fine_train.pg_scale": [75],
            "coarse_model_and_render.num_voxels": 24 ** 3,
            "coarse_model_and_render.num_voxels_base": 24 ** 3,
            "fine_model_and_render.num_voxels": 32 ** 3,
            "fine_model_and_render.num_voxels_base": 32 ** 3,
            "fine_model_and_render.rgbnet_dim": 6,
            "fine_model_and_render.rgbnet_width": 32,
            "fine_model_and_render.k_density": 64,
            "fine_model_and_render.k_color": 32}


def test_c1_tiny_fixture_seed_means_agree(tmp_path):
    """C1 step 3: the JAX package's own end-to-end configuration
    (``tests/test_train_e2e.py``), both engines from seeds 777, 1 and 2:
    the seed means within ``BAR_DB``."""
    if not _wanted("tiny"):
        pytest.skip("opt-in: set DVGO_C1=tiny (or all)")
    port, jax_, rows = compare(
        "tiny", os.path.join(REPO, "configs", "default.py"), TINY_CUT,
        tmp_path)
    assert all(np.isfinite(r["port_psnr"]) for r in rows)
    assert abs(port - jax_) <= BAR_DB, (port, jax_)


def test_c1_fern_cut_schedule_seed_means_agree(tmp_path):
    """C1 step 2: fern (``configs/synthetic/fixture_ndc_fern.py``) on the
    cut schedule ``FERN_CUT``, window draws engaged from the first pg
    event, both engines from seeds 777, 1 and 2: the seed means within
    ``BAR_DB``."""
    if not _wanted("fern"):
        pytest.skip("opt-in: set DVGO_C1=fern (or all)")
    port, jax_, rows = compare("fern", FERN_CFG, FERN_CUT, tmp_path)
    assert all(np.isfinite(r["port_psnr"]) for r in rows)
    assert abs(port - jax_) <= BAR_DB, (port, jax_)
