"""The port's fetch watchdog (``engine/fetchguard.py``), its restart
wrapper (``tools/resilient_run.py``) and the numbered-checkpoint resume
they rely on, which checks the checkpoint against the current config.

The watchdog is opt-in: without ``DVGO_FETCH_WATCHDOG`` no guard starts a
thread. Armed, a guard overdue at a scan ends the process with exit 17; a
pull that left its guard after its deadline but before the scan does not
(the lock is taken again right before the exit). The wrapper relaunches a
run that exits 17 once the probe finds the card answering.
"""

import os
import subprocess
import sys
import textwrap
import threading
import types

import numpy as np
import pytest
import torch

from directvoxgo_tpu_torch.config import Config
from directvoxgo_tpu_torch.engine import checkpoint as ckpt_lib
from directvoxgo_tpu_torch.engine import fetchguard
from directvoxgo_tpu_torch.engine import train as train_lib
from directvoxgo_tpu_torch.models.dvgo import DirectVoxGO
from directvoxgo_tpu_torch.tools import resilient_run

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "configs", "synthetic", "fixture_tiny.py")


def _child(code, watchdog, timeout=60):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               DVGO_FETCH_WATCHDOG=str(watchdog))
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          env=env, cwd=REPO, capture_output=True, text=True,
                          timeout=timeout)


def test_unarmed_guards_start_no_thread(monkeypatch):
    monkeypatch.delenv("DVGO_FETCH_WATCHDOG", raising=False)
    assert fetchguard.timeout_default() == 0.0
    with fetchguard.guarded("loss") as g:
        pulled = fetchguard.guarded_get(
            {"a": torch.ones(2), "b": [torch.zeros(1), 3]}, "tree")
    assert g.key is None and not fetchguard._state["active"]
    assert fetchguard._state["thread"] is None
    assert not any(t.name == "fetchguard" for t in threading.enumerate())
    assert torch.equal(pulled["a"], torch.ones(2)) and pulled["b"][1] == 3


def test_overdue_guard_exits_17():
    proc = _child("""
        import time
        from directvoxgo_tpu_torch.engine import fetchguard
        fetchguard.set_abort_callback(lambda label: print("abort", label))
        with fetchguard.guarded("wedged pull"):
            time.sleep(30)
        print("not reached")
        """, watchdog=0.5)
    assert proc.returncode == fetchguard.EXIT_WEDGED, proc.stderr
    assert "abort wedged pull" in proc.stdout
    assert "not reached" not in proc.stdout
    assert "'wedged pull' stuck" in proc.stderr


def test_guard_left_late_but_before_the_scan_does_not_kill():
    """Over its deadline when it leaves the guard, yet gone by the next
    scan: the process lives on."""
    proc = _child("""
        import time
        from directvoxgo_tpu_torch.engine import fetchguard
        with fetchguard.guarded("slow pull", timeout=0.2):
            time.sleep(0.6)
        with fetchguard.guarded("quick pull"):
            pass
        time.sleep(fetchguard.SCAN_S + 1.0)   # past the first scan
        print("alive")
        """, watchdog=5)
    assert proc.returncode == 0, proc.stderr
    assert "alive" in proc.stdout


def test_scan_rechecks_under_the_lock(monkeypatch):
    """The exit race: a pull found overdue that leaves its guard before
    the scan takes the lock again is not killed."""
    exits = []
    monkeypatch.setattr(fetchguard.os, "_exit", exits.append)
    real = fetchguard._overdue

    def found_then_left(now):
        hit = real(now)
        if hit is not None:
            fetchguard._state["active"].pop(hit[0], None)
        return hit

    monkeypatch.setattr(fetchguard, "_overdue", found_then_left)
    with fetchguard._state["lock"]:
        fetchguard._state["active"][-1] = (0.0, 1.0, "left late")
    fetchguard._scan_once()
    assert exits == [] and -1 not in fetchguard._state["active"]
    monkeypatch.setattr(fetchguard, "_overdue", real)
    with fetchguard._state["lock"]:
        fetchguard._state["active"][-2] = (0.0, 1.0, "still stuck")
    try:
        fetchguard._scan_once()
    finally:
        fetchguard._state["active"].pop(-2, None)
    assert exits == [fetchguard.EXIT_WEDGED]


def test_resilient_run_relaunches_after_exit_17(tmp_path, monkeypatch):
    counter = tmp_path / "attempts"
    script = tmp_path / "run.py"
    script.write_text(textwrap.dedent(f"""
        import os, sys
        p = {str(counter)!r}
        n = int(open(p).read()) if os.path.exists(p) else 0
        open(p, "w").write(str(n + 1))
        assert os.environ["DVGO_FETCH_WATCHDOG"] == "30.0"
        sys.exit(17 if n == 0 else 0)
        """))
    probes = []
    monkeypatch.setattr(resilient_run, "probe_device",
                        lambda wd: probes.append(wd) or 0)
    monkeypatch.setattr(resilient_run, "PROBE_EVERY_S", 0.0)
    rc = resilient_run.main(["--watchdog", "30", "--", "--config", "x.py"],
                            command=[sys.executable, str(script)])
    assert rc == 0 and counter.read_text() == "2" and probes == [30.0]
    # a failure that is not a wedge is not retried
    script.write_text("import sys; sys.exit(3)")
    assert resilient_run.main(["--", "a"], command=[
        sys.executable, str(script)]) == 3


# ------------------------------------------------------------ resume

def _stage(tmp_path, **fine):
    cfg = Config.fromfile(TINY)
    cfg.basedir, cfg.expname = str(tmp_path), "resume"
    cfg.fine_model_and_render.update(fine)
    return cfg


def _numbered(cfg, width):
    """A fine checkpoint at step 50 of a model whose MLP is ``width``
    wide, as an interrupted run leaves it."""
    logdir = os.path.join(cfg.basedir, cfg.expname)
    os.makedirs(logdir, exist_ok=True)
    kw = dict(cfg.fine_model_and_render, rgbnet_width=width)
    kw.pop("num_voxels")
    model = DirectVoxGO(xyz_min=[-1, -1, -1], xyz_max=[1, 1, 1],
                        num_voxels=16 ** 3, device="cpu", **kw)
    path = os.path.join(logdir, "fine_000050.tar")
    ckpt_lib.save_model_checkpoint(path, model, 50)
    return path


def test_numbered_checkpoint_of_another_model_is_refused(tmp_path,
                                                         capsys):
    cfg = _stage(tmp_path)
    path = _numbered(cfg, cfg.fine_model_and_render.rgbnet_width // 2)
    data = {"near": 2.0, "far": 6.0, "poses": np.zeros((1, 3, 4)),
            "i_train": np.zeros(1, int)}
    args = types.SimpleNamespace(no_reload=False, ft_path="", seed=0)
    with pytest.raises(ValueError) as e:
        train_lib.scene_rep_reconstruction(
            args, cfg, cfg.fine_model_and_render, cfg.fine_train,
            np.full(3, -1.0), np.ones(3), data, "fine", device="cpu")
    msg = str(e.value)
    assert path in msg and "rgbnet_width" in msg and "--no_reload" in msg
    assert f"resume: numbered checkpoint {path}" in capsys.readouterr().out


def test_matching_numbered_checkpoint_resumes(tmp_path, capsys):
    cfg = _stage(tmp_path)
    path = _numbered(cfg, cfg.fine_model_and_render.rgbnet_width)
    ckpt_lib.check_numbered_resume(path, cfg.fine_model_and_render)
    assert f"resume: numbered checkpoint {path}" in capsys.readouterr().out
    st = ckpt_lib.load_checkpoint_file(path)
    assert ckpt_lib.resume_mismatches(st["model_kwargs"],
                                      cfg.fine_model_and_render) == {}
    other = dict(cfg.fine_model_and_render, rgbnet_dim=3, num_voxels=7,
                 xyz_min=[0, 0, 0])
    assert set(ckpt_lib.resume_mismatches(st["model_kwargs"], other)) \
        == {"rgbnet_dim"}
