"""The plain reference against the port's CPU path at tiny sizes, the
control (the reference in bfloat16 put in the program's place) and the
faults planted under a whole run, each of which has to come out not
correct under the cell's limits."""

import json
import os

import numpy as np
import pytest
import torch

import tiny
from portbench import calibrate, inputs
from portbench import run as prun

TRAIN = ["lego_train_top", "fern_train_dense_tv", "fern_train_sparse_tv"]
# The port's CPU path (the kernels' plain versions, bf16 slabs and MLP)
# against the float32 reference at the tiny sizes: a few bf16 roundings.
TINY_BARS = {"loss_gap": 2e-2, "grad_gap": 2e-2, "change_gap": 2e-2,
             "grad_diff": 5e-2, "pool_gap": 1e-5}


@pytest.mark.parametrize("cell", TRAIN)
def test_tiny_cell_matches_the_reference(cell, tmp_path):
    out, rec = tiny.run_tiny(str(tmp_path), cell)
    assert out["correct"], out["checks"]
    for name, value in rec["numbers"].items():
        assert value <= TINY_BARS[name], (name, value)
    assert out["attempted"] >= 1 and out["failed"] == 0


def cell_context(root, cell):
    cfg = prun.read_json(os.path.join(root, "configs",
                                      f"{tiny.CELLS[cell][0]}.json"))
    data = inputs.fixture(cfg)
    return {"cfg": cfg, "data": data, "geo": inputs.geometry(cfg, data)}


@pytest.mark.parametrize("cell", TRAIN)
def test_control_comes_out_not_correct(cell, tmp_path):
    out, rec = tiny.run_tiny(str(tmp_path), cell)
    ctx = cell_context(str(tmp_path), cell)
    limits = prun.read_json(os.path.join(prun.HERE, "limits",
                                         f"{cell}.json"))
    got = calibrate.train_readings(rec, ctx)["control"]
    assert any(v > limits[k] for k, v in got.items() if k in limits), got


def run_with(monkeypatch, tmp_path, cell, fault):
    if fault == "unchanged":
        from directvoxgo_tpu_torch.optim import masked_adam
        monkeypatch.setattr(masked_adam.MaskedAdam, "step",
                            lambda self, grads, regions=None: None)
    elif fault == "half_batch":
        from directvoxgo_tpu_torch.engine import train as train_lib
        make = train_lib.make_train_step

        def half(*a, **k):
            step = make(*a, **k)
            return lambda pool, sel, off, v_base=None: step(
                pool, sel[: sel.shape[0] // 2], off, v_base)
        monkeypatch.setattr(train_lib, "make_train_step", half)
    out, _ = tiny.run_tiny(str(tmp_path), cell)
    return out


@pytest.mark.parametrize("cell", TRAIN)
@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_train_faults_come_out_not_correct(cell, fault, monkeypatch,
                                           tmp_path):
    out = run_with(monkeypatch, tmp_path, cell, fault)
    assert not out["correct"], out["checks"]


@pytest.mark.card
def test_cells_on_the_card():
    """Each cell once, short, on the card: a result line, correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import subprocess
    import sys
    bench = prun.read_json(os.path.join(prun.ROOT, "BENCHMARK.json"))
    for w in bench["workloads"]:
        out = subprocess.run(
            [sys.executable, "portbench/run.py", "--workload", w["name"],
             "--seed", "2147483653", "--seconds", "2", "--trace", "0"],
            capture_output=True, text=True, timeout=1200, cwd=prun.ROOT)
        assert out.returncode == 0, out.stderr[-2000:]
        res = json.loads(out.stdout.strip().splitlines()[-1])
        assert res["correct"] and res["device"]["platform"] == "gpu", res
        assert np.isfinite(res["metrics"]["setup_s"]["value"])
