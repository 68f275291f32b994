"""``chip_smoke.py``'s phase-1 failure report, its fresh-process check and
its K-G small check, on the CPU (the kernels' plain versions stand in for
the kernels; on the card the same code compares the two). A failed check
must say where the worst element is, how many are off, and which side
left the plain version on the CPU."""

import json
import os

import numpy as np
import pytest
import torch

import chip_smoke
from directvoxgo_tpu_torch.ops import _build
from directvoxgo_tpu_torch.ops import sweep_fwd as ka


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)


def _small():
    return chip_smoke.small_sweep_case(torch, torch.device("cpu"))


@pytest.mark.parametrize("bad", [976.0, float("nan")])
def test_check_sweep_reports_the_wrong_side_before_it_raises(
        no_card, monkeypatch, capsys, bad):
    slabs, rays, k = _small()
    plain = ka.sweep_fwd

    def kernel(*args, **kw):
        out = plain(*args, **kw).clone()
        out[3, 2, 100] = bad
        return out

    monkeypatch.setattr(ka, "sweep_fwd", kernel)
    with pytest.raises(AssertionError, match="K-A small: max abs err"):
        chip_smoke.check_sweep(ka, slabs, rays, k, "small")
    err = capsys.readouterr().err
    assert "FAILED K-A small: report" in err
    assert "worst at (3, 2, 100)" in err
    assert "1 of 1892352 elements off" in err
    assert f"not finite: kernel {int(bad != bad)}, plain 0" in err
    assert "plain moved 0;" in err
    assert "first plain output by 0" in err
    assert "inputs changed since before the launch: slabs 0 of" in err


def test_check_sweep_tells_a_write_into_the_plain_inputs(no_card,
                                                         monkeypatch, capsys):
    """A kernel whose output is right but which writes past it into the
    rays that the plain version reads next: the report shows the rays
    changed and the kernel's output equal to the CPU arbiter's."""
    slabs, rays, k = _small()
    plain = ka.sweep_fwd

    def kernel(slabs_, rays_, k_):
        out = plain(slabs_, rays_, k_)
        rays_[1, 7] += 5.0
        return out

    monkeypatch.setattr(ka, "sweep_fwd", kernel)
    with pytest.raises(AssertionError, match="K-A small: max abs err"):
        chip_smoke.check_sweep(ka, slabs, rays, k, "small")
    err = capsys.readouterr().err
    assert "inputs changed since before the launch: slabs 0 of 221760, " \
        "rays 1 of 24576" in err
    assert "first kernel output off it by 0," in err


def test_check_sweep_passes_without_a_report(no_card, capsys):
    slabs, rays, k = _small()
    assert chip_smoke.check_sweep(ka, slabs, rays, k, "small") == 0.0
    assert "FAILED" not in capsys.readouterr().err


def test_mismatch_report_counts_sentinels_and_survives_a_failing_part(
        capsys):
    got = torch.zeros((4, 5))
    got[1, 2] = chip_smoke.SENTINEL
    want = torch.zeros((4, 5))

    def broken():
        raise RuntimeError("no second run here")

    chip_smoke.mismatch_report(torch, "K-X demo", [("out", got, want, 1e-3)],
                               rerun=broken, cpu=lambda: [want])
    err = capsys.readouterr().err
    assert "worst at (1, 2)" in err
    assert "equal to the sentinel -12345.5: kernel 1, plain 0" in err
    assert "second run: report failed: RuntimeError('no second run here')" \
        in err
    assert "first kernel output off it by 12345.5" in err


@pytest.mark.parametrize("poison", [False, True])
def test_fresh_ka_check_on_the_cpu(monkeypatch, capsys, poison):
    monkeypatch.setattr(_build, "build_all", lambda *a, **k: {})
    assert chip_smoke.fresh_ka_check(poison=poison, device="cpu") == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["ok"] and res["err"] == 0.0 and res["poison"] == poison
    assert res["kernel_vs_cpu"] == res["plain_vs_cpu"] == 0.0
    assert abs(res["nonzero_share"] - 0.7459) < 1e-4
    assert res["kernel_sentinels"] == res["plain_sentinels"] == 0
    assert res["inputs_changed"] == "slabs 0 of 221760, rays 0 of 24576"


def test_small_probe_checks_on_the_cpu(no_card):
    assert chip_smoke.small_probe_checks(torch, torch.device("cpu")) == 0.0


# ------------------------------------------------ phase 12 (a)'s gate

DP, PLAINS = chip_smoke.DP_LABEL, chip_smoke.DP_PLAIN_LABELS
LABELS = (PLAINS[0], DP) + PLAINS[1:]


def _records(n=8, dp_off=0, plain_off=None, loss_of=None):
    """Synthetic records of ``n`` steps taken from one state each: every
    run's loss and PSNR equal (``loss_of(step)``: the data-parallel run's
    instead), the data-parallel run ``dp_off(step)`` elements off every
    plain run, the plain runs ``plain_off(step)`` off each other."""
    records = []
    for i in range(n):
        res = {k: [0.01 / (i + 1), 20.0 + i] for k in LABELS}
        if loss_of is not None:
            res[DP] = loss_of(i, res[DP])
        off = []
        for j, a in enumerate(LABELS):
            for b in LABELS[j + 1:]:
                c = (dp_off(i) if callable(dp_off) else dp_off) \
                    if DP in (a, b) else (plain_off(i) if plain_off else 0)
                off.append([a, b, c])
        records.append({"res": res, "off": off})
    return records


def test_dp_gate_passes_one_plain_sized_flip():
    """A rounding flipped by K-C's atomics in the data-parallel run's step
    5 only, of the size the plain runs show among themselves at step 2:
    the step is judged from its own shared state, so the flip is not
    carried on, and it is within the floor."""
    ok, reason = chip_smoke.dp_gate(_records(
        dp_off=lambda i: 37 if i == 5 else 0,
        plain_off=lambda i: 29 if i == 2 else 0))
    assert ok, reason


@pytest.mark.parametrize("fault", ["mean_scaled_by_2", "tensor_unreduced",
                                   "loss_off_at_step_1", "nan_loss"])
def test_dp_gate_fails_a_planted_data_parallel_fault(fault):
    """Faults of the data-parallel step, with the plain runs flipping a
    few dozen elements between them: every gradient's mean scaled by 2
    (most elements off at every step), one parameter tensor (a 4096-entry
    MLP weight) left unreduced, a loss one ulp off at step 1, a NaN."""
    plain_off = lambda i: 29 if i % 3 == 0 else 0  # noqa: E731
    records = {
        "mean_scaled_by_2": _records(dp_off=5_300_000, plain_off=plain_off),
        "tensor_unreduced": _records(dp_off=4096, plain_off=plain_off),
        "loss_off_at_step_1": _records(
            plain_off=plain_off, loss_of=lambda i, r: [
                float(np.nextafter(np.float32(r[0]), np.float32(1)))
                if i == 1 else r[0], r[1]]),
        "nan_loss": _records(plain_off=plain_off, loss_of=lambda i, r: [
            float("nan") if i == 6 else r[0], r[1]]),
    }[fault]
    ok, reason = chip_smoke.dp_gate(records)
    assert not ok, fault
    step = {"loss_off_at_step_1": "step 1", "nan_loss": "step 6"}.get(
        fault, "step 0")
    assert reason.startswith(step + ":"), reason


def test_dp_trajectory_finds_the_first_parting_steps():
    records = _records(dp_off=lambda i: 0 if i < 4 else 560,
                       plain_off=lambda i: 0 if i < 6 else 42,
                       loss_of=lambda i, r: [r[0] * (1 if i < 5 else 1.5),
                                             r[1]])
    t = chip_smoke.dp_trajectory(records)
    assert t["first_parting_step"][f"{PLAINS[0]} / {DP}"] == 4
    assert t["first_parting_step"][f"{PLAINS[1]} / {PLAINS[2]}"] == 6
    assert t["bitwise_leading_steps_first_plain"] == 5
    assert t["steps_bitwise_with_plain_runs"] == [False] * 3
    assert t["params_off_to_plain_runs"] == [560] * 3
    assert t["params_off_plain_runs"] == [42] * 3


def _tiny_runs(lr_scale=None):
    """Four runs of a small fine model's eager train step from one state:
    the second (labelled data parallel) with its k0 learning rate scaled
    by ``lr_scale`` (a planted fault), or as the others."""
    import copy
    from directvoxgo_tpu_torch.config import Config, ConfigDict
    from directvoxgo_tpu_torch.engine import graphs as graphs_lib
    from directvoxgo_tpu_torch.engine import train as train_lib
    from directvoxgo_tpu_torch.models.dvgo import DirectVoxGO
    model = DirectVoxGO(xyz_min=[-1] * 3, xyz_max=[1] * 3,
                        num_voxels=16 ** 3, num_voxels_base=16 ** 3,
                        alpha_init=1e-2, rgbnet_dim=6, rgbnet_width=16,
                        k_color=0, device="cpu")
    with torch.no_grad():
        model.density.normal_(0, 2, generator=torch.Generator()
                              .manual_seed(1))
        model.k0.normal_(0, 0.5, generator=torch.Generator().manual_seed(2))
    cfg = ConfigDict(dict(Config.fromfile(os.path.join(
        chip_smoke.REPO, "configs", "synthetic", "fixture_tiny.py"))
        .fine_train, N_rand=128))
    opt = train_lib.create_optimizer_or_freeze_model(model, cfg)
    rk = {"near": 0.5, "far": 4.0, "bg": 1.0, "stepsize": 0.5}
    rng = np.random.default_rng(0)
    n = 1024
    ro = np.concatenate([np.full((n, 1), -2.0), rng.uniform(-0.8, 0.8, (
        n, 2))], 1).astype(np.float32)
    rd = np.tile(np.float32([[1, 0, 0]]), (n, 1))
    pool = {"rgb": torch.tensor(rng.uniform(0, 1, (n, 3)), dtype=torch
                                .float32),
            "rays_o": torch.tensor(ro), "rays_d": torch.tensor(rd),
            "viewdirs": torch.tensor(rd)}
    runs = {}
    for label in LABELS:
        m, o = copy.deepcopy((model, opt))
        if label == DP and lr_scale:
            o.groups["k0"]["lr"] *= lr_scale
        step = train_lib.make_train_step(m, o, cfg, rk, False, False,
                                         axis=0, clip_sizes=None)
        runs[label] = (m, o, step, graphs_lib.StepGraphs(
            torch.device("cpu")))
    sels = rng.integers(0, n, (4, 128))
    return (model, opt), runs, pool, sels, np.zeros((4, 3), np.int32)


@pytest.mark.parametrize("lr_scale", [None, 2.0])
def test_dp_lockstep_takes_each_step_from_one_state(lr_scale):
    """Real steps on the CPU through :func:`chip_smoke.dp_lockstep` with
    ``sync``: every run takes each step from the first run's state; the
    gate passes identical runs and fails a run whose k0 update is scaled.
    :func:`chip_smoke.dp_sync` then puts every run back to the start."""
    src, runs, pool, sels, offs = _tiny_runs(lr_scale)
    records = chip_smoke.dp_lockstep(torch, runs, (0, None), pool, sels,
                                     offs, sync=True)
    ok, reason = chip_smoke.dp_gate(records)
    assert ok == (lr_scale is None), reason
    if lr_scale:
        # the fault shows at every step, not only from the first on
        assert all(min(d for a, b, d in r["off"] if DP in (a, b)) > 100
                   for r in records)
    for m, o, _, _ in runs.values():
        chip_smoke.dp_sync(torch, (m, o), src)
        assert chip_smoke.params_off(torch, m, src[0]) == 0
        assert torch.equal(o.state["step"], src[1].state["step"])
