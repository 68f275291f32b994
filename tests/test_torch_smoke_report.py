"""``chip_smoke.py``'s phase-1 failure report, its fresh-process check and
its K-G small check, on the CPU (the kernels' plain versions stand in for
the kernels; on the card the same code compares the two). A failed check
must say where the worst element is, how many are off, and which side
left the plain version on the CPU."""

import json

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
