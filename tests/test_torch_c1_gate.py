"""Phase 14 of ``chip_smoke.py`` on the CPU: its judgment (``c1_gate``) on
the committed CPU references with planted faults, the references'
integrity, and its run function (``c1_run``) rehearsed on the tiny cut
against the committed CPU port row."""

import copy
import json
import math
import os

import numpy as np
import pytest
import torch

import chip_smoke


@pytest.fixture(scope="module")
def ref():
    with open(chip_smoke.C1_REF) as f:
        return json.load(f)


def _card(ref):
    """A card run that is the CPU port's rows themselves."""
    return {case: copy.deepcopy(ref["cases"][case]["port"])
            for case in chip_smoke.C1_CASES}


def _shift(card, case, db):
    for row in card[case].values():
        row["psnr"] += db


def test_the_cpu_rows_themselves_pass(ref):
    out = chip_smoke.c1_gate(ref, _card(ref))
    for case in chip_smoke.C1_CASES:
        assert out[case]["passed"], out[case]["reasons"]
        assert out[case]["difference"] == 0.0
        assert all(s["draws_identical"] and s["first_parting"] is None
                   for s in out[case]["seeds"].values())


@pytest.mark.parametrize("case", sorted(chip_smoke.C1_CASES))
@pytest.mark.parametrize("db", [0.25, -0.25])
def test_a_mean_a_quarter_db_off_fails(ref, case, db):
    card = _card(ref)
    _shift(card, case, db)
    out = chip_smoke.c1_gate(ref, card)
    assert not out[case]["passed"]
    assert any("beyond" in r for r in out[case]["reasons"])
    assert out[case]["difference"] == pytest.approx(db)
    other = next(c for c in chip_smoke.C1_CASES if c != case)
    assert out[other]["passed"]


@pytest.mark.parametrize("case", sorted(chip_smoke.C1_CASES))
@pytest.mark.parametrize("db", [0.15, -0.15])
def test_a_mean_inside_the_bar_passes_and_is_reported(ref, case, db):
    card = _card(ref)
    _shift(card, case, db)
    out = chip_smoke.c1_gate(ref, card)
    assert out[case]["passed"], out[case]["reasons"]
    assert out[case]["difference"] == pytest.approx(db)
    assert out[case]["card_mean"] == pytest.approx(
        out[case]["cpu_mean"] + db)
    for s in out[case]["seeds"].values():
        assert s["card_minus_cpu"] == pytest.approx(db)


def _move_a_step(row):
    """One step drawn under another key: the first key gives one step to
    the second."""
    keys = sorted(row["draws"])
    assert len(keys) >= 2 and row["draws"][keys[0]] > 0
    row["draws"][keys[0]] -= 1
    row["draws"][keys[1]] += 1


@pytest.mark.parametrize("seed", [str(s) for s in chip_smoke.C1_SEEDS])
def test_fern_draws_differing_in_one_key_fail(ref, seed):
    card = _card(ref)
    _move_a_step(card["fern"][seed])
    out = chip_smoke.c1_gate(ref, card)
    assert not out["fern"]["passed"]
    assert [r for r in out["fern"]["reasons"]
            if r.startswith(f"seed {seed}: steps per key differ")]
    assert not out["fern"]["seeds"][seed]["draws_identical"]
    assert out["fern"]["difference"] == 0.0


def test_tiny_draws_that_part_pass_with_the_means_in_the_bar(ref):
    card = _card(ref)
    for row in card["tiny"].values():
        _move_a_step(row)
        row["pool"] = [n + 1 for n in row["pool"]]
        row["train"][-1][3] += 0.3
    card["tiny"]["777"]["psnr"] += 0.1
    out = chip_smoke.c1_gate(ref, card)
    assert out["tiny"]["passed"], out["tiny"]["reasons"]
    seeds = out["tiny"]["seeds"]
    assert not any(s["draws_identical"] for s in seeds.values())
    assert all(s["first_parting"] == card["tiny"][k]["train"][-1][:2]
               and s["pool_card"] != s["pool_cpu"] for k, s in seeds.items())


@pytest.mark.parametrize("case", sorted(chip_smoke.C1_CASES))
@pytest.mark.parametrize("side", ["card", "cpu"])
def test_a_missing_seed_fails(ref, case, side):
    card = _card(ref)
    if side == "card":
        del card[case]["2"]
    else:
        ref = copy.deepcopy(ref)
        del ref["cases"][case]["port"]["2"]
    out = chip_smoke.c1_gate(ref, card)
    assert not out[case]["passed"]
    want = "card" if side == "card" else "CPU port"
    assert f"seed 2: no {want} row" in out[case]["reasons"]
    assert "card_mean" not in out[case]


def test_a_card_psnr_that_is_not_finite_fails(ref):
    card = _card(ref)
    card["tiny"]["1"]["psnr"] = float("nan")
    out = chip_smoke.c1_gate(ref, card)
    assert not out["tiny"]["passed"]
    assert any("card PSNR nan" in r for r in out["tiny"]["reasons"])


def test_first_parting_names_the_first_print_past_the_bar():
    a = [["coarse", 100, 0.1, 20.0], ["fine", 100, 0.1, 21.0],
         ["fine", 200, 0.1, 22.0]]
    b = copy.deepcopy(a)
    assert chip_smoke.c1_first_parting(a, b) is None
    b[1][3] += 0.04
    assert chip_smoke.c1_first_parting(a, b) is None
    b[2][3] += 0.06
    assert chip_smoke.c1_first_parting(a, b) == ["fine", 200]
    assert chip_smoke.c1_first_parting(a, a[:2]) == ["fine", 200]


def test_the_references_hold_every_case_and_seed_with_their_means(ref):
    assert set(ref["cases"]) == set(chip_smoke.C1_CASES)
    steps = {"tiny": chip_smoke.TINY_CUT["coarse_train.N_iters"]
             + chip_smoke.TINY_CUT["fine_train.N_iters"],
             "fern": chip_smoke.C1_FERN_ITERS}
    for case, (path, cut, _) in chip_smoke.C1_CASES.items():
        entry = ref["cases"][case]
        assert entry["config"] == path
        assert os.path.exists(os.path.join(chip_smoke.REPO, path))
        assert entry["overrides"] == cut
        assert entry["i_print"] == chip_smoke.C1_I_PRINT
        for side in ("port", "jax"):
            rows = entry[side]
            assert sorted(rows) == sorted(map(str, chip_smoke.C1_SEEDS))
            assert entry[f"{side}_mean"] == pytest.approx(
                np.mean([r["psnr"] for r in rows.values()]), abs=1e-12)
            for r in rows.values():
                assert math.isfinite(r["psnr"])
                assert sum(r["draws"].values()) == steps[case]
                assert r["train"] and all(len(t) == 4 for t in r["train"])
        for r in entry["port"].values():
            assert "carried_over" not in r
        if case == "tiny":
            assert all(len(r["pool"]) == 1 for r in entry["port"].values())
        assert abs(entry["port_mean"] - entry["jax_mean"]) \
            <= chip_smoke.C1_BAR_DB


# The rehearsal's seed and its bars. The committed rows ran at 2 torch
# threads; the same runs at 1 and 6 threads drew the same steps per key
# from the same pools, printed the same train PSNRs, and ended within
# 4.3e-4 dB of the row (seed 1 at 6 threads; 777 and 2 within 2.4e-4):
# the thread count changes the order of PyTorch's CPU reductions. The
# bars take 0.01 dB, the prints' own unit, over that.
REHEARSAL_SEED = 1
REHEARSAL_PSNR_DB = 0.01
REHEARSAL_TRAIN_DB = 0.01


def test_phase14_run_function_rehearses_the_tiny_cut_on_the_cpu(
        ref, tmp_path):
    """``c1_run`` as phase 14 calls it, on the CPU: the tiny cut at one
    seed against the committed CPU port row."""
    want = ref["cases"]["tiny"]["port"][str(REHEARSAL_SEED)]
    # One thread: at the default count (a thread a core), beside five other
    # test workers on an 8-core host, this run took 826 s; at one, ~27 s.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        got = chip_smoke.c1_run("tiny", tmp_path, REHEARSAL_SEED, "cpu")
    finally:
        torch.set_num_threads(threads)
    assert got["draws"] == want["draws"]
    assert got["pool"] == want["pool"]
    assert [t[:2] for t in got["train"]] == [t[:2] for t in want["train"]]
    assert max(abs(a[3] - b[3]) for a, b in zip(got["train"],
                                                 want["train"])) \
        <= REHEARSAL_TRAIN_DB
    assert abs(got["psnr"] - want["psnr"]) <= REHEARSAL_PSNR_DB
    assert got["paths"] == want["paths"]
