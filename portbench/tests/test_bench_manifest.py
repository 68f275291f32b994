"""BENCHMARK.json against the benchmark's contract: keys, names, units,
lengths, bounds, which cells report which metric, and the files each entry
is found by."""

import json
import os
import re

import pytest

from portbench import run as prun

ROOT, HERE = prun.ROOT, prun.HERE
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return prun.read_json(os.path.join(ROOT, "BENCHMARK.json"))


def text_ok(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_size(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= len(bench["command"]) <= 32
    assert all(text_ok(w) for w in bench["command"])
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p)
        assert not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    for word in bench["command"][1:]:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in bench["paths"])
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51


def test_names_units_and_entry_keys(bench):
    names = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and text_ok(c["source"]) \
            and text_ok(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith("portbench/")
        names.add(c["name"])
    assert len(names) == len(bench["configs"]) and 1 <= len(names) <= 24
    cells, pairs = set(), set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert text_ok(w["why"])
        cells.add(w["name"])
        pairs.add((w["config"], w["traffic"]))
    assert len(cells) == len(pairs) == len(bench["workloads"])
    assert sum(w["chips"] == 4 for w in bench["workloads"]) <= max(
        1, len(cells) // 4)
    assert {w["config"] for w in bench["workloads"]} == names
    metric_names = set()
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        metric_names.add(m["name"])
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in SOURCES and text_ok(m["layer"])
        metric_names.add(m["name"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert len(metric_names) == len(bench["end_to_end"]) \
        + len(bench["per_layer"])
    assert 1 <= len(bench["end_to_end"]) <= 16
    assert 1 <= len(bench["per_layer"]) <= 128
    assert next(m for m in bench["end_to_end"]
                if m["name"] == "setup_s")["bound"] == 0.25


def test_every_cell_reports_what_it_must(bench):
    for w in bench["workloads"]:
        e2e = [m["name"] for m in bench["end_to_end"]
               if prun.applies(m, w, bench)]
        layer = [m for m in bench["per_layer"] if prun.applies(m, w, bench)]
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert layer, w["name"]
        for m in layer:
            # a per-layer metric's cells report the metric it moves
            assert m["moves"] in e2e, (w["name"], m["name"])


def test_per_layer_layers_and_moves(bench):
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
    # a kernel's metrics name its layer alike
    for prefix, layer in (("ka_", "kernel K-A"), ("kc_", "kernel K-C"),
                          ("kf_", "kernel K-F"), ("idle_", "device")):
        assert all(m["layer"] == layer for m in bench["per_layer"]
                   if m["name"].startswith(prefix))


def test_every_entry_finds_its_files(bench):
    for c in bench["configs"]:
        path = os.path.join(ROOT, c["file"])
        assert os.path.isfile(path)
        cfg = prun.read_json(path)
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert os.path.isfile(os.path.join(HERE, "reference",
                                           f"{cfg['reference']}.py"))
    for w in bench["workloads"]:
        traffic = prun.read_json(os.path.join(HERE, "traffic",
                                              f"{w['traffic']}.json"))
        assert os.path.isfile(os.path.join(HERE, "traffic",
                                           f"{traffic['driver']}.py"))
        limits = prun.read_json(os.path.join(HERE, "limits",
                                             f"{w['name']}.json"))
        assert limits and all(isinstance(v, (int, float))
                              for v in limits.values())
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert os.path.isfile(os.path.join(HERE, "metrics",
                                           f"{m['name']}.py")), m["name"]


def test_files_under_paths_are_named_from_name_characters(bench):
    for base, _, files in os.walk(HERE):
        if "__pycache__" in base:
            continue
        for f in files:
            rel = os.path.relpath(os.path.join(base, f), ROOT)
            assert re.fullmatch(r"[A-Za-z0-9_.\-/]+", rel), rel


def test_command_runs_the_harness(bench):
    assert bench["command"][1] == "portbench/run.py"
    assert json.loads(json.dumps(bench)) == bench
