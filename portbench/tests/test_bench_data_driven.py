"""A new cell, configuration, traffic mix and metric are files and
entries alone: in a temporary copy, a cell and a metric reader are added
and the harness finds both by name."""

import json
import os

import tiny

from portbench import run as prun


def test_added_cell_and_metric_are_found_by_name(tmp_path):
    root, bench, cell = tiny.tiny_root(str(tmp_path), "lego_train_top")
    # a new configuration, mix and cell
    cfg = prun.read_json(os.path.join(root, "configs", "lego_fine.json"))
    cfg["name"] = "lego_other"
    with open(os.path.join(root, "configs", "lego_other.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(root, "traffic", "train_other.json"), "w") as f:
        json.dump({"driver": "train", "tv": "off"}, f)
    new = {"name": "lego_train_other", "config": "lego_other",
           "traffic": "train_other", "chips": 1, "why": "added as files"}
    with open(os.path.join(root, "limits", "lego_train_other.json"),
              "w") as f:
        json.dump(prun.read_json(os.path.join(
            root, "limits", "lego_train_top.json")), f)
    # a new per-layer metric, read by a file of its own
    with open(os.path.join(root, "metrics", "steps_done.train.py"),
              "w") as f:
        f.write("def read(rec):\n    return rec['units']\n")
    bench["workloads"].append(new)
    bench["per_layer"].append({"name": "steps_done.train", "unit": "steps",
                               "better": "higher", "source": "host_clock",
                               "layer": "train loop",
                               "moves": "train_step_ms",
                               "workloads": ["lego_train_other"]})
    for m in bench["end_to_end"]:
        if "workloads" in m and "lego_train_top" in m["workloads"]:
            m["workloads"].append("lego_train_other")
    import torch
    out, rec = prun.run_cell(bench, new, 5, 0.3, False, torch.device("cpu"),
                             root=root)
    assert out["correct"] and "train_step_ms" in out["metrics"]
    assert rec["units"] >= 1
    # the per-layer group takes the new reader (no trace: what it reads
    # is the record's step count)
    reader = prun.load_file("metrics", "steps_done.train", root)
    assert reader.read(rec) == rec["units"]
    assert prun.applies(bench["per_layer"][-1], new, bench)
    assert not prun.applies(bench["per_layer"][-1], cell, bench)
