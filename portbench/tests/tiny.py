"""Tiny copies of the benchmark's cells for CPU tests: the same drivers,
references and readers on the small committed fixtures, in a temporary
copy of the data files (configs, traffic mixes, limits)."""

from __future__ import annotations

import json
import os
import shutil

import torch

from portbench import run as prun

HERE = prun.HERE

LEGO = {"fixture": {"kind": "synthetic",
                    "file": "fixture_8_1_2_32_32_64_1_0_v2.npz",
                    "n_train": 8, "n_val": 1, "n_test": 2, "H": 32, "W": 32,
                    "teacher_res": 64, "variant": "blobs", "seed": 0},
        "model": {"num_voxels": 24 ** 3, "num_voxels_base": 24 ** 3,
                  "rgbnet_width": 16, "sweep_color_topk": 8},
        "coarse": {"num_voxels": 64 ** 3},
        "train": {"N_rand": 512, "steps_per_dispatch": 1}}
FERN = {"fixture": {"kind": "ndc",
                    "file": "fixture_ndc_12_2_3_64_64_64_0_v1.npz",
                    "n_train": 12, "n_val": 2, "n_test": 3, "H": 64, "W": 64,
                    "teacher_res": 64, "seed": 0},
        "model": {"num_voxels": 32 * 32 * 128, "mpi_depth": 128,
                  "rgbnet_width": 16, "sweep_color_topk": 8},
        "train": {"N_rand": 512, "steps_per_dispatch": 1}}
# cell -> (configuration, traffic mix, the configuration's tiny overrides)
CELLS = {"lego_train_top": ("lego_fine", "train_top", LEGO),
         "fern_train_dense_tv": ("fern_mpi", "train_dense_tv", FERN),
         "fern_train_sparse_tv": ("fern_mpi", "train_sparse_tv", FERN)}


def tiny_root(tmp, cell_name):
    """A directory of data files holding the tiny copy of ``cell_name``'s
    configuration and its mix and limits; returns (root, bench, cell)."""
    bench = prun.read_json(os.path.join(prun.ROOT, "BENCHMARK.json"))
    config, _, over = CELLS[cell_name]
    cell = next(w for w in bench["workloads"] if w["name"] == cell_name)
    for d in ("traffic", "metrics"):
        shutil.copytree(os.path.join(HERE, d), os.path.join(tmp, d),
                        dirs_exist_ok=True)
    for d in ("configs", "limits"):
        os.makedirs(os.path.join(tmp, d), exist_ok=True)
    cfg = prun.read_json(os.path.join(HERE, "configs", f"{config}.json"))
    cfg["fixture"] = dict(over["fixture"])
    cfg["fine_model_and_render"].update(over["model"])
    if "coarse" in over:
        cfg["coarse_model_and_render"].update(over["coarse"])
    cfg["fine_train"].update(over["train"])
    with open(os.path.join(tmp, "configs", f"{config}.json"), "w") as f:
        json.dump(cfg, f)
    shutil.copy(os.path.join(HERE, "limits", f"{cell_name}.json"),
                os.path.join(tmp, "limits"))
    return tmp, bench, cell


def run_tiny(tmp, cell_name, seed=123456789012, seconds=0.5):
    """Run the tiny copy of a cell on the CPU: (result, record)."""
    root, bench, cell = tiny_root(tmp, cell_name)
    torch.manual_seed(0)
    return prun.run_cell(bench, cell, seed, seconds, False,
                         torch.device("cpu"), root=root)
