"""Benchmark of directvoxgo_tpu_torch on one NVIDIA H100.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line. Everything a cell needs is found by name: its configuration in
``configs/<config>.json`` (with the plain reference it names under
``reference/``), its traffic mix in ``traffic/<traffic>.json`` (with the
driver it names, ``traffic/<driver>.py``), its limits in
``limits/<cell>.json`` and each metric's reader in
``metrics/<metric>.py``.
"""
