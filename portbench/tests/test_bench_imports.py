"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level names (the port's name begins with the JAX package's),
and the plain reference imports nothing of the port."""

import ast
import json
import os
import subprocess
import sys

from portbench import run as prun

ROOT, HERE = prun.ROOT, prun.HERE


def test_whole_name_comparison():
    assert prun.forbidden_modules(["directvoxgo_tpu_torch",
                                   "directvoxgo_tpu_torch.ops.grid",
                                   "jaxtyping", "jax_like", "flaxen"]) == []
    assert prun.forbidden_modules(["jax.numpy", "directvoxgo_tpu.engine",
                                   "jaxlib", "flax.linen"]) == [
        "directvoxgo_tpu", "flax", "jax", "jaxlib"]


def imported_names(path):
    tree = ast.parse(open(path).read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_sources_import_no_jax_and_the_reference_nothing_of_the_port():
    for base, _, files in os.walk(HERE):
        for f in files:
            if not f.endswith(".py"):
                continue
            names = imported_names(os.path.join(base, f))
            assert not names & {"jax", "jaxlib", "flax", "directvoxgo_tpu"}, f
            if os.path.basename(base) == "reference":
                assert "directvoxgo_tpu_torch" not in names, f
                assert names <= {"__future__", "numpy", "torch"}, (f, names)


def test_run_loads_no_jax_and_the_reference_alone_loads_no_port(tmp_path):
    """A whole tiny run in a fresh process, then the modules it loaded;
    and the reference imported alone."""
    code = (
        "import sys, json\n"
        f"sys.path[:0] = [{ROOT!r}, {os.path.join(HERE, 'tests')!r}]\n"
        "import tiny\n"
        f"tiny.run_tiny({str(tmp_path)!r}, 'fern_train_sparse_tv')\n"
        "from portbench import run\n"
        "print(json.dumps(run.forbidden_modules()))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
    code = (f"import sys; sys.path.insert(0, {ROOT!r})\n"
            "import portbench.reference.sweep_field\n"
            "print(sorted(m for m in sys.modules\n"
            "      if m.split('.')[0].startswith('directvoxgo')))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"
