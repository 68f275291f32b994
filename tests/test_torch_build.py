"""The kernel build (``directvoxgo_tpu_torch/ops/_build.py``) on the CPU,
with a stand-in for nvcc: a script that writes its output in two halves
with a pause between them, as a compiler that is still running leaves a
partial file. Two builds of one library, in two threads of one process or
in two processes, must leave one whole library; a partial file of a
killed build is never taken for a library; a failed build leaves
nothing behind, and neither do the builds started beside it."""

import glob
import os
import subprocess
import sys
import textwrap
import threading

import pytest

from directvoxgo_tpu_torch.ops import _build

NAME = "sweep_fwd"
WHOLE = "first half|second half"

FAKE_NVCC = textwrap.dedent("""\
    import os, sys, time
    out = sys.argv[sys.argv.index("-o") + 1]
    fail = os.environ.get("FAKE_NVCC_FAIL")
    if fail and sys.argv[-1].endswith(fail):
        print("error: the stand-in fails as asked")
        sys.exit(1)
    with open(out, "w") as f:
        f.write("first half|")
        f.flush()
        time.sleep(0.5)
        f.write("second half")
    """)


@pytest.fixture
def fake_build(tmp_path, monkeypatch):
    """``_build`` with its build directory in ``tmp_path`` and the
    stand-in nvcc; returns the build directory."""
    script = tmp_path / "nvcc.py"
    script.write_text(FAKE_NVCC)
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(f"#!/bin/sh\nexec {sys.executable} {script} \"$@\"\n")
    nvcc.chmod(0o755)
    out = tmp_path / "kernels"
    out.mkdir()
    monkeypatch.setattr(_build, "build_dir", lambda: str(out))
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "_LIBS", {})
    return out


def _leftovers(out):
    return sorted(os.path.basename(p) for p in glob.glob(str(out / "*.tmp*")))


def test_two_threads_building_one_library_leave_one_whole_file(fake_build):
    errors = []
    start = threading.Barrier(2)

    def build():
        start.wait()
        try:
            _build.build_all((NAME,))
        except Exception as e:  # noqa: BLE001 - checked below
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    with open(_build._lib_path(NAME)) as f:
        assert f.read() == WHOLE
    assert _leftovers(fake_build) == []


def test_two_processes_building_one_library_leave_one_whole_file(fake_build):
    code = textwrap.dedent(f"""\
        import sys
        from directvoxgo_tpu_torch.ops import _build
        _build.build_dir = lambda: {str(fake_build)!r}
        _build._nvcc = lambda: {str(fake_build.parent / "nvcc")!r}
        _build.build_all(({NAME!r},))
        """)
    procs = [subprocess.Popen([sys.executable, "-c", code],
                              cwd=os.path.dirname(os.path.dirname(
                                  os.path.abspath(__file__))),
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
    with open(_build._lib_path(NAME)) as f:
        assert f.read() == WHOLE
    assert _leftovers(fake_build) == []


def test_a_partial_file_of_a_killed_build_is_never_taken(fake_build):
    path = _build._lib_path(NAME)
    stem = os.path.basename(path)[:-3]
    for stale in (f"{stem}.12345.tmp.so", f"{stem}.abc123.tmp.so"):
        (fake_build / stale).write_text("first half|")
    assert not os.path.exists(path)
    _build.build_all((NAME,))
    with open(path) as f:
        assert f.read() == WHOLE
    # the stale files stay as they were: nothing reads or renames them
    assert _leftovers(fake_build) == [f"{stem}.12345.tmp.so",
                                      f"{stem}.abc123.tmp.so"]


def test_a_failed_build_leaves_nothing_behind(fake_build, monkeypatch):
    monkeypatch.setenv("FAKE_NVCC_FAIL", "sweep_fwd.cu")
    with pytest.raises(RuntimeError, match="nvcc failed for sweep_fwd.cu"):
        _build.build_all((NAME,))
    assert not os.path.exists(_build._lib_path(NAME))
    assert _leftovers(fake_build) == []
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build.load(NAME)
    assert os.listdir(fake_build) == []


def test_a_failed_build_waits_for_the_builds_beside_it(fake_build,
                                                       monkeypatch):
    """The first of two builds fails at once; the second, still writing,
    is finished and renamed before the failure is raised."""
    monkeypatch.setenv("FAKE_NVCC_FAIL", "sweep_fwd.cu")
    with pytest.raises(RuntimeError, match="nvcc failed for sweep_fwd.cu"):
        _build.build_all((NAME, "render_frame"))
    assert not os.path.exists(_build._lib_path(NAME))
    with open(_build._lib_path("render_frame")) as f:
        assert f.read() == WHOLE
    assert _leftovers(fake_build) == []
