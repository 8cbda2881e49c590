"""Package-level contracts of the port: it imports neither JAX nor the JAX
package, its copied host modules stay identical to the reference's,
`chip_smoke.py` fails without the rest of the repository, a kernel
library's name follows every header its source may include, its build
keeps ptxas' report beside it, and the serving launcher runs on the
CPU."""
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
ENV = {**os.environ, "PYTHONPATH": str(SRC)}


def test_port_imports_no_jax_and_nothing_of_repro():
    mods = sorted(
        ".".join(p.relative_to(SRC).with_suffix("").parts)
        for p in (SRC / "repro_torch").rglob("*.py")
        if p.name != "__init__.py")
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], env=ENV,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("path", [
    "core/paged/allocator.py",
    "core/attention/heuristics.py",
    "serving/request.py",
    "serving/prefix_cache.py",
    "serving/scheduler.py",
    "training/data.py",
])
def test_copied_host_modules_match_reference(path):
    """The port keeps its own copies of the reference's pure-Python host
    modules; only the package name in their imports differs."""
    ref = (SRC / "repro" / path).read_text()
    port = (SRC / "repro_torch" / path).read_text()
    assert port == ref.replace("from repro.", "from repro_torch.")


def test_chip_smoke_alone_fails_without_result(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path)
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120,
                         env={k: v for k, v in os.environ.items()
                              if k != "PYTHONPATH"})
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_library_name_hashes_every_header(tmp_path, monkeypatch):
    """An edit to a csrc/*.cuh header renames every library, so a library
    built from the old header is never loaded."""
    from repro_torch.kernels import _build

    (tmp_path / "a.cu").write_text('#include "tile.cuh"\n')
    (tmp_path / "b.cu").write_text("// no include\n")
    (tmp_path / "tile.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = {n: _build.library_path(n) for n in ("a", "b")}
    assert before["a"] != before["b"]
    assert _build.library_path("a") == before["a"]  # deterministic
    (tmp_path / "tile.cuh").write_text("// v2\n")
    for n in ("a", "b"):
        assert _build.library_path(n) != before[n]
        assert _build.library_path(n).name.startswith(f"lib{n}-")


def test_build_keeps_ptxas_report_beside_the_library(tmp_path, monkeypatch):
    """One nvcc run (with -Xptxas -v) builds a library and keeps ptxas'
    report beside it: `resource_usage` reads that report and compiles
    nothing again; a library whose report is gone is rebuilt."""
    from repro_torch.kernels import _build

    csrc, calls = tmp_path / "csrc", tmp_path / "calls"
    csrc.mkdir()
    (csrc / "a.cu").write_text("// kernel\n")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\n"
        f"echo \"$*\" >> {calls}\n"
        "while [ $# -gt 0 ]; do [ \"$1\" = -o ] && out=$2; shift; done\n"
        "echo lib > \"$out\"\n"
        "echo \"ptxas info    : Compiling entry function 'k' for "
        "'sm_90a'\" >&2\n"
        "echo 'ptxas info    : Used 40 registers' >&2\n"
        "echo 'nvcc: a line of no interest' >&2\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "BUILD_SECONDS", {})
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(nvcc))
    want = ["ptxas info    : Compiling entry function 'k' for 'sm_90a'",
            "ptxas info    : Used 40 registers"]
    assert _build.resource_usage("a") == want
    assert _build.resource_usage("a") == want
    runs = calls.read_text().splitlines()
    assert len(runs) == 1 and "-Xptxas -v" in runs[0]
    lib = _build.library_path("a")
    assert lib.exists() and lib.with_suffix(".ptxas").exists()
    assert sorted(p.name for p in lib.parent.iterdir()) == sorted(
        [lib.name, lib.with_suffix(".ptxas").name])  # no temporary left
    lib.with_suffix(".ptxas").unlink()
    assert _build.build("a") == lib
    assert len(calls.read_text().splitlines()) == 2
    assert _build.resource_usage("a") == want


def test_serve_launcher_runs_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "smollm-135m", "--reduced", "--device", "cpu", "--num-requests",
         "5", "--max-new-tokens", "3", "--max-seqs", "2", "--rate", "2",
         "--chunked-prefill", "--max-prefill-tokens", "32"],
        env=ENV, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "served 5 requests" in out.stdout
    assert "on the CPU" in out.stdout


def test_serve_launcher_runs_hybrid_on_cpu():
    """zamba2 (reduced) through the padded per-kind step: prefill and
    decode calls, each sampled in its own dispatch."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "zamba2-1.2b", "--reduced", "--device", "cpu", "--num-requests",
         "4", "--max-new-tokens", "3", "--max-seqs", "2", "--rate", "2"],
        env=ENV, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "served 4 requests" in out.stdout
    assert "'prefill':" in out.stdout and "'decode':" in out.stdout
