"""Package-level contracts of the port: it imports neither JAX nor the JAX
package, its copied host modules stay identical to the reference's,
`chip_smoke.py` fails without the rest of the repository, and the serving
launcher runs on the CPU."""
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
