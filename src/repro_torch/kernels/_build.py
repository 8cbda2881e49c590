"""Build and load the hand-written CUDA kernels.

Each source under `repro_torch/csrc/` is compiled on first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/<name>-<hash>.so csrc/<name>.cu

into the `build/` directory at the root of the checkout (listed in
`.gitignore`) and loaded with `ctypes`.  The library name carries a hash
of the source and the flags, so an edited source is rebuilt and a stale
library is never loaded.  `python -m repro_torch.kernels._build` builds
every source and prints ptxas' registers / spills per kernel.  Nothing here runs at import time: the CPU-only
test host has no `nvcc` and never calls `load()`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_LIBS: dict[str, ctypes.CDLL] = {}
# seconds spent in nvcc per library in this process (0.0 when a library
# built by an earlier process was reused)
BUILD_SECONDS: dict[str, float] = {}


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, else `nvcc` on PATH."""
    from torch.utils.cpp_extension import CUDA_HOME

    cands = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    for c in cands:
        if os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH; "
                       "the CUDA kernels are built from source at first use")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(name: str) -> Path:
    """Compile csrc/<name>.cu unless an up-to-date library exists."""
    out = library_path(name)
    if out.exists():
        BUILD_SECONDS.setdefault(name, 0.0)
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: concurrent builders never see half a file
    BUILD_SECONDS[name] = time.perf_counter() - t0
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, building it first if needed."""
    if name not in _LIBS:
        _LIBS[name] = ctypes.CDLL(str(build(name)))
    return _LIBS[name]


def main() -> None:
    """Build every csrc/*.cu, then print ptxas' resource use per kernel
    (registers, spills) from a second compile with -Xptxas -v."""
    for src in sorted(CSRC.glob("*.cu")):
        out = build(src.stem)
        print(f"{src.name}: {out} (nvcc {BUILD_SECONDS[src.stem]:.1f}s)")
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run(
                [nvcc_path(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp,
                 str(src)], capture_output=True, text=True, check=True)
        finally:
            os.unlink(tmp)
        for line in proc.stderr.splitlines():
            if "Compiling entry" in line or "registers" in line \
                    or "spill" in line:
                print(line.strip())


if __name__ == "__main__":
    main()
