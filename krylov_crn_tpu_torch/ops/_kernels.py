"""Build and load the port's native code (compiler -> shared library -> ctypes).

The sources live in ``krylov_crn_tpu_torch/csrc``. At first use each one is
compiled into ``krylov_crn_tpu_torch/_build/`` (listed in .gitignore), under
a file name that carries a hash of the source and flags, so an edited source
never loads a stale library:

* the CUDA kernels (``*.cu``) with nvcc for ``sm_90a`` (``load_library``);
* the host C LIBSVM parser (``libsvm_parser.c``) with the host C compiler
  (``load_host_library``).

A plain C interface bound with ctypes builds in seconds, where a PyTorch
C++ extension takes minutes to compile.

Nothing here runs at import: the CPU-only test environment has no nvcc.
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

__all__ = ["load_library", "load_host_library", "nvcc_path",
           "last_build_seconds", "last_build_log"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
# -Xptxas=-v: ptxas reports each kernel's registers, shared memory and
# spills (kept in last_build_log)
NVCC_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas=-v"]
# flags of one kernel on top of those: csrc/subproblem.cu is emulated bit
# for bit on the CPU (ops/subproblem.py), so every operation there rounds on
# its own (no fused multiply-add) and divides and roots to nearest
KERNEL_FLAGS = {"subproblem": ["--fmad=false", "--prec-div=true",
                               "--prec-sqrt=true", "--ftz=false"]}
CC_FLAGS = ["-O3", "-shared", "-fPIC"]

_loaded: dict[str, ctypes.CDLL] = {}
last_build_seconds: dict[str, float] = {}
last_build_log: dict[str, str] = {}  # the compiler's output of each build


def nvcc_path() -> str:
    """nvcc from $CUDA_HOME, $PATH, or the toolkit's default prefix."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _build(name: str, src: Path, compiler: str, flags: list[str]) -> Path:
    tag = hashlib.sha1(src.read_bytes() + " ".join(flags).encode()
                       ).hexdigest()[:12]
    out = BUILD_DIR / f"lib{name}_{tag}.so"
    if out.exists():
        last_build_seconds[name] = 0.0
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: a concurrent loader never
    # sees a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [compiler, *flags, "-o", tmp, str(src)]
    t0 = time.perf_counter()
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"{Path(compiler).name} failed ({res.returncode}) building "
                f"{src.name}:\n{' '.join(cmd)}\n{res.stdout}\n{res.stderr}")
        os.replace(tmp, out)
        last_build_log[name] = res.stdout + res.stderr
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    last_build_seconds[name] = time.perf_counter() - t0
    return out


def _load(name: str, build) -> ctypes.CDLL:
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build()))
        _loaded[name] = lib
    return lib


def load_library(name: str) -> ctypes.CDLL:
    """The ctypes handle of ``csrc/<name>.cu``, built with nvcc on first
    use (with ``KERNEL_FLAGS[name]`` where it has any)."""
    flags = ARCH_FLAGS + NVCC_FLAGS + KERNEL_FLAGS.get(name, [])
    return _load(name, lambda: _build(name, CSRC / f"{name}.cu", nvcc_path(),
                                      flags))


def load_host_library(name: str) -> ctypes.CDLL:
    """The ctypes handle of the host C source ``csrc/<name>.c``, built
    with ``$CC`` (default ``cc``) on first use."""
    return _load(name, lambda: _build(name, CSRC / f"{name}.c",
                                      os.environ.get("CC", "cc"), CC_FLAGS))
