"""Builds the package's C++ sources into plain C-interface shared libraries.

Each ``csrc/<name>.cu`` (a CUDA kernel) compiles with ``nvcc``, and each
``csrc/<name>.cpp`` (host code) with ``g++``, into
``build/wembed_tpu_torch/lib<name>_<hash>.so`` at the repository root the
first time it is used, and loads with ``ctypes``.  The file name carries a
hash of the sources and the flags, so an edit rebuilds.  A failed build
raises; nothing falls back to Python.

Flags: ``--fmad=false`` keeps every multiply and add separately rounded,
as PyTorch's eager elementwise ops round them, so the kernels' dead-zone
masks agree bit for bit with their plain twins.  ``--use_fast_math`` is
never used for the same reason (it also swaps IEEE sqrt and division for
approximations).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "wembed_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


@dataclass(frozen=True)
class BuildInfo:
    path: Path
    seconds: float  # 0.0 when the library was already built
    log: str  # the compiler's output (for nvcc, ptxas's register and shared-memory report)


_loaded: dict[str, ctypes.CDLL] = {}
_configured: dict[str, set] = {}  # the configure functions run on each loaded library


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin)")


def _gxx() -> str:
    found = shutil.which("g++")
    if found:
        return found
    raise RuntimeError("g++ not found on PATH")


def _sources(name: str) -> list[Path]:
    cuda, host = CSRC / f"{name}.cu", CSRC / f"{name}.cpp"
    if cuda.exists():
        return [cuda, *sorted(CSRC.glob("*.cuh"))]
    if host.exists():
        return [host]
    raise FileNotFoundError(cuda)


def _library(name: str) -> tuple[Path, list[Path], tuple[str, ...]]:
    """(library path, sources, flags) of ``csrc/<name>``: the path's hash
    covers the sources and the flags."""
    sources = _sources(name)
    flags = NVCC_FLAGS if sources[0].suffix == ".cu" else GXX_FLAGS
    digest = hashlib.sha256(" ".join(flags).encode())
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so", sources, flags


def build(name: str) -> BuildInfo:
    """Compile ``csrc/<name>.cu`` or ``csrc/<name>.cpp`` unless a library of
    the same sources exists (then with no compiler log)."""
    out, _, _ = _library(name)
    if out.exists():
        return BuildInfo(out, 0.0, "")
    return compile_library(name)


def compile_library(name: str) -> BuildInfo:
    """Compile ``csrc/<name>`` into its library path whether or not it
    exists, for the compiler's log (ptxas's register and spill report)."""
    out, sources, flags = _library(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build to a private name, then rename: a concurrent process never
    # loads a half-written library
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    compiler = _nvcc() if sources[0].suffix == ".cu" else _gxx()
    cmd = [compiler, *flags, "-o", str(tmp), str(sources[0])]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"{Path(cmd[0]).name} failed with code {proc.returncode}: {' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)
    return BuildInfo(out, seconds, proc.stdout + proc.stderr)


def load(name: str, configure: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The library of ``csrc/<name>``, built if needed and loaded once per
    process; ``configure`` sets the argtypes of the functions its caller
    uses, once per library (two modules may bind one library)."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name).path))
        _loaded[name] = lib
    done = _configured.setdefault(name, set())
    if configure not in done:
        configure(lib)
        done.add(configure)
    return lib
