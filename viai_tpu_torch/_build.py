"""Build the port's native sources and load them with ctypes.

Each target is compiled on first use into its own shared library with a
plain C interface, `build/viai_tpu_torch/<name>-<hash>.so` at the root
of the checkout, keyed by a hash of its sources, the flags and the
compiler, so a changed source is rebuilt and an unchanged one is loaded
as it is:

  * each `csrc/<name>.cu`, a CUDA kernel for sm_90a, by nvcc;
  * `native`, the host data loader (`csrc/wavio.cpp`,
    `csrc/framestack.cpp`: WAV decode, resampling, the threaded clip
    loader, the frame-stack reader), by the C++ compiler ($CXX, else
    g++).

Targets are compiled in parallel, one compiler process each. A failed
build raises. The directory is read at build time (`cache_dir`):
`utils/compile_cache.py::enable` relocates it or gives the process a
fresh one.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
import typing as tp
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "viai_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-pthread", "-std=c++17", "-Wall")
HOST_SOURCES = {"native": ("wavio.cpp", "framestack.cpp")}
_cache_dir: Path | None = None      # set_cache_dir; BUILD_DIR when unset


def cache_dir() -> Path:
    """Where the libraries are built and looked up."""
    return BUILD_DIR if _cache_dir is None else _cache_dir


def set_cache_dir(path: str | os.PathLike | None):
    """Build into `path` from now on (None: back to BUILD_DIR)."""
    global _cache_dir
    _cache_dir = None if path is None else Path(path)


@dataclasses.dataclass(frozen=True)
class BuildResult:
    name: str
    path: Path
    seconds: float      # 0.0 when an earlier build was reused
    log: str            # the compiler's output (ptxas registers, smem, spills)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin); the "
        "CUDA kernels of viai_tpu_torch are built from source at first use")


def _cxx() -> str:
    cxx = os.environ.get("CXX", "g++")
    found = shutil.which(cxx)
    if found is None:
        raise RuntimeError(
            f"C++ compiler {cxx!r} not found ($CXX, else g++); the native "
            f"data loader of viai_tpu_torch is built from source at first "
            f"use")
    return found


def sources() -> list[str]:
    """Every target: the CUDA kernels, then the host library."""
    return sorted(p.stem for p in CSRC.glob("*.cu")) + sorted(HOST_SOURCES)


def _recipe(name: str) -> tuple[list[Path], tp.Callable[[], str], tuple]:
    """(source files, compiler finder, flags) of a target."""
    if name in HOST_SOURCES:
        return [CSRC / f for f in HOST_SOURCES[name]], _cxx, CXX_FLAGS
    return [CSRC / f"{name}.cu"], _nvcc, NVCC_FLAGS


def _target(name: str, srcs: list[Path], compiler: str, flags) -> Path:
    h = hashlib.sha256()
    deps = srcs if name in HOST_SOURCES else [*srcs,
                                              *sorted(CSRC.glob("*.cuh"))]
    for p in deps:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join((compiler, *flags)).encode())
    return cache_dir() / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: list[str] | None = None) -> dict[str, BuildResult]:
    """Compile the named targets (all by default) that have no library
    for their current hash yet, in parallel; raise if any build fails."""
    names = sources() if names is None else names
    cache_dir().mkdir(parents=True, exist_ok=True)
    results, running = {}, {}
    for name in names:
        srcs, find, flags = _recipe(name)
        compiler = find()
        out = _target(name, srcs, compiler, flags)
        log = out.with_suffix(".log")
        if out.exists():
            results[name] = BuildResult(
                name, out, 0.0, log.read_text() if log.exists() else "")
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [compiler, *flags, "-o", str(tmp), *map(str, srcs)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, out, tmp, log, time.perf_counter())
    failed = []
    # Wait for every compiler before raising, so none is left running.
    for name, (proc, out, tmp, log, t0) in running.items():
        text, _ = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{Path(proc.args[0]).name} failed for {name} "
                          f"(exit {proc.returncode}):\n{text}")
            continue
        log.write_text(text)
        os.replace(tmp, out)
        results[name] = BuildResult(name, out, secs, text)
    if failed:
        raise RuntimeError("\n".join(failed))
    return results


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of a target, built if needed."""
    return ctypes.CDLL(str(build([name])[name].path))
