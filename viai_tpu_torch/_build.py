"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each `csrc/<name>.cu` is compiled on first use into its own shared
library with a plain C interface,
`build/viai_tpu_torch/<name>-<hash>.so` at the root of the checkout,
keyed by a hash of the sources, the flags and the compiler, so a changed
source is rebuilt and an unchanged one is loaded as it is. Sources are
compiled in parallel, one nvcc process each. A failed build raises.
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
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "viai_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclasses.dataclass(frozen=True)
class BuildResult:
    name: str
    path: Path
    seconds: float      # 0.0 when an earlier build was reused
    log: str            # nvcc's output: ptxas registers, smem, spills


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


def sources() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _target(name: str, nvcc: str) -> Path:
    h = hashlib.sha256()
    for p in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join((nvcc, *NVCC_FLAGS)).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: list[str] | None = None) -> dict[str, BuildResult]:
    """Compile the named sources (all by default) that have no library
    for their current hash yet, in parallel; raise if any build fails."""
    names = sources() if names is None else names
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    results, running = {}, {}
    for name in names:
        out = _target(name, nvcc)
        log = out.with_suffix(".log")
        if out.exists():
            results[name] = BuildResult(
                name, out, 0.0, log.read_text() if log.exists() else "")
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, out, tmp, log, time.perf_counter())
    failed = []
    # Wait for every nvcc before raising, so none is left running.
    for name, (proc, out, tmp, log, t0) in running.items():
        text, _ = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed for csrc/{name}.cu "
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
    """The loaded shared library of `csrc/<name>.cu`, built if needed."""
    return ctypes.CDLL(str(build([name])[name].path))
