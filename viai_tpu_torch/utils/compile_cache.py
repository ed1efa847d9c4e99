"""Where the port's run-time builds are cached.

The port's counterpart of `viai_tpu/utils/compile_cache.py`, which
keeps XLA's compiled programs. The port compiles nothing at run time
but its CUDA kernels and its native data loader, and `_build.py`
already caches each by a hash of its sources, flags and compiler, in
`build/viai_tpu_torch/` at the root of the checkout. `enable` gives
that cache the JAX module's knobs:

  * `cache_dir`, else $VIAI_CACHE_DIR: build and look up there;
  * $VIAI_NO_CACHE=1: a fresh directory for this process under
    `build/viai_tpu_torch/`, removed at its exit, so every process
    builds anew;
  * neither: `build/viai_tpu_torch/`.

The CLIs and the bench call it at start, where the JAX CLIs call
theirs. No `torch.compile` is used, so there is no inductor cache to
place.
"""

from __future__ import annotations

import atexit
import functools
import os
import shutil
import tempfile
from pathlib import Path

from .. import _build


@functools.lru_cache(maxsize=None)
def _process_dir(pid: int) -> str:
    """This process's own build directory, removed at its exit."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = tempfile.mkdtemp(prefix=f"nocache-{pid}-", dir=_build.BUILD_DIR)
    atexit.register(shutil.rmtree, path, ignore_errors=True)
    return path


def enable(cache_dir: str | None = None) -> Path:
    """Point the build cache at its directory; → that directory."""
    if os.environ.get("VIAI_NO_CACHE"):
        path = _process_dir(os.getpid())
    else:
        path = (cache_dir or os.environ.get("VIAI_CACHE_DIR")
                or _build.BUILD_DIR)
    _build.set_cache_dir(path)
    return _build.cache_dir()
