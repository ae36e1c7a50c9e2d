"""Build the CUDA sources under ``csrc/`` with nvcc and load them by ctypes.

Each source compiles to its own shared library with a plain C interface
(no PyTorch headers, so a build takes seconds). Libraries land in
``cellsegmentation_tpu_torch/_build/`` under a name that hashes the source,
every ``csrc/`` file it includes (``#include "..."``, transitively) and the
flags, so an edited source or header never loads a stale library. A build
happens at first use, inside the call that needs the kernel; nothing is
compiled or loaded when a module is imported. ``build_all`` runs one nvcc
per source, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false", "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
# compiler output of each build (ptxas register / spill report) and its
# seconds, by source
build_logs: dict[str, str] = {}
build_secs: dict[str, float] = {}
_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin); the CUDA "
        "kernels are built from csrc/ on the machine with the card"
    )


def sources_of(source: str) -> list[str]:
    """``source`` and the ``csrc/`` files it includes, transitively, in the
    order first met."""
    found, todo = [], [source]
    while todo:
        name = todo.pop(0)
        if name in found:
            continue
        found.append(name)
        text = (CSRC / name).read_text()
        todo += [inc for inc in _INCLUDE.findall(text) if (CSRC / inc).is_file()]
    return found


def library_path(source: str) -> Path:
    digest = hashlib.sha256()
    for name in sources_of(source):
        digest.update(name.encode() + b"\0" + (CSRC / name).read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{Path(source).stem}_{digest.hexdigest()[:16]}.so"


def build(source: str) -> Path:
    """Compile ``csrc/<source>`` unless a library of the same hash exists."""
    out = library_path(source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    try:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / source)],
            capture_output=True, text=True,
        )
        build_secs[source] = time.perf_counter() - t0
        build_logs[source] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {source} (exit {proc.returncode}):\n"
                + build_logs[source]
            )
        os.replace(tmp, out)  # atomic: concurrent builders never see a partial file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def build_all(sources) -> dict[str, Path]:
    """Build several sources at once, one nvcc process each."""
    sources = list(sources)
    with ThreadPoolExecutor(max_workers=max(1, len(sources))) as pool:
        return dict(zip(sources, pool.map(build, sources)))


def load(source: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<source>``; one handle per process."""
    with _lock:
        if source not in _loaded:
            _loaded[source] = ctypes.CDLL(str(build(source)))
        return _loaded[source]
