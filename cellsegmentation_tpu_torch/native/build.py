"""Build and load the native morphology library (C++, ctypes).

Compiled with ``g++`` at first use into the package's git-ignored
``_build/`` directory, under a name that hashes the source and the flags,
and reused by later processes. Generic x86-64 code (no ``-march=native``),
so a library built on one machine loads on another. ``load_native``
returns None when no compiler is present or the build fails: the callers
then take the SciPy path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

SRC = Path(__file__).resolve().parent / "morphology.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
FLAGS = ("-O3", "-shared", "-fPIC")

_lib: Optional[ctypes.CDLL] = None
_attempted = False


def library_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(FLAGS).encode())
    return BUILD_DIR / f"libmorphology_{digest.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    try:
        subprocess.run(["g++", *FLAGS, "-o", tmp, str(SRC)], check=True,
                       capture_output=True)
        os.replace(tmp, out)  # atomic: a concurrent process never loads a partial file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_native() -> Optional[ctypes.CDLL]:
    """Build (if needed) and load the library once per process; None if
    that fails."""
    global _lib, _attempted
    if _attempted:
        return _lib
    _attempted = True
    try:
        out = library_path()
        if not out.exists():
            _build(out)
        lib = ctypes.CDLL(str(out))
        u8p = ctypes.POINTER(ctypes.c_uint8)
        one = [u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_int]
        lib.remove_small_objects.argtypes = one
        lib.remove_small_holes.argtypes = one
        lib.remove_small_regions_batch.argtypes = [
            u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
        ]
        for fn in (lib.remove_small_objects, lib.remove_small_holes,
                   lib.remove_small_regions_batch):
            fn.restype = None
        _lib = lib
    except (OSError, subprocess.CalledProcessError):
        _lib = None
    return _lib
