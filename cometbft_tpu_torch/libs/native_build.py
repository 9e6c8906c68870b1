"""Compile-and-load machinery for the package's C++ host engine.

The host batch verifier (crypto/host_batch.py over native/edbatch.cpp)
builds a shared object with g++ at first use and loads it with ctypes.
The object goes to ``build/native/`` at the root of the checkout (a
directory git ignores) and is rebuilt when its source is newer. A missing
g++, a failed compile or a library that will not load raises
:class:`NativeBuildError`: nothing here remembers a failure or hands back
``None``, so every caller sees the fault.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

from . import sync as libsync

BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-funroll-loops", "-shared", "-fPIC", "-std=c++17")

_lock = libsync.Mutex("libs.native_build._lock")


class NativeBuildError(RuntimeError):
    pass


def build_and_load(src, so=None, timeout: float = 120.0) -> ctypes.CDLL:
    """Compile ``src`` into ``so`` (default ``BUILD_DIR/_<stem>.so``) when
    that is missing or older than the source, and load it."""
    src = Path(src)
    so = Path(so) if so is not None else BUILD_DIR / f"_{src.stem}.so"
    with _lock:
        if not so.exists() or so.stat().st_mtime < src.stat().st_mtime:
            _compile(src, so, timeout)
        try:
            return ctypes.CDLL(str(so))
        except OSError as e:
            raise NativeBuildError(f"{so.name} will not load: {e!r}") from e


def _compile(src: Path, so: Path, timeout: float) -> None:
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, str(src), "-o", str(tmp)]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=timeout)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise NativeBuildError(f"g++ could not run: {e!r}") from e
    if r.returncode != 0:
        raise NativeBuildError(
            f"{src.name}: g++ failed (exit {r.returncode}):\n"
            f"{r.stderr[-2000:]}"
        )
    os.replace(tmp, so)
