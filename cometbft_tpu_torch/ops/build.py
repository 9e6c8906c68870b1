"""Build the hand-written CUDA kernels at first use and load them.

Each ``csrc/*.cu`` compiles with its own nvcc, all in parallel, for
Hopper (``sm_90a``) into a
shared library with a plain C interface under ``build/kernels/`` at the
root of the checkout, named by a hash of the sources so an edit rebuilds.
The library loads with ``ctypes``: no PyTorch headers are compiled. The
fully unrolled field code still keeps ptxas busy for a minute or two a
source, which is why the sources are split and built side by side. A
missing nvcc or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
# per source: {"seconds": build time, "ptxas": nvcc's -Xptxas -v report,
# "path": the library}
BUILD_INFO: dict[str, dict] = {}


class KernelBuildError(RuntimeError):
    pass


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise KernelBuildError("nvcc not found: the CUDA kernels cannot be built")


def _digest(source: Path) -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cuh")) + [source]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _build(source: Path) -> Path:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"lib{source.stem}_{_digest(source)}.so"
    if out.exists():
        BUILD_INFO.setdefault(source.name, {"seconds": 0.0, "ptxas": "",
                                            "path": out})
        return out
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
        capture_output=True,
        text=True,
    )
    if proc.returncode != 0:
        raise KernelBuildError(
            f"nvcc failed on {source.name} (exit {proc.returncode}):\n"
            f"{proc.stderr[-4000:]}"
        )
    os.replace(tmp, out)
    BUILD_INFO[source.name] = {
        "seconds": time.perf_counter() - t0,
        "ptxas": proc.stderr,
        "path": out,
    }
    return out


def load_all(names=None) -> dict[str, ctypes.CDLL]:
    """Every ``csrc/<name>.cu``, or only the sources ``names`` lists
    (paths under csrc/, such as a probe's ``probes/<name>.cu``), built
    (one nvcc each, all started together) and loaded, by stem."""
    sources = (sorted(CSRC.glob("*.cu")) if names is None
               else [CSRC / name for name in names])
    with _lock:
        missing = [s for s in sources if s.stem not in _loaded]
        if missing:
            with ThreadPoolExecutor(len(missing)) as pool:
                paths = list(pool.map(_build, missing))
            for src, path in zip(missing, paths):
                _loaded[src.stem] = ctypes.CDLL(str(path))
        return {s.stem: _loaded[s.stem] for s in sources}


def ptxas_usage(report: str) -> dict[str, dict]:
    """Registers, stack and spill bytes per kernel from ``-Xptxas -v``."""
    usage: dict[str, dict] = {}
    kernel = None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            kernel = m.group(1)
            usage[kernel] = {}
            continue
        if kernel is None:
            continue
        m = re.search(
            r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
            r"(\d+) bytes spill loads",
            line,
        )
        if m:
            usage[kernel].update(
                stack_bytes=int(m.group(1)),
                spill_store_bytes=int(m.group(2)),
                spill_load_bytes=int(m.group(3)),
            )
        m = re.search(r"Used (\d+) registers", line)
        if m:
            usage[kernel]["registers"] = int(m.group(1))
    return usage
