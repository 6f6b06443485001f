"""Build the CUDA sources under ``csrc/`` with nvcc and load them.

Each ``csrc/<name>.cu`` has a plain C interface (``extern "C"``
launchers that return ``cudaGetLastError()``), so it compiles in
seconds without PyTorch's headers and is loaded with :mod:`ctypes`.

The shared library is built at first use into ``build/torch_kernels/``
at the repository root, named by a hash of the source, the headers it
includes from ``csrc/`` (``#include "x.cuh"``, followed recursively) and
the flags, so a changed source or header is rebuilt and an unchanged one
is reused. nvcc's resource report (``-Xptxas -v``) is kept beside it as
``<lib>.log``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def find_nvcc() -> str:
    """nvcc on ``PATH``, else under ``$CUDA_HOME/bin`` (default
    ``/usr/local/cuda``); raises if neither has it."""
    nvcc = shutil.which("nvcc")
    if nvcc:
        return nvcc
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError(
        "nvcc not found on PATH or under $CUDA_HOME/bin; the CUDA "
        "kernels of this package need the CUDA toolkit"
    )


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def sources(name: str) -> list:
    """``csrc/<name>.cu`` and the ``csrc/`` headers it includes with
    quotes, directly or through another header, in a fixed order."""
    seen, todo = [], [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        for inc in _INCLUDE.findall(path.read_bytes()):
            todo.append(path.parent / inc.decode())
    return seen


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless the build of its current source
    and headers exists; returns the shared library's path."""
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256()
    for path in sources(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    out = BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed on {name}.cu (exit {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}"
        )
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    return out


def build_all(names) -> dict:
    """:func:`build` of several sources at once, one nvcc process each,
    all started together; returns ``{name: path}`` or raises the first
    failure."""
    names = list(names)
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        return dict(zip(names, pool.map(build, names)))


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``."""
    return ctypes.CDLL(str(build(name)))
