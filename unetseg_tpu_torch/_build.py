"""Build a shared library from sources at first use, once per content.

Every native library of the port (the host C++ library and the CUDA
kernels) is compiled here: the output name carries a hash of the command and
of every source and header it names, so an edited file is never served from
a stale library.
Concurrent builds (pytest-xdist workers, threads) serialise on a file
lock, and the library appears under its final name only through
``os.replace``, so no process ever loads a half-written file.  What the
compiler printed on a successful build is kept beside the library
(:func:`read_log`), for flags such as ``-Xptxas -v``.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import shutil
import subprocess
from typing import Sequence

BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
#: nvcc flags of every CUDA kernel of the port: Hopper only, plain C ABI.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]


def nvcc() -> str:
    """Path of nvcc; raises if there is none (the kernels cannot be built)."""
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def build_shared(name: str, compiler: Sequence[str], sources: Sequence[str],
                 deps: Sequence[str] = (), timeout: float = 600.0) -> str:
    """Compile ``sources`` with ``compiler + sources + ["-o", out]`` into
    ``BUILD_DIR`` and return the library's path.  ``deps`` are files the
    sources include: they are hashed with the sources but not passed to the
    compiler.  Raises on failure with the compiler's output."""
    h = hashlib.sha256(" ".join(compiler).encode())
    for src in (*sources, *deps):
        with open(src, "rb") as f:
            h.update(f.read())
    out = os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, f"{name}.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if os.path.exists(out):  # another process built it meanwhile
                return out
            tmp = f"{out}.{os.getpid()}.tmp"
            proc = subprocess.run([*compiler, *sources, "-o", tmp],
                                  capture_output=True, text=True,
                                  timeout=timeout)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"building {name} failed ({' '.join(compiler)}):\n"
                    f"{proc.stdout}\n{proc.stderr}")
            with open(f"{out}.log", "w") as f:
                f.write(proc.stdout + proc.stderr)
            os.replace(tmp, out)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return out


def read_log(library: str) -> str:
    """What the compiler printed when ``library`` (a path returned by
    :func:`build_shared`) was built; empty if nothing was kept."""
    try:
        with open(f"{library}.log") as f:
            return f.read()
    except FileNotFoundError:
        return ""
