"""The port's native libraries: how a ``.cu`` or ``.cpp`` becomes a typed,
described library that Python calls.

Every native library of the port (the host C++ library and the CUDA
kernels) is declared as a :class:`Library`: its name, compiler command,
sources, headers and entry points.  It is compiled at its first
:meth:`Library.load`, into a file whose name carries a hash of the command
and of every source and header it names, so an edited file is never served
from a stale library.  Concurrent builds (pytest-xdist workers, threads)
serialise on a file lock, and the library appears under its final name
only through ``os.replace``, so no process ever loads a half-written file.
What the compiler printed on a successful build is kept beside the
library (:func:`read_log`): with ``-Xptxas -v``, each kernel's registers,
spills and shared memory (:func:`parse_ptxas`, :meth:`Library.ptxas`).
The entry points return 0 or an error code, which :func:`check` turns into
an exception naming the kernel.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import re
import shutil
import subprocess
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
#: nvcc flags of every CUDA kernel of the port: Hopper only, plain C ABI.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

#: The entry points' own return codes (``ERR_*`` in ``csrc/hopper.cuh``);
#: CUDA's errors are positive.
ERRORS = {-1: "tile plan refused", -2: "no cuTensorMapEncodeTiled in the "
          "driver", -3: "tensor map refused"}


def nvcc() -> str:
    """Path of nvcc; raises if there is none (the kernels cannot be built)."""
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def cuda(*flags: str) -> Callable[[], List[str]]:
    """The compiler command of a CUDA library: nvcc, found when the library
    is built, with :data:`NVCC_FLAGS` and ``flags``."""
    return lambda: [nvcc(), *NVCC_FLAGS, *flags]


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


def parse_ptxas(log: str) -> dict:
    """{mangled kernel name: {"registers", "spill_bytes", "smem_static"}}
    from ``ptxas -v`` output."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for)"
                      r" '?([\w$]+)'?", line)
        if m:
            name = m.group(1)
            out.setdefault(name, {"registers": None, "spill_bytes": 0,
                                  "smem_static": 0})
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[name]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            out[name]["smem_static"] = int(m.group(1)) if m else 0
    return out


def check(err: int, kernel: str) -> None:
    """Raises unless ``err``, an entry point's return code, is 0."""
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: "
                           f"{ERRORS.get(err, f'CUDA error {err}')}")


#: An entry point's ctypes types: (restype, argtypes).
Signature = Tuple[Optional[type], Sequence[type]]


class Library:
    """A native library of the port, built and opened at the first
    :meth:`load` and kept for the life of the process.

    ``compiler`` returns the compiler command (called only when the library
    is built, so a module that declares a CUDA library imports without
    nvcc); ``sources`` are compiled, ``deps`` (headers they include) only
    hashed; ``functions`` maps each entry point to its :data:`Signature`.
    Each library has its own lock, so several build at once on threads."""

    def __init__(self, name: str, compiler: Callable[[], List[str]],
                 sources: Sequence[str], deps: Sequence[str] = (), *,
                 functions: Dict[str, Signature]):
        self.name = name
        self.compiler = compiler
        self.sources = list(sources)
        self.deps = list(deps)
        self.functions = dict(functions)
        #: Where the library was built; None before the first :meth:`load`.
        self.path: Optional[str] = None
        self._lock = threading.Lock()
        self._lib: Optional[ctypes.CDLL] = None

    def load(self) -> ctypes.CDLL:
        """The library, built on first use, its entry points typed.  Raises
        if it cannot be built or opened."""
        with self._lock:
            if self._lib is None:
                path = build_shared(self.name, self.compiler(), self.sources,
                                    self.deps)
                lib = ctypes.CDLL(path)
                for fn, (restype, argtypes) in self.functions.items():
                    entry = getattr(lib, fn)
                    entry.restype, entry.argtypes = restype, list(argtypes)
                self._lib, self.path = lib, path
            return self._lib

    def ptxas(self) -> dict:
        """:func:`parse_ptxas` of the library's kept build log (built
        first if it is not yet)."""
        self.load()
        return parse_ptxas(read_log(self.path))

    def instantiations(self, template: str) -> List[tuple]:
        """[(template arguments, ptxas info)] for each instantiation of the
        kernel template ``template`` in :meth:`ptxas`, the arguments in the
        template's order, ``int`` and ``bool`` as mangled (``Li64E``,
        ``Lb1E``)."""
        out = []
        for name, info in self.ptxas().items():
            m = re.search(re.escape(template) + r"I((?:L[ib]\d+E)+)E", name)
            if m:
                out.append((tuple(int(v) if t == "i" else v == "1"
                                  for t, v in re.findall(r"L([ib])(\d+)E",
                                                         m.group(1))),
                            info))
        return out
