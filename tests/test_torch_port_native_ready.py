"""Both packages' host libraries are built and loaded before any test runs.

The JAX package builds ``csrc/libunetseg_host.so`` with ``make -C csrc`` at
its first ``native.load()``, without a lock between processes, and
remembers a failed load for the life of the process.  Under pytest-xdist
every worker collects every test file, and several test modules call
``native.available()`` at import: on a fresh checkout the workers then run
``make`` at once, and a worker that loads a library another worker's
linker is still writing keeps ``_load_failed`` set, so every later test of
that worker that needs the library fails.

Importing this module (each worker does, while it collects) takes a file
lock beside ``csrc/``, builds the library until it loads (``make -B`` on a
retry, in case a partial file was left behind), clears the JAX binding's
cached failure and loads it again.  Port tests that call the JAX binding
ask for it through the ``jax_native`` fixture, which repeats that repair
if the cached state went bad since.
"""

import ctypes
import fcntl
import os
import subprocess
import time

import pytest

from unetseg_tpu.io import native as jax_native_mod
from unetseg_tpu_torch.io import native

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
LIB = os.path.join(CSRC, "libunetseg_host.so")
LOCK = os.path.join(CSRC, "libunetseg_host.lock")
ATTEMPTS = 5


def _loads(path: str) -> bool:
    try:
        ctypes.CDLL(path)
    except OSError:
        return False
    return True


def ensure_jax_native():
    """The JAX binding's loaded library, built under a file lock if need
    be; raises if it cannot be built and loaded."""
    if jax_native_mod._lib is not None:
        return jax_native_mod._lib
    with open(LOCK, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            for attempt in range(ATTEMPTS):
                if os.path.exists(LIB) and _loads(LIB):
                    break
                # a library left half-written by an unlocked build (another
                # process's native.load) is rebuilt
                subprocess.run(["make", "-C", CSRC] + (["-B"] if attempt
                                                        else []),
                               capture_output=True, timeout=300)
                time.sleep(0.2 * attempt)
            else:
                raise RuntimeError(f"{LIB} does not build and load")
            with jax_native_mod._lock:
                jax_native_mod._lib = None
                jax_native_mod._load_failed = False
            lib = jax_native_mod.load()
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    if lib is None:
        raise RuntimeError(f"{LIB} loads, but not through the JAX binding")
    return lib


ensure_jax_native()


@pytest.fixture(scope="module")
def one_torch_thread():
    """One torch CPU thread for a module's tests: the xdist workers share
    the machine's cores, and at small shapes a thread pool per worker
    costs more in handoffs than it computes."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def jax_native():
    """The JAX package's ``io.native`` with its library loaded."""
    ensure_jax_native()
    return jax_native_mod


def test_both_host_libraries_load(jax_native):
    assert jax_native.available() and jax_native.emit_slice_available()
    assert native.load() is not None and native.emit_slice_available()
    for lib in (jax_native.load(), native.load()):
        assert hasattr(lib, "utpu_emit_batch")
        assert hasattr(lib, "utpu_postprocess_packed_batch")
