"""Builds the JAX package's host library before pytest imports any test.

``unetseg_tpu/io/native.py`` runs ``make -C csrc`` at its first load with
no lock between processes, and several test modules call
``native.available()`` when they are imported.  Under pytest-xdist every
worker collects every file, so on a fresh checkout the workers race to
build ``csrc/libunetseg_host.so``, and a worker that loads the file while
another's linker still writes it skips those modules' tests.

pytest loads this file, the conftest of the rootdir, in the xdist
controller and in each worker before it collects a test module.  Importing
``tests/test_torch_port_native_ready.py`` here builds the library under its
file lock and loads it through the JAX binding, so every later
``native.available()`` finds it loaded.  This file does nothing else.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "tests"))

import test_torch_port_native_ready  # noqa: E402,F401 (builds at import)
