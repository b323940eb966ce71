"""Test harness configuration.

Tests run on the JAX CPU backend (the "fake device" of SURVEY.md §4) with an
8-device virtual topology so every mesh/sharding path is exercised without
TPU hardware.  Must run before `import jax`.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Plugins (e.g. jaxtyping's) may import jax before this conftest runs, in
# which case the env var was read too late — force the platform through the
# config as well (valid until backends are initialized).
import jax

jax.config.update("jax_platforms", "cpu")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips on a host without one")
