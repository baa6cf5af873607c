"""Test configuration: force an 8-device virtual CPU mesh.

The tests run on the CPU: the deposit kernel in Pallas interpret mode and
the sharding tests on XLA's host-platform device virtualization (SURVEY.md
section 4).  Must run before jax is imported anywhere.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

# Set the platform through the config API as well, so that an installed GPU
# plugin cannot claim the tests.
jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

assert jax.default_backend() == "cpu", "tests must run on CPU"
assert len(jax.devices()) == 8, "tests expect an 8-device virtual CPU mesh"


@pytest.fixture
def rng():
    return np.random.default_rng(20260817)
