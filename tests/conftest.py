"""Test configuration: run the whole suite on a virtual 8-device CPU mesh.

Multi-device logic is validated without accelerators via
``--xla_force_host_platform_device_count`` (SURVEY.md §4); the driver's
``dryrun_multichip`` does the same.  jax may already be imported (with
another platform chosen) before any conftest code runs, so the platform
override goes through ``jax.config`` rather than env vars.
"""

import os

import jax

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture()
def rng():
    # fresh, fixed-seed generator per test: results don't depend on
    # which other tests ran first
    return np.random.default_rng(12345)
