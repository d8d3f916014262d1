"""Test config: run everything on an 8-virtual-device CPU backend.

Mesh/sharding logic is validated on a virtual CPU mesh
(``xla_force_host_platform_device_count=8``) per SURVEY.md §4's multi-device
strategy; the GPU paths are exercised by ``python chip_smoke.py`` (one
card) and ``python chip_smoke.py --four-cards``. Env vars must be set
before jax initializes a backend; ``jax.config`` is set as well so an
outer environment cannot select another platform.
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
).strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(815)


@pytest.fixture(scope="session")
def eight_devices():
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 virtual devices")
    return devs
