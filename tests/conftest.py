"""Test configuration: run on CPU with 8 virtual devices.

Multi-device sharding tests run on a virtual CPU mesh
(xla_force_host_platform_device_count), so mesh behavior is testable
without accelerators.  The platform is forced before any JAX use.
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8"
)

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


@pytest.fixture(scope="session")
def golden():
    path = os.path.join(os.path.dirname(__file__), "golden", "reference.npz")
    if not os.path.exists(path):
        pytest.skip("golden fixtures missing; run tools/gen_golden.py")
    return np.load(path)


@pytest.fixture(scope="session")
def golden_raw():
    """The shipped 10-packet golden vector (reference:
    preamble_qpsk_8k.raw, verified structure SURVEY.md C12)."""
    path = "/root/reference/preamble_qpsk_8k.raw"
    if not os.path.exists(path):
        pytest.skip("reference golden raw not mounted")
    return np.fromfile(path, dtype="<i2")
