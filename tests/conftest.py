"""Test config: run everything on a virtual 8-device CPU mesh so sharding
code paths are exercised without accelerator hardware."""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
os.environ["JAX_PLATFORMS"] = "cpu"

# Pin the platform before first backend use, even if jax was imported
# already.
import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: full-dataset parity tier (minutes; run in CI)")


@pytest.fixture(autouse=True, scope="module")
def _bound_compiled_programs():
    """Clear JAX's compiled-program caches between test modules.

    The whole suite compiles hundreds of distinct program shapes; letting
    them accumulate in one process crashed XLA CPU compilation deep into
    the run (observed as a deterministic segfault at
    test_simple_tier[read_len200_mm] when everything ran in one process).
    Per-module clearing bounds live compiled-program memory while keeping
    intra-module reuse (the expensive tier modules compile-share heavily
    within themselves)."""
    yield
    jax.clear_caches()


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(12345)


@pytest.fixture(scope="session")
def lambda_fasta():
    return "/root/reference/example/reference/lambda_virus.fa"
