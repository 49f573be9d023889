"""Test configuration: force a virtual 8-device CPU mesh before JAX use.

Tests run on the local CPU backend (`JAX_PLATFORMS=cpu`), even on a host
with a GPU: what runs only on the GPU is a phase of chip_smoke.py, not a
test. The config is pinned here — conftest runs before any test imports,
and no jax backend has been initialized yet at this point.

The 8 virtual devices match the multi-device dry-run
(`xla_force_host_platform_device_count=8`) so sharding tests run without
8 real devices.
"""

import os
import sys

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import gc  # noqa: E402

import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _bound_xla_compile_state():
    """Keep per-worker XLA:CPU compiler state bounded.

    A single long-lived xdist worker accumulates enough compiler state over
    ~100 tests to segfault inside backend_compile (deterministic at -n 4 on
    the VIO modules when they run after a long prefix). Dropping JAX's
    in-memory executable caches at every module teardown keeps each process
    under the threshold; the persistent on-disk compilation cache
    (sos_slam_tpu/__init__.py) makes any re-warm a cheap load instead of a
    recompile."""
    yield
    jax.clear_caches()
    gc.collect()
