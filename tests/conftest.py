"""Test configuration: run everything on the CPU with 8 virtual devices.

The tests run with `JAX_PLATFORMS=cpu`; `--xla_force_host_platform_device_count=8`
gives the CPU backend eight devices, so the multi-device sharding logic
runs without a card.  The backend initialises lazily, so the
`jax.config.update` below wins even when jax was imported earlier.

Checks that need the GPU are phases of `chip_smoke.py` (run on the card
with `python chip_smoke.py`, and `python chip_smoke.py --multi` on four
cards).  A test that needs the card takes the `gpu` marker and the
`gpu_device` fixture, which skips it when JAX finds no GPU.
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

# Persistent compilation cache (same directory rule as the CLI and
# bench.py): the suite is compile-dominated, and entries are keyed on the
# serialized HLO + compile options, so edits that change a program never
# hit a stale entry.
from pf_monocular_pose_estimator_tpu.utils.compile_cache import (  # noqa: E402
    enable_persistent_cache,
)

enable_persistent_cache()


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test when JAX finds none.  Decided
    here, at run time, never while a module is imported."""
    try:
        devices = jax.devices("gpu")
    except RuntimeError:
        devices = []
    if not devices:
        pytest.skip("needs an NVIDIA GPU (run chip_smoke.py on the card)")
    return devices[0]
