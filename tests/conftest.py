"""Test config: run on the CPU with 8 virtual devices so the sharding tests
work without multi-device hardware (SURVEY.md §4: sharded == single-device
tests). ``XLA_FLAGS`` must be set before the CPU backend initializes (it is
read lazily at first device query).

Tests marked ``gpu`` need a GPU: the ``gpu_backend`` fixture skips them
anywhere else. ``chip_smoke.py`` runs them on the card inside its own
process, with ``OCDP_TEST_PLATFORM=gpu`` so this file leaves the backend
alone.
"""

import os

import pytest

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if os.environ.get("OCDP_TEST_PLATFORM") != "gpu":
    jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def gpu_backend():
    """The GPU device, or a skip where there is none (decided per test,
    never at import: every worker must collect the same tests)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU; chip_smoke.py runs these on the card")
    return jax.devices()[0]
