"""Test configuration: a virtual 8-device CPU mesh, and the GPU marker.

Distribution tests run on 8 virtual CPU devices (SURVEY.md §4's multi-host
test strategy) unless JAX_PLATFORMS names another platform.  Tests marked
`gpu` run a kernel compiled for the card (a Triton kernel has no
interpreter there); their `gpu` fixture skips them on any other device.
On a GPU machine: JAX_PLATFORMS=cuda python -m pytest -m gpu tests/
"""

import os

import pytest

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("JAX_ENABLE_X64", "0")


@pytest.fixture
def gpu():
    """Skip unless JAX's first device is a GPU (decided at run time)."""
    import jax
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU: runs the compiled Triton kernel")
