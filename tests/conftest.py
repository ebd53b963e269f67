"""Test configuration: run JAX on a virtual 8-device CPU mesh with float64.

Multi-device sharding paths are exercised without accelerators by forcing the
host platform to expose 8 devices; float64 gives the numerical headroom for
posterior parity checks (on a GPU the library runs float32 — see
mcmc_dynamics_jax.default_dtype).  Tests that need a GPU carry the ``gpu``
marker and skip here (see the ``gpu`` fixture).
"""

import os

# CPU unless the caller names platforms: unit tests run hermetically on the
# virtual CPU mesh even on a host with a GPU; the gpu-marked tests run with
# JAX_PLATFORMS=cuda,cpu (README).
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
os.environ["JAX_ENABLE_X64"] = "1"

import jax  # noqa: E402  (import after env setup)
import pytest  # noqa: E402

# again after import, in case jax was imported before this file ran
jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu():
    """The first CUDA device; skips the test where there is none.  Decided
    here, when the test runs, so every worker collects the same tests."""
    try:
        devices = jax.devices("gpu")
    except RuntimeError:
        devices = []
    if not devices:
        pytest.skip("needs a CUDA GPU: run with JAX_PLATFORMS=cuda,cpu")
    return devices[0]
