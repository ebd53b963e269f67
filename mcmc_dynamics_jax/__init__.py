"""mcmc_dynamics_jax — a Bayesian stellar-kinematics framework in JAX.

JAX/XLA implementation of the capabilities of the reference package
``skamann/mcmc-dynamics``: deriving the internal kinematics of star clusters (rotation
amplitude & axis, dispersion profile, field-star contamination, cluster centre/elongation,
axisymmetric Jeans/JAM models) from per-star radial-velocity catalogs.

Architecture (accelerator-first, not a port):

* likelihoods are pure functions ``lnlike(theta, data)`` vmapped over walkers;
* the affine-invariant ensemble sampler runs natively inside ``lax.scan`` so thousands
  of walkers advance per XLA step (the reference drives ``emcee`` through a fork-based
  process pool, one Python callback per walker proposal);
* hot star-catalog reductions can run as fused kernels over device-resident data;
* multi-device runs shard walkers/stars/bins over a device mesh with ``psum``'d
  log-probabilities (see ``mcmc_dynamics_jax.parallel``).
"""

from . import units
from .parameters import Parameter, Parameters, CompiledParameters

__version__ = "0.4.0"

__all__ = [
    "units", "Parameter", "Parameters", "CompiledParameters",
]


def default_dtype():
    """Preferred floating dtype: float64 when x64 is enabled (CPU tests/parity),
    float32 otherwise (accelerator throughput)."""
    import jax
    import jax.numpy as jnp
    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32


def configure_compile_cache() -> str:
    """Point JAX's persistent compilation cache at a fixed directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already uses it and nothing
    is changed.  Otherwise the cache lives in ``.jax_cache/`` beside the
    package (the repository root): a fixed path, because the path is part of
    the cache key.  Returns the directory in use."""
    import os
    import pathlib

    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = str(pathlib.Path(__file__).resolve().parents[1] / ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
