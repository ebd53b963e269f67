"""Tests that need a CUDA GPU: the fused kernel as compiled for the card.

They skip elsewhere; on a GPU host run them with
``JAX_PLATFORMS=cuda,cpu python -m pytest tests/test_gpu.py -m gpu``.
The CPU suite covers the same arithmetic through the Pallas interpreter
(tests/test_ops.py::TestModelKernel).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from test_ops import _fit, _kernel_inputs, _kernel_reference, _thetas

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("n_walkers,n_stars", [(13, 1000), (4099, 10_001)])
def test_kernel_compiled_for_the_card(gpu, n_walkers, n_stars):
    from mcmc_dynamics_jax.ops import model_lnlike_batched

    params, dxm, dym, r2, v, verr2 = _kernel_inputs(n_walkers, n_stars, seed=1)
    mask = np.ones(n_stars)
    mask[-3:] = 0.0
    args = [jax.device_put(np.asarray(a, np.float32), gpu)
            for a in (params, dxm, dym, r2, v, verr2, mask)]
    got = np.asarray(model_lnlike_batched(*args))
    expected = _kernel_reference(params, dxm, dym, v, verr2, mask)
    # float32 sums of ~1e4 terms of magnitude ~3
    np.testing.assert_allclose(got, expected, rtol=2e-6)


def test_direct_tier_lowers_the_kernel(gpu):
    fit = _fit("modelfit", n=1001)
    with jax.default_device(gpu):
        thetas = jnp.asarray(_thetas(fit, 64, np.random.default_rng(0)),
                             jnp.float32)
        text = jax.jit(fit.build_lnprob_batched()).lower(thetas).as_text()
    assert "model_lnlike" in text
