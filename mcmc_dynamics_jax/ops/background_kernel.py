"""Blocked log-sum-exp for the SingleStars background population.

The SingleStars field-star model evaluates, for each of N target stars, a KDE over M
background-catalog velocities (reference single_stars.py:72-77):

    lnlike_i = log[(1/M) sum_j exp(-(v_i - v_j)^2 / (2 n_i)) / sqrt(2 pi n_i)],
    n_i = verr_i^2 + sigma_int^2

— an (N x M) pairwise kernel, the one quadratic cost in the framework.  It runs once,
when a fit is built.  The catalog is cut into blocks of ``catalog_chunk`` stars and
``lax.map`` walks them, keeping per block only the running maximum exponent and the
sum rescaled to it, so no more than one (catalog_chunk x N) block is ever live.  The
block results are then combined by the same max-and-rescale rule.
"""

from __future__ import annotations

import functools
import math

import numpy as np

import jax
import jax.numpy as jnp

__all__ = ["background_logsumexp"]


def background_logsumexp(v_catalog, v, verr, sigma_int=0.0,
                         catalog_chunk: int = 1024):
    """Per-target-star background log-likelihoods, on the default device.

    v_catalog: (M,) background velocities; v, verr: (N,) targets.
    Exact (up to float reduction order) match of the NumPy implementation.
    """
    if np.size(v_catalog) == 0:
        raise ValueError(
            "Empty background catalog: the KDE log-likelihood is undefined "
            "(did the field-star selection match no stars?).")
    return _blocked_logsumexp(v_catalog, v, verr, sigma_int,
                              catalog_chunk=catalog_chunk)


@functools.partial(jax.jit, static_argnames=("catalog_chunk",))
def _blocked_logsumexp(v_catalog, v, verr, sigma_int, catalog_chunk: int):
    dtype = jnp.result_type(jnp.asarray(v).dtype, jnp.float32)
    v = jnp.asarray(v, dtype)
    verr = jnp.asarray(verr, dtype)
    v_catalog = jnp.asarray(v_catalog, dtype)
    m = v_catalog.shape[0]

    # pad with +inf velocities: exp(-inf) = 0 contribution
    v_catalog = jnp.concatenate(
        [v_catalog, jnp.full((-m) % catalog_chunk, jnp.inf, dtype)])
    blocks = v_catalog.reshape(-1, catalog_chunk)
    norm = sigma_int * sigma_int + verr * verr                 # (N,)

    def block(vc):
        expo = -(vc[:, None] - v[None, :]) ** 2 / (2.0 * norm)  # (C, N)
        top = jnp.max(expo, axis=0)
        # a block with no finite exponent contributes nothing; keep its
        # reference point finite so the rescale below stays NaN-free
        safe = jnp.where(jnp.isfinite(top), top, 0.0)
        return top, jnp.sum(jnp.exp(expo - safe), axis=0)

    tops, sums = jax.lax.map(block, blocks)                   # (B, N) each
    peak = jnp.max(tops, axis=0)
    scale = jnp.exp(jnp.where(jnp.isfinite(tops), tops - peak, -jnp.inf))
    total = jnp.sum(sums * scale, axis=0)
    return (peak + jnp.log(total) - 0.5 * jnp.log(2.0 * jnp.pi * norm)
            - math.log(m))
