"""Fused walker x star ModelFit likelihood, written for the GPU (Pallas, Triton).

The sampler's inner cost is, per ensemble half-step, a (W/2, N) grid of per-star
Gaussian log-likelihood terms reduced over stars.  XLA fuses the plain
``lnlike_terms`` vmap into one reduction, so no (W, N) temporary reaches device
memory either way; what the kernel changes is the arithmetic per (walker, star)
pair.  The plain form pays a ``pow`` (log + exp), a ``log`` and two divides per
pair on the special-function units; the kernel below pays two ``rsqrt`` and a
quarter of a ``log`` (the log-determinant is summed through products of four
stars), which matters on a card whose transcendental rate is an eighth of its
FMA rate.

Layout: one program per tile of ``walker_tile`` walkers; inside it a loop over
the catalog in spans of four ``star_chunk`` sub-chunks.  A block cannot carry a
sum to another block on the GPU, so the star reduction stays inside the program
and each walker's sum is written once.  The (8, N) star table is a few hundred
kB at survey sizes and stays resident in L2 across programs.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp

__all__ = ["model_lnlike_batched"]

_LOG_2PI = math.log(2.0 * math.pi)


@functools.partial(jax.jit, static_argnames=("walker_tile", "star_chunk",
                                             "interpret"))
def model_lnlike_batched(params, dxm, dym, r2, v, verr2, mask,
                         walker_tile: int = 16, star_chunk: int = 64,
                         interpret: bool = False):
    """Fused (W, 6)-params x N-star ModelFit log-likelihood -> (W,).

    ``params`` columns (the canonical free layout of model.json):
    (v_sys, sigma_max, a, v_maxx, v_maxy, r_peak); offsets/radii precomputed in
    arcmin for a fixed centre.  Per star (reference model.py:93-180):

        v_los   = v_sys + 2 (dym vx - dxm vy) / (r_peak (1 + r^2/r_peak^2))
        sigma^2 = sigma_max^2 / sqrt(1 + r^2/a^2)
        term    = log(2 pi n) + (v - v_los)^2 / n,  n = verr^2 + sigma^2

    ``walker_tile`` and ``star_chunk`` must be powers of two (Triton blocks).
    ``interpret=True`` runs the kernel through the Pallas interpreter (CPU).
    """
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu

    for name, size in (("walker_tile", walker_tile), ("star_chunk", star_chunk)):
        if size < 1 or size & (size - 1):
            raise ValueError(f"{name} must be a power of two (got {size}).")
    dtype = params.dtype
    n_walkers, n_stars = params.shape[0], v.shape[0]
    span = 4 * star_chunk            # stars per loop step (products of four)
    zeros = jnp.zeros_like(v)
    # rows 6-7 pad the table to a power-of-two row count; padded star lanes
    # carry mask 0 and are selected away inside the kernel
    stars = jnp.stack([dxm, dym, r2, v, verr2, mask, zeros, zeros]).astype(dtype)
    stars = jnp.pad(stars, ((0, 0), (0, (-n_stars) % span)))
    w_pad = (-n_walkers) % walker_tile
    if w_pad:
        params = jnp.concatenate(
            [params, jnp.broadcast_to(params[:1], (w_pad, params.shape[1]))])
    cols = jnp.pad(params.T, ((0, 8 - params.shape[1]), (0, 0)))   # (8, W)
    n_spans = stars.shape[1] // span

    def kernel(p_ref, s_ref, out_ref):
        v_sys = p_ref[0, :][:, None]                  # (TW, 1)
        sigma = p_ref[1, :][:, None]
        a = p_ref[2, :][:, None]
        vx2 = 2.0 * p_ref[3, :][:, None]
        vy2 = 2.0 * p_ref[4, :][:, None]
        r_peak = p_ref[5, :][:, None]
        sigma2 = sigma * sigma
        inv_a2 = 1.0 / (a * a)
        inv_rp = 1.0 / r_peak

        def body(c, acc):
            norm_prod = None
            for k in range(4):
                sl = pl.ds((4 * c + k) * star_chunk, star_chunk)
                dx_c = s_ref[0, sl][None, :]          # (1, SC)
                dy_c = s_ref[1, sl][None, :]
                r2_c = s_ref[2, sl][None, :]
                v_c = s_ref[3, sl][None, :]
                e2_c = s_ref[4, sl][None, :]
                live = s_ref[5, sl][None, :] > 0
                # v_los - v = v_sys - v + (2 dy vx - 2 dx vy) / q,
                # q = rp + r2/rp; one rsqrt replaces the divide:
                # (v_los - v)^2 / n = (q (v_sys - v) + num)^2 / (q^2 n)
                q = r_peak + r2_c * inv_rp
                d = q * (v_sys - v_c) + (dy_c * vx2 - dx_c * vy2)
                norm = e2_c + sigma2 * jax.lax.rsqrt(1.0 + r2_c * inv_a2)
                t = d * jax.lax.rsqrt(q * q * norm)
                # select(), not multiply: a padded lane (verr2 = r2 = 0) with
                # a prior-legal boundary walker (sigma_max = 0) gives
                # rsqrt(0) = inf, and inf * mask(0) = NaN
                acc = acc + jnp.where(live, t * t, 0.0)
                nm = jnp.where(live, norm, 1.0)
                norm_prod = nm if norm_prod is None else norm_prod * nm
            # sum of log n over four stars as one log; safe while n^4 stays in
            # f32 range (sigma <~ 1e4 km/s)
            return acc + jnp.log(norm_prod)

        acc = jax.lax.fori_loop(0, n_spans, body,
                                jnp.zeros((walker_tile, star_chunk), dtype))
        out_ref[...] = jnp.sum(acc, axis=1)

    out = pl.pallas_call(
        kernel,
        grid=(cols.shape[1] // walker_tile,),
        in_specs=[pl.BlockSpec((8, walker_tile), lambda i: (0, i)),
                  pl.BlockSpec((8, stars.shape[1]), lambda i: (0, 0))],
        out_specs=pl.BlockSpec((walker_tile,), lambda i: (i,)),
        out_shape=jax.ShapeDtypeStruct((cols.shape[1],), dtype),
        # 2 warps measured fastest with 16 x 64 tiles on an H100; num_stages
        # 1-3 made no difference (PERF.md)
        compiler_params=plgpu.CompilerParams(num_warps=2, num_stages=1),
        interpret=interpret,
        name="model_lnlike",
    )(cols, stars)
    return -0.5 * (out[:n_walkers] + jnp.sum(mask > 0).astype(dtype) * _LOG_2PI)

