"""O(1)-per-walker ConstantFit likelihood via exact sufficient statistics.

The single-bin likelihood (reference constant.py:113-154 + runner.py:260-271) is

    lnL(theta) = -0.5 sum_i [ log(2 pi n_i) + (v_i - v_sys - gx_i vx - gy_i vy)^2 / n_i ],
    n_i = verr_i^2 + s,   s = sigma_max^2,

which is *quadratic* in c = (v_sys, vx, vy) with weights w_i(s) = 1/n_i.  Expanding,

    lnL = -0.5 [ F(s) + M0(s) - 2 c . M1(s) + c^T M2(s) c ] - (N/2) log(2 pi)

with F(s) = sum_i log n_i and the weighted moments
M0 = sum w v^2, M1 = sum w v u, M2 = sum w u u^T, u_i = (1, gx_i, gy_i) —
eleven scalar functions of s ONLY.  In the log variable t = log(s + E_min)
(E_min = min verr_i^2, the same pole-shift as ops/model_sufficient.py) each
channel is analytic on the sampling interval with its singularity lattice a
distance ~pi off the real axis, so a single global **Chebyshev** series of
degree sized from the pole geometry evaluates all eleven to the dtype's
useful truncation level.  Per-walker cost is ~11 D flops of pure FMA with NO
table gathers.

A cubic-Hermite lookup table (2048 log-spaced nodes, exact derivative
endpoints) is numerically equivalent (~1e-9 relative) but needs four row
gathers per walker; the Chebyshev form is pure FMA work.

This is the production path for the reference's binned-fit workload
(bin/run.py:186-189: thousands of small ConstantFit posteriors): the star catalog
is touched ONCE to build the tables; sampling never re-reads it.  ``build`` is
trace-compatible (pipelines.py constructs per-bin tables inside one jitted
program) provided ``n_coef`` is passed statically.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np

import jax
import jax.numpy as jnp

__all__ = ["ConstantSufficientStats", "chebyshev_degree"]

_LOG_2PI = math.log(2.0 * math.pi)


def chebyshev_degree(e_min: float, s_max: float, dtype) -> int:
    """Chebyshev degree for the eleven channels from the pole geometry.

    In t = log(S + e_min) the channel singularities sit a distance ~pi off
    the real interval of half-length L, giving the convergence factor
    rho = eta + sqrt(1 + eta^2), eta = pi/L (ops/model_sufficient.py uses the
    identical sizing).  Degree targets 1e-6 truncation in float32 (at the f32
    evaluation floor; more terms are dead weight) and 1e-12 in float64
    (compatible with the tier's documented ~1e-9-exact contract).
    """
    is_f64 = jnp.dtype(dtype) == jnp.float64
    off = max(float(e_min), 1e-12)
    half_len = 0.5 * (math.log(s_max + off) - math.log(off))
    eta = math.pi / max(half_len, 1e-6)
    rho = eta + math.sqrt(1.0 + eta * eta)
    trunc = 1e12 if is_f64 else 1e6
    needed = math.ceil(math.log(trunc) / math.log(rho))
    cap = 160 if is_f64 else 96
    if needed > cap:
        import logging
        logging.getLogger(__name__).warning(
            "ConstantFit sufficient tier: Chebyshev degree capped at %d (pole "
            "geometry wants %d for %.0e truncation; expect ~%.0e relative "
            "instead).  Tighten the sigma_max prior or raise the minimum "
            "velocity error.", cap, needed, 1.0 / trunc, rho ** -cap)
    return int(np.clip(needed, 16, cap))


class ConstantSufficientStats(NamedTuple):
    """Chebyshev tables of the eleven moment channels over t = log(s + offset)."""

    coeffs: jnp.ndarray      # (D, 11)
    t_lo: jnp.ndarray        # scalar: log(offset)
    t_hi: jnp.ndarray        # scalar: log(s_max + offset)
    offset: jnp.ndarray      # scalar: E_min pole-shift
    n_stars: jnp.ndarray     # effective (masked) star count

    @classmethod
    def build(cls, gx, gy, v, verr2, mask=None, n_coef: Optional[int] = None,
              s_max: float = 1.0e6,
              star_chunk: int = 16384) -> "ConstantSufficientStats":
        """Precompute the moment tables from the star catalog.

        The star axis is processed in chunks under ``lax.scan`` so the
        (n_coef x N_stars) weight matrix never materialises — catalogs of
        10^6+ stars build in bounded memory.  ``n_coef=None`` sizes the degree
        from the pole geometry and requires concrete (non-traced) ``verr2``;
        in-jit callers must pass a static ``n_coef`` (see pipelines.py).
        """
        gx = jnp.asarray(gx)
        dtype = gx.dtype
        gy = jnp.asarray(gy, dtype)
        v = jnp.asarray(v, dtype)
        verr2 = jnp.asarray(verr2, dtype)
        # binarise: documented membership (0/1) semantics — fractional masks
        # would silently re-weight the quadratic and log-det channels
        m = jnp.ones_like(v) if mask is None \
            else (jnp.asarray(mask, dtype) > 0).astype(dtype)

        big = jnp.asarray(jnp.finfo(dtype).max, dtype)
        e_min = jnp.min(jnp.where(m > 0, verr2, big))
        off = jnp.maximum(jnp.where(jnp.isfinite(e_min) & (e_min < big),
                                    e_min, 1.0), 1e-12)
        if n_coef is None:
            n_coef = chebyshev_degree(float(off), s_max, dtype)

        t_lo = jnp.log(off)
        t_hi = jnp.log(s_max + off)
        k = np.arange(n_coef)
        xi = np.cos(np.pi * (k + 0.5) / n_coef)             # Chebyshev-Gauss
        t_nodes = 0.5 * (t_hi + t_lo) + 0.5 * (t_hi - t_lo) * jnp.asarray(xi, dtype)
        s = jnp.clip(jnp.exp(t_nodes) - off, 0.0, s_max)    # (D,)

        n_stars_total = v.shape[0]
        star_chunk = min(star_chunk, max(128, -(-n_stars_total // 128) * 128))
        n_pad = (-n_stars_total) % star_chunk
        if n_pad:
            pad = lambda a: jnp.concatenate([a, jnp.zeros(n_pad, dtype)])
            gx, gy, v, m = pad(gx), pad(gy), pad(v), pad(m)
            verr2 = jnp.concatenate([verr2, jnp.ones(n_pad, dtype)])
        n_chunks = gx.shape[0] // star_chunk
        stars = jnp.stack([gx, gy, v, verr2, m]).reshape(5, n_chunks, star_chunk)
        stars = jnp.swapaxes(stars, 0, 1)                   # (chunks, 5, C)

        # full-precision contractions: a reduced-precision pass (bf16, or TF32
        # on the GPU, ~3 decimal digits) at channel magnitudes of ~1e6 injects
        # O(1e-2) relative noise into the tables (a 322-abs lnL error at 1e4
        # stars); HIGHEST forces full f32 products
        dot = lambda a, b: jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)

        def chunk_moments(vals, chunk):
            cgx, cgy, cv, ce2, cm = chunk
            n = ce2[None, :] + s[:, None]                   # (D, C)
            w = cm[None, :] / n
            basis = jnp.stack([jnp.ones_like(cgx), cgx, cgy])   # (3, C)

            f = jnp.sum(jnp.log(n) * cm[None, :], axis=1)
            m0 = dot(w, cv * cv)                            # (D,)
            m1 = dot(w, cv[:, None] * basis.T)              # (D, 3)
            uu = jnp.stack([basis[0], cgx, cgy,
                            cgx * cgx, cgy * cgx, cgy * cgy])
            m2 = dot(w, uu.T)                               # (D, 6)
            return vals + jnp.concatenate(
                [f[:, None], m0[:, None], m1, m2], axis=1), None

        init = jnp.zeros((n_coef, 11), dtype)
        samples, _ = jax.lax.scan(chunk_moments, init, stars)

        # values at the nodes -> Chebyshev coefficients (static DCT matrix)
        d = np.arange(n_coef)
        tmat = np.cos(np.outer(d, np.arccos(xi))) * (2.0 / n_coef)
        tmat[0] *= 0.5
        coeffs = jnp.matmul(jnp.asarray(tmat, dtype), samples,
                            precision=jax.lax.Precision.HIGHEST)   # (D, 11)

        return cls(coeffs=coeffs,
                   t_lo=jnp.asarray(t_lo, dtype),
                   t_hi=jnp.asarray(t_hi, dtype),
                   offset=jnp.asarray(off, dtype),
                   n_stars=jnp.sum(m))

    def interpolate(self, s):
        """All 11 moment channels at s (batched): Chebyshev series through the
        three-term recurrence — pure FMA, no gathers."""
        t = jnp.log(jnp.maximum(s, 0.0) + self.offset)
        xi = jnp.clip((2.0 * t - (self.t_hi + self.t_lo))
                      / (self.t_hi - self.t_lo), -1.0, 1.0)

        # (a tail-first accumulation — summing the small high-order terms
        # before adding c0 + c1 xi — was measured identical in accuracy: the
        # residual f32 error lives in the one-time table build, not here)
        acc = (jnp.broadcast_to(self.coeffs[0], xi.shape + (11,))
               + self.coeffs[1] * xi[..., None])
        # unrolled recurrence (D is static, <= 96 f32 / 160 f64), bitwise-
        # identical accumulation order to the lax.scan it replaced: it removes
        # ~30 sequential tiny-element loop iterations per half-step and lets
        # XLA fuse the series into one kernel.
        tm1, tm0 = jnp.ones_like(xi), xi
        for k in range(2, self.coeffs.shape[0]):
            tp = 2.0 * xi * tm0 - tm1
            acc = acc + self.coeffs[k] * tp[..., None]
            tm1, tm0 = tm0, tp
        return acc                                          # (..., 11)

    def lnlike(self, params):
        """Batched ConstantFit log-likelihood: params (W, 4) columns
        (v_sys, sigma_max, v_maxx, v_maxy) -> (W,).  Exact up to Chebyshev
        truncation (~1e-12 relative in float64, the f32 evaluation floor in
        float32)."""
        v_sys = params[:, 0]
        s = params[:, 1] * params[:, 1]
        vx = params[:, 2]
        vy = params[:, 3]

        mom = self.interpolate(s)                           # (W, 11)
        f = mom[:, 0]
        m0 = mom[:, 1]
        m1 = mom[:, 2:5]
        q11, q12, q13, q22, q23, q33 = (mom[:, 5], mom[:, 6], mom[:, 7],
                                        mom[:, 8], mom[:, 9], mom[:, 10])

        lin = v_sys * m1[:, 0] + vx * m1[:, 1] + vy * m1[:, 2]
        quad = (v_sys * v_sys * q11 + vx * vx * q22 + vy * vy * q33
                + 2.0 * (v_sys * vx * q12 + v_sys * vy * q13 + vx * vy * q23))
        return -0.5 * (f + m0 - 2.0 * lin + quad + self.n_stars * _LOG_2PI)
