"""Catalog-size-decoupled JAM likelihood: polar moment grid + matmul interpolation.

The JAM moment solve (moments.py) costs O(n_positions x n_u x n_mass x n_zeta)
per walker — at 10^4-10^5 stars it dwarfs everything else in the fit.  But the
LOS moment fields of an axisymmetric model are *bisymmetric and smooth*:

* ``v2zz(x', y')`` is even under both x' -> -x' and y' -> -y' (it depends on
  position through x'^2/R^2, y'^2/R^2 and the z^2-even LOS integral);
* ``vz(x', y')`` is odd in x' (the explicit x'/R projection factor) and even
  in y' (the ζ -> -ζ substitution maps (y, z) -> -(y, z) leaving R^2, z^2
  invariant).

(Both read directly off the projection formulas implemented in moments.py —
reference contract cjam/axisymmetric.py:288-310.)  In polar coordinates
(R, φ) on the model frame this forces pure cosine series with definite parity:

    v2zz(R, φ) = Σ_m  A_m(log R) cos(2 m φ)          (even harmonics)
    vz(R, φ)   = Σ_m  B_m(log R) cos((2 m + 1) φ)    (odd harmonics)

and every radial profile A_m, B_m is analytic in t = log R (the fields are
scale mixtures of Gaussians plus the BH's exp(-t)-type Keplerian term), so a
Chebyshev interpolant in t converges geometrically.

The tier therefore evaluates the moment engine per walker at only
``G = n_r x n_phi`` quarter-plane grid points (φ_k strictly inside (0, π/2) —
never on the axes), cosine+Chebyshev transforms the grid (three tiny matmuls),
and reconstructs the moments at all N stars with one batched matrix contraction.
The kappa-frame rotation by θ0 = atan2(kappa_y, kappa_x) is FREE in harmonic
space: cos(k(φ_i - θ0)) = cos kφ_i cos kθ0 + sin kφ_i sin kθ0, so the per-star
angular factors are precomputed once (the star catalog never re-enters the hot
loop) and θ0 only touches the 2K walker-side multipliers.

Cost per walker: a G-position moment solve (G ~ 500-800, independent of N)
plus an (N, n_r) x (n_r, 2K) interpolation matmul — the JAM analog of the
tensor tier that decoupled ModelFit from the catalog (ops/model_tensor.py).

Accuracy is set by (n_r, n_phi) against the field smoothness; the defaults in
:class:`~.axisymmetric.Axisymmetric` — (128, 12) — are certified in
tools/probe_jam_grid.py + tests/test_jam_grid.py over the inclination/
flattening/beta/BH box: the tier's worst-case moment error equals the direct
engine's own quadrature error, so switching tiers costs NO accuracy.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np

import jax
import jax.numpy as jnp

__all__ = ["JamGridSpec", "jam_grid_moments"]


class JamGridSpec(NamedTuple):
    """Static interpolation geometry: grid nodes + per-star bases.

    All arrays are closure constants of the jitted likelihood (they enter
    ``program_cache_salt`` through the (n_r, n_phi, r-range) knobs plus the
    star-geometry fingerprint of the data arrays).
    """

    x_grid: jnp.ndarray      # (G,) quarter-plane positions [arcsec], model frame
    y_grid: jnp.ndarray      # (G,)
    dct_r: jnp.ndarray       # (n_r, n_r) Chebyshev-Gauss value->coefficient map
    dct_even: jnp.ndarray    # (n_phi, n_phi) values at ψ_k -> cos(m ψ) coeffs
    dct_odd: jnp.ndarray     # (n_phi, n_phi) values at ψ_k -> cos((m+1/2) ψ)
    t_star: jnp.ndarray      # (N, n_r) Chebyshev basis T_d(t_i), t = log R
    cos_even: jnp.ndarray    # (N, n_phi) cos(2 m φ_i)
    sin_even: jnp.ndarray    # (N, n_phi) sin(2 m φ_i)
    cos_odd: jnp.ndarray     # (N, n_phi) cos((2 m + 1) φ_i)
    sin_odd: jnp.ndarray     # (N, n_phi) sin((2 m + 1) φ_i)
    mult_even: jnp.ndarray   # (n_phi,) harmonic multipliers 2 m
    mult_odd: jnp.ndarray    # (n_phi,) harmonic multipliers 2 m + 1
    n_r: int                 # static orders (also the salt)
    n_phi: int

    @classmethod
    def build(cls, dx_arcsec, dy_arcsec, n_r: int = 48, n_phi: int = 12,
              r_floor: float = 0.06, dtype=jnp.float32) -> "JamGridSpec":
        """Precompute the grid + star bases from fixed-centre star offsets.

        ``r_floor`` [arcsec] clamps the innermost grid radius (the reference
        clamps |x|,|y| >= 1e-3 arcmin for the same central-singularity reason,
        axisymmetric.py:273-284); stars inside it evaluate at the floor.
        """
        dx = np.asarray(dx_arcsec, np.float64)
        dy = np.asarray(dy_arcsec, np.float64)
        r = np.hypot(dx, dy)
        phi = np.arctan2(dy, dx)

        r_hi = max(float(r.max()) if r.size else 1.0, r_floor * 10.0)
        r_lo = max(float(r[r > 0].min()) if np.any(r > 0) else r_floor, r_floor)
        t_lo, t_hi = math.log(r_lo), math.log(r_hi)

        # radial Chebyshev-Gauss nodes in t = log R
        k = np.arange(n_r)
        xi = np.cos(np.pi * (k + 0.5) / n_r)
        t_nodes = 0.5 * (t_hi + t_lo) + 0.5 * (t_hi - t_lo) * xi
        r_nodes = np.exp(t_nodes)                               # (n_r,)
        dct_r = np.cos(np.outer(k, np.arccos(xi))) * (2.0 / n_r)
        dct_r[0] *= 0.5

        # angular nodes: ψ_k = (k + 1/2) π / K on the doubled angle ψ = 2 φ
        # (φ_k strictly inside (0, π/2): the grid never sits on an axis)
        psi = (np.arange(n_phi) + 0.5) * math.pi / n_phi
        phi_nodes = 0.5 * psi
        m = np.arange(n_phi)
        # even block: f(ψ) = Σ A_m cos(m ψ); exact for m < K at these nodes
        dct_even = np.cos(np.outer(m, psi)) * (2.0 / n_phi)
        dct_even[0] *= 0.5
        # odd block: f(ψ) = Σ B_m cos((m + 1/2) ψ)  (DCT-IV orthogonality)
        dct_odd = np.cos(np.outer(m + 0.5, psi)) * (2.0 / n_phi)

        rr, pp = np.meshgrid(r_nodes, phi_nodes, indexing="ij")
        x_grid = (rr * np.cos(pp)).ravel()
        y_grid = (rr * np.sin(pp)).ravel()

        # per-star bases (host, float64; stored in the evaluation dtype)
        t_i = np.clip(np.log(np.maximum(r, r_lo)), t_lo, t_hi)
        xi_i = np.clip((2.0 * t_i - (t_hi + t_lo)) / (t_hi - t_lo), -1.0, 1.0)
        t_star = np.cos(np.outer(np.arange(n_r), np.arccos(xi_i))).T  # (N, n_r)
        me = 2.0 * m
        mo = 2.0 * m + 1.0
        cos_even = np.cos(phi[:, None] * me[None, :])
        sin_even = np.sin(phi[:, None] * me[None, :])
        cos_odd = np.cos(phi[:, None] * mo[None, :])
        sin_odd = np.sin(phi[:, None] * mo[None, :])

        to = lambda a: jnp.asarray(a, dtype)
        return cls(x_grid=to(x_grid), y_grid=to(y_grid), dct_r=to(dct_r),
                   dct_even=to(dct_even), dct_odd=to(dct_odd),
                   t_star=to(t_star), cos_even=to(cos_even),
                   sin_even=to(sin_even), cos_odd=to(cos_odd),
                   sin_odd=to(sin_odd), mult_even=to(me), mult_odd=to(mo),
                   n_r=int(n_r), n_phi=int(n_phi))


def jam_grid_moments(spec: JamGridSpec, moments_at, theta0, floor=1e-12):
    """Star-position moments through the grid: solve G points, transform,
    reconstruct (see module docstring).

    ``moments_at(x, y) -> (vz, v2zz, valid)`` evaluates the engine in the
    MODEL frame; ``theta0`` is the kappa-frame rotation angle.  Returns
    ``(vz, v2zz, valid)`` at every star, matching
    ``Axisymmetric.model_moments``'s contract.

    The interpolated fields are ``L = log(v2zz + floor)`` (even harmonics)
    and the bounded rotation fraction ``w = vz / sqrt(v2zz + floor)`` (odd
    harmonics, |w| <= 1), NOT the raw moments: v2zz spans the catalog with a
    dynamic range of 1e3+ when the tracer MGE cuts off inside the outermost
    stars, and a Chebyshev fit of the raw field has uniform ABSOLUTE error —
    catastrophic relative error (and spurious sigma^2 < 0 rejections)
    exactly at the faint edge.  In log space the error is uniformly
    RELATIVE; both transformed fields keep the bisymmetric parity (L is an
    even function of an even field, the even sqrt preserves vz's odd-in-x' /
    even-in-y' symmetry).  ``floor`` bounds the log range at the faint edge;
    the likelihood-natural value is the catalog's minimum verr^2 — below it
    sigma_model^2 is invisible next to the measurement variance, so the
    floored field's uniform RELATIVE error stays likelihood-safe everywhere.
    """
    vz_g, v2_g, valid = moments_at(spec.x_grid, spec.y_grid)
    n_r, n_phi = spec.n_r, spec.n_phi
    v2_safe = (jnp.maximum(v2_g, 0.0) + floor).reshape(n_r, n_phi)
    lg = jnp.log(v2_safe)
    wg = vz_g.reshape(n_r, n_phi) * jax.lax.rsqrt(v2_safe)

    # grid values -> (n_r coeffs, n_phi harmonics); tiny matmuls, pinned to
    # HIGHEST (a default-precision product may run as one ~3-digit pass)
    hi = jax.lax.Precision.HIGHEST
    c1 = jnp.matmul(spec.dct_r,
                    jnp.matmul(wg, spec.dct_odd.T, precision=hi),
                    precision=hi)                       # (n_r, K)
    c2 = jnp.matmul(spec.dct_r,
                    jnp.matmul(lg, spec.dct_even.T, precision=hi),
                    precision=hi)

    # kappa-frame rotation in harmonic space
    co, so = jnp.cos(spec.mult_odd * theta0), jnp.sin(spec.mult_odd * theta0)
    ce, se = jnp.cos(spec.mult_even * theta0), jnp.sin(spec.mult_even * theta0)

    # star reconstruction: one (N, n_r) @ (n_r, K) contraction per moment, in
    # full f32: on an H100 (PERF.md) Precision.HIGH runs in TF32, whose ~1e-3
    # relative error lands straight in log v2zz — 7.4 lnL (2.5e-4 relative)
    # on the 6284-star example catalog against float64, far outside the JAM
    # accelerator-vs-CPU gate (rtol 2e-5, atol 0.1); HIGHEST measured 0.16
    # lnL (then dominated by the pair contraction) for 4% more time
    h1 = jnp.matmul(spec.t_star, c1, precision=hi)      # (N, K)
    h2 = jnp.matmul(spec.t_star, c2, precision=hi)
    w = jnp.sum(h1 * (spec.cos_odd * co + spec.sin_odd * so), axis=1)
    v2f = jnp.exp(jnp.sum(h2 * (spec.cos_even * ce + spec.sin_even * se),
                          axis=1))                      # = v2zz + floor
    vz = w * jnp.sqrt(v2f)
    return vz, v2f - floor, valid
