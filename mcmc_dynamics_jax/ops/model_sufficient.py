"""O(B)-per-walker ModelFit likelihood via radially-binned sufficient statistics.

The global-model likelihood (reference model.py:93-180 + runner.py:260-271) is

    lnL = -0.5 sum_i m_i [ log(2 pi n_i) + (v_i - v_sys - c_i (dy_i vx - dx_i vy))^2 / n_i ]
    n_i = verr_i^2 + s g(u_i; a),   s = sigma_max^2,   u_i = r_i^2,
    g(u; a) = (1 + u/a^2)^(-1/2)          [Plummer dispersion, squared]
    c(u; rp) = 2 rp / (rp^2 + u)          [Lynden-Bell rotation shape]

— *quadratic* in beta = (v_sys, vx, vy) once (sigma_max, a, r_peak) are fixed.  The
star axis is eliminated in two steps:

1. **Radial binning with 2nd-order correction.**  Stars are grouped into B
   log-spaced bins in u; inside bin b the smooth fields are Taylor-expanded around
   u_b:  g_i = g0 + g1 d_i + g2 d_i^2,  c_i = c0 + c1 d_i + c2 d_i^2  with
   d_i = u_i - u_b and walker-computable coefficients (exact derivatives of g, c at
   u_b).  Expanding 1/n_i and log n_i to second order in eps_i = s(g1 d_i + g2 d_i^2)
   leaves moments of the form  M[f, j, k](S) = sum_i m_i f_i d_i^j / (E_i + S)^k
   (E_i = verr_i^2, S = s g0) with (j,k) in {(0,1),(1,1),(2,1),(1,2),(2,2),(2,3)}
   per payload f, plus  FF(S) = sum_i m_i log(E_i + S).  The error is O(d^3) per
   star; verr enters *exactly*.

2. **Chebyshev tables in t = log(S + E_min).**  Each of the 61 channel functions is
   analytic in S on [0, s_max] with poles only at S = -E_i; in the log variable the
   pole lattice sits a distance ~pi from the real interval, so a single global
   Chebyshev series of degree ~48 evaluates them to ~1e-8 relative.  Per walker the
   moment block is a (D+1)-vector of Chebyshev basis values contracted with a
   (B, D+1, 61) coefficient table — a matrix contraction with **no gathers**.
   Per-walker cost is O(B D) instead of O(N_stars).

This generalises ops/sufficient.py (the ConstantFit O(1) tier) to the flagship
ModelFit workload: the catalog is touched once at build; sampling never re-reads it.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np

import jax
import jax.numpy as jnp

__all__ = ["ModelSufficientStats", "N_CHANNELS"]

_LOG_2PI = math.log(2.0 * math.pi)

# payload order: 1, v, v^2, x, y, v x, v y, x^2, x y, y^2   (x = dy, y = -dx)
_N_PAYLOADS = 10
# (j, k) combos per payload: powers of delta and of the base weight 1/(E+S)
_COMBOS = ((0, 1), (1, 1), (2, 1), (1, 2), (2, 2), (2, 3))
N_CHANNELS = 1 + _N_PAYLOADS * len(_COMBOS)   # 61: FF + 10 x 6


def _chebyshev_nodes(n_coef: int):
    k = np.arange(n_coef)
    return np.cos(np.pi * (k + 0.5) / n_coef)          # Chebyshev-Gauss nodes


def _chebyshev_fit(samples: np.ndarray, xi: np.ndarray) -> np.ndarray:
    """Coefficients a_d with f(x) ~= sum_d a_d T_d(x) from values at the nodes.

    ``samples``: (n_nodes, ...) function values at xi (Chebyshev-Gauss nodes).
    """
    n = xi.shape[0]
    d = np.arange(n)
    # T_d(xi_k) = cos(d * arccos(xi_k)) = cos(pi d (k + 1/2) / n)
    tmat = np.cos(np.outer(d, np.arccos(xi)))           # (D, K)
    coef = (2.0 / n) * np.tensordot(tmat, samples, axes=(1, 0))
    coef[0] *= 0.5
    return coef                                          # (D, ...)


class ModelSufficientStats(NamedTuple):
    """Chebyshev tables of the 61 per-bin moment channels over t = log(S + off)."""

    coeffs: jnp.ndarray     # (B, D, 61)
    u_bins: jnp.ndarray     # (B,) expansion points u_b
    t_lo: jnp.ndarray       # scalar: log(off)
    t_hi: jnp.ndarray       # scalar: log(s_max + off)
    offset: jnp.ndarray     # scalar: E_min (pole-shift offset)
    n_stars: jnp.ndarray    # effective (masked) star count
    s_max: float            # static: grid upper edge in S

    @classmethod
    def build(cls, dxm, dym, v, verr2, mask=None, n_bins: Optional[int] = None,
              n_coef: Optional[int] = None, s_max: float = 1.0e6,
              dtype=None) -> "ModelSufficientStats":
        """Precompute the tables from the star catalog (host-side, float64).

        ``dxm``/``dym``: arcmin offsets from the (fixed) centre; ``verr2`` in
        (km/s)^2.  ``s_max`` bounds S = sigma_max^2 g <= sigma_max^2.

        ``n_bins=None`` picks the bin count from the evaluation dtype.  The
        measured error budget (16k-walker probe, 1e4-star catalog): in float32
        the table *evaluation* floor (coefficient cancellation in the (D, 61)
        contraction) dominates at ~2.4e-6 relative lnL for every bin count in
        96-256, so 96 bins is accuracy-neutral (the O(d^3) binning term is
        ~6e-2 abs there, under the ~7e-2 f32 floor) and 1.33x faster per
        walker than 128; in float64 the Taylor term is what's visible
        (5.6e-3 abs at 192 bins vs 2.7e-2 at 128 on the probe), so float64
        keeps 192.

        ``n_coef=None`` picks the Chebyshev degree from the pole geometry: in
        t = log(S + E_min) the pole lattice sits a distance pi off the real
        interval of half-length L, giving a convergence factor
        rho = eta + sqrt(1 + eta^2), eta = pi/L.  The degree is sized for the
        dtype's useful truncation level — 1e-9 in float64, 1e-6 in float32
        (the f32 evaluation floor is 2.4e-6; terms below it are dead weight —
        dropping them took the default unbounded-prior degree from 52 to 35).
        Tighter sigma_max priors shrink
        the interval and need fewer terms still.
        """
        dxm = np.asarray(dxm, np.float64)
        dym = np.asarray(dym, np.float64)
        v = np.asarray(v, np.float64)
        verr2 = np.asarray(verr2, np.float64)
        m = np.ones_like(v) if mask is None else np.asarray(mask, np.float64)
        if dtype is None:
            dtype = jnp.zeros(0).dtype
        is_f64 = jnp.dtype(dtype) == jnp.float64
        if n_bins is None:
            n_bins = 192 if is_f64 else 96

        u = dxm * dxm + dym * dym
        x = dym
        y = -dxm

        u_max = float(np.max(u)) if u.size else 1.0
        u_max = max(u_max, 1e-12)
        # log-spaced edges: the per-star truncation error is O((d ln u)^3) against
        # fields that curve on multiplicative scales (a^2, r_peak^2), so uniform
        # log-width bounds it uniformly over the (a, r_peak) prior box
        edges = np.geomspace(u_max * 1e-6, u_max, n_bins + 1)
        edges[0] = 0.0
        edges[-1] = u_max * (1.0 + 1e-12)
        which = np.clip(np.searchsorted(edges, u, side="right") - 1, 0, n_bins - 1)

        e_min = float(np.min(verr2[m > 0])) if np.any(m > 0) else 1.0
        off = max(e_min, 1e-12)
        t_lo = math.log(off)
        t_hi = math.log(s_max + off)
        if n_coef is None:
            half_len = 0.5 * (t_hi - t_lo)
            eta = math.pi / max(half_len, 1e-6)
            rho = eta + math.sqrt(1.0 + eta * eta)
            trunc = 1e9 if is_f64 else 1e6
            needed = math.ceil(math.log(trunc) / math.log(rho))
            n_coef = int(np.clip(needed, 16, 96))
            if needed > 96:
                import logging
                logging.getLogger(__name__).warning(
                    "Chebyshev degree capped at 96 (pole geometry wants %d for "
                    "%.0e truncation; expect ~%.0e relative instead). Tighten "
                    "the sigma_max prior or raise the minimum velocity error.",
                    needed, 1.0 / trunc, rho ** -96.0)
        xi = _chebyshev_nodes(n_coef)                       # (K,)
        t_nodes = 0.5 * (t_hi + t_lo) + 0.5 * (t_hi - t_lo) * xi
        s_nodes = np.exp(t_nodes) - off                     # (K,) in S-space
        s_nodes = np.clip(s_nodes, 0.0, s_max)

        u_bins = np.zeros(n_bins)
        samples = np.zeros((n_coef, n_bins, N_CHANNELS))
        for b in range(n_bins):
            sel = which == b
            if not np.any(sel):
                u_bins[b] = 0.5 * (edges[b] + edges[b + 1])
                continue
            ub, vb = u[sel], v[sel]
            eb, mb = verr2[sel], m[sel]
            xb, yb = x[sel], y[sel]
            wsum = np.sum(mb)
            u_bins[b] = (np.sum(mb * ub) / wsum) if wsum > 0 else ub.mean()
            d = ub - u_bins[b]

            n0 = eb[None, :] + s_nodes[:, None]             # (K, n_b)
            w1 = mb[None, :] / n0
            w2 = w1 / n0
            w3 = w2 / n0
            samples[:, b, 0] = np.sum(mb[None, :] * np.log(n0), axis=1)
            payloads = (np.ones_like(vb), vb, vb * vb, xb, yb,
                        vb * xb, vb * yb, xb * xb, xb * yb, yb * yb)
            wpow = {1: w1, 2: w2, 3: w3}
            ch = 1
            for f in payloads:
                for (j, k) in _COMBOS:
                    samples[:, b, ch] = np.sum(wpow[k] * (f * d ** j)[None, :],
                                               axis=1)
                    ch += 1

        coeffs = _chebyshev_fit(samples, xi)                # (D, B, 61)
        coeffs = np.swapaxes(coeffs, 0, 1)                  # (B, D, 61)

        return cls(coeffs=jnp.asarray(coeffs, dtype),
                   u_bins=jnp.asarray(u_bins, dtype),
                   t_lo=jnp.asarray(t_lo, dtype),
                   t_hi=jnp.asarray(t_hi, dtype),
                   offset=jnp.asarray(off, dtype),
                   n_stars=jnp.asarray(np.sum(m), dtype),
                   s_max=float(s_max))

    # ------------------------------------------------------------------ evaluation
    def _field_scalars(self, sigma_max, a, r_peak):
        """Per (walker, bin) expansion coefficients of g and c around u_b.

        Returns (S, a1, a2, c0, c1, c2): S = s g0 is the table argument;
        eps_i = a1 d_i + a2 d_i^2 perturbs n; c_i = c0 + c1 d_i + c2 d_i^2.
        """
        u_b = self.u_bins[None, :]                          # (1, B)
        s = (sigma_max * sigma_max)[:, None]                # (W, 1)
        za = jnp.maximum((a * a)[:, None], 1e-30)
        g0 = jax.lax.rsqrt(1.0 + u_b / za)
        g0_3 = g0 * g0 * g0
        g1 = -0.5 / za * g0_3
        g2 = 0.375 / (za * za) * (g0_3 * g0 * g0)           # 1/2 g'' = 3/(8 za^2) g^5

        rp = r_peak[:, None]
        lam = rp * rp
        h = 1.0 / (lam + u_b)
        c0 = 2.0 * rp * h
        c1 = -c0 * h                                        # c' = -2 rp h^2
        c2 = c0 * h * h                                     # 1/2 c'' = 2 rp h^3

        return s * g0, s * g1, s * g2, c0, c1, c2

    def _basis(self, S):
        """Chebyshev basis T_d(xi(S)) stacked on the last axis: (..., D)."""
        t = jnp.log(jnp.maximum(S, 0.0) + self.offset)
        xi = jnp.clip((2.0 * t - (self.t_hi + self.t_lo)) / (self.t_hi - self.t_lo),
                      -1.0, 1.0)
        n_coef = self.coeffs.shape[1]

        def step(carry, _):
            tm1, tm0 = carry
            tp = 2.0 * xi * tm0 - tm1
            return (tm0, tp), tm0

        t0 = jnp.ones_like(xi)
        _, rest = jax.lax.scan(step, (t0, xi), None, length=n_coef - 1)
        # rest: (D-1, ...) = [T1, T2, ...]
        return jnp.concatenate([t0[None], rest], axis=0)    # (D, ...)

    def lnlike(self, params):
        """Batched ModelFit log-likelihood: params (W, 6) columns
        (v_sys, sigma_max, a, v_maxx, v_maxy, r_peak) in internal units
        (km/s, arcmin) -> (W,).  Accuracy ~1e-4 absolute in lnL (2nd-order radial
        binning; Chebyshev error ~1e-8 relative)."""
        v_sys, sigma_max, a = params[:, 0], params[:, 1], params[:, 2]
        vx, vy, r_peak = params[:, 3], params[:, 4], params[:, 5]

        scal = self._field_scalars(sigma_max, a, r_peak)
        basis = self._basis(scal[0])                        # (D, W, B)
        # HIGHEST: a reduced-precision pass (bf16, or TF32 on the GPU, both
        # ~3 decimal digits) would put ~1e-2 relative noise on the
        # ~1e5-magnitude channels
        mom = jnp.einsum("dwb,bdc->wbc", basis, self.coeffs,
                         precision=jax.lax.Precision.HIGHEST)

        def get(p, j, k):                                   # payload p, combo (j,k)
            return mom[:, :, 1 + 6 * p + _COMBOS.index((j, k))]

        _, a1, a2, c0, c1, c2 = scal
        per_bin = _combine_channels(get, mom[:, :, 0], a1, a2, c0, c1, c2,
                                    v_sys[:, None], vx[:, None], vy[:, None])
        total = jnp.sum(per_bin, axis=1)                    # (W,)
        return -0.5 * (total + self.n_stars * _LOG_2PI)


def _combine_channels(get, ff, a1, a2, c0, c1, c2, v_sys, vx, vy):
    """Per-bin contribution to -2 lnL (minus the 2-pi constant), shared by the
    XLA path.

    ``get(p, j, k)`` returns the interpolated moment M[f_p, j, k]; ``ff`` is the
    log-determinant channel; the remaining arguments are broadcast-compatible
    expansion scalars / parameters.  Payload order: 1, v, v^2, x, y, vx, vy,
    x^2, xy, y^2 with x = dy, y = -dx.
    """
    a11 = a1 * a1

    def w0(p):                                              # sum f w
        return (get(p, 0, 1) - a1 * get(p, 1, 2) - a2 * get(p, 2, 2)
                + a11 * get(p, 2, 3))

    def w1(p):                                              # sum f w c
        return (c0 * get(p, 0, 1) + c1 * get(p, 1, 1) + c2 * get(p, 2, 1)
                - a1 * (c0 * get(p, 1, 2) + c1 * get(p, 2, 2))
                - a2 * c0 * get(p, 2, 2) + a11 * c0 * get(p, 2, 3))

    def w2(p):                                              # sum f w c^2
        d0 = c0 * c0
        d1 = 2.0 * c0 * c1
        d2 = c1 * c1 + 2.0 * c0 * c2
        return (d0 * get(p, 0, 1) + d1 * get(p, 1, 1) + d2 * get(p, 2, 1)
                - a1 * (d0 * get(p, 1, 2) + d1 * get(p, 2, 2))
                - a2 * d0 * get(p, 2, 2) + a11 * d0 * get(p, 2, 3))

    logdet = (ff + a1 * get(0, 1, 1) + a2 * get(0, 2, 1)
              - 0.5 * a11 * get(0, 2, 2))

    quad = (w0(2)
            - 2.0 * (v_sys * w0(1) + vx * w1(5) + vy * w1(6))
            + v_sys * v_sys * w0(0)
            + 2.0 * v_sys * (vx * w1(3) + vy * w1(4))
            + vx * vx * w2(7) + 2.0 * vx * vy * w2(8) + vy * vy * w2(9))
    return logdet + quad
