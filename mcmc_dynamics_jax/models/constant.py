"""Single-bin kinematics: constant rotation + constant dispersion.

JAX reimplementation of the reference's ``analysis/constant.py``: the line-of-sight
velocity field is ``v_los = v_sys + v_max sin(theta - theta_0)`` with the
wrap-free (v_maxx, v_maxy) parametrisation ``v_max = sqrt(v_maxx^2 + v_maxy^2)``,
``theta_0 = atan2(v_maxy, v_maxx)`` (constant.py:76-111), and the dispersion is a
single constant ``sigma_max`` (constant.py:52-74).

The identity ``v_max sin(theta - theta_0) = (dy v_maxx - dx v_maxy)/r`` lets the traced
code avoid the atan2/sin round-trip entirely — cheaper and exactly equivalent.
"""

from __future__ import annotations

import jax.numpy as jnp

from .base import Runner, gaussian_lnlike_terms, lnprob_mode, mixture_lnlike_terms
from ..utils.coordinates import xy_offset_rad

__all__ = ["ConstantFit", "ConstantFitGB"]


class ConstantFit(Runner):
    MODEL_PARAMETERS = ["v_sys", "sigma_max", "v_maxx", "v_maxy",
                        "ra_center", "dec_center"]
    OBSERVABLES = {"v": "km/s", "verr": "km/s", "ra": "deg", "dec": "deg"}
    INTERNAL_UNITS = {"v_sys": "km/s", "sigma_max": "km/s", "v_maxx": "km/s",
                      "v_maxy": "km/s", "ra_center": "rad", "dec_center": "rad"}
    parameters_file = "constant.json"

    # ------------------------------------------------------------------ pure model
    def prepare_data(self, data):
        """With a fixed centre, v_los is *linear* in (v_sys, v_maxx, v_maxy):
        v_los = v_sys + gx v_maxx + gy v_maxy with gx = dy/r, gy = -dx/r.  Precompute
        (gx, gy) in float64 on the host — the traced likelihood then has zero trig."""
        import numpy as np
        if self.center_is_fixed():
            dx, dy = self.fixed_center_offsets()
            r = np.hypot(dx, dy)
            safe = np.where(r > 0, r, 1.0)
            data["gx"] = jnp.asarray(np.where(r > 0, dy / safe, 0.0), self.dtype)
            data["gy"] = jnp.asarray(np.where(r > 0, -dx / safe, 0.0), self.dtype)
        else:
            # free centre: exact trig-identity star constants (Runner hook) —
            # the traced likelihood pays per-walker trig only
            data = self.add_freecenter_columns(data)
        return data

    def rotation_field(self, p, data):
        """Mean LOS velocity at every star position (pure)."""
        if "gx" in data:
            return p["v_sys"] + data["gx"] * p["v_maxx"] + data["gy"] * p["v_maxy"]
        if "fc_dx0" in data:
            dx, dy = self.freecenter_offsets_arcmin(p, data)
        else:
            dx, dy = xy_offset_rad(data["ra"], data["dec"],
                                   p["ra_center"], p["dec_center"], xp=jnp)
        r = jnp.sqrt(dx * dx + dy * dy)
        safe_r = jnp.where(r > 0, r, 1.0)
        v_rot = (dy * p["v_maxx"] - dx * p["v_maxy"]) / safe_r
        return p["v_sys"] + jnp.where(r > 0, v_rot, 0.0)

    def dispersion_field(self, p, data):
        return p["sigma_max"] * jnp.ones_like(data["v"])

    def lnlike_terms(self, p, data):
        v_los = self.rotation_field(p, data)
        sigma_los = self.dispersion_field(p, data)
        terms = gaussian_lnlike_terms(data["v"], data["verr"], v_los, sigma_los)
        if "lnlike_background" in data:
            terms = mixture_lnlike_terms(terms, data["lnlike_background"],
                                         data["pmember"])
        return terms

    # ------------------------------------------------------------------ fast paths
    def _canonical_layout(self) -> bool:
        return (type(self) is ConstantFit
                and self.center_is_fixed()
                and self.compiled.free_names == ["v_sys", "sigma_max",
                                                 "v_maxx", "v_maxy"])

    def _sufficient_eligible(self) -> bool:
        """The O(1)-per-walker sufficient-statistics path: canonical layout, no
        per-star mixture (the background logsumexp is not quadratic in theta)."""
        if lnprob_mode() not in ("auto", "sufficient"):
            return False
        return self._canonical_layout() \
            and "lnlike_background" not in self._data_arrays

    def build_lnprob_sufficient(self):
        """Batched lnprob through precomputed weighted-moment Chebyshev
        tables: the star catalog is read once at build; each walker evaluation
        is ~11 D gather-free FMAs (see ops.sufficient)."""
        import jax
        from ..ops.sufficient import ConstantSufficientStats

        data = self.prepare_data(dict(self._data_arrays))
        s_max = self._sufficient_s_max()
        stats = ConstantSufficientStats.build(
            data["gx"], data["gy"], data["v"], data["verr"] * data["verr"],
            mask=data.get("mask"), s_max=s_max)
        compiled = self.compiled
        lnprior_batched = jax.vmap(compiled.lnprior)

        def batched(thetas):
            lp = lnprior_batched(thetas)
            ll = stats.lnlike(thetas)
            in_grid = thetas[:, 1] * thetas[:, 1] <= s_max
            return jnp.where(jnp.isfinite(lp) & in_grid, lp + ll, -jnp.inf)

        return batched

    def build_lnprob_batched(self):
        if self._sufficient_eligible():
            return self.build_lnprob_sufficient()
        return super().build_lnprob_batched()


class ConstantFitGB(ConstantFit):
    """ConstantFit + parametric Gaussian background in velocity space.

    Adds ``v_back``/``sigma_back``/``f_back`` and the per-star membership prior
    ``m_i = density_i / (density_i + f_back)``; the two populations mix via a per-star
    log-sum-exp (reference constant.py:293-364).
    """

    MODEL_PARAMETERS = ConstantFit.MODEL_PARAMETERS + ["v_back", "sigma_back", "f_back"]
    OBSERVABLES = dict(ConstantFit.OBSERVABLES, density=None)
    INTERNAL_UNITS = dict(ConstantFit.INTERNAL_UNITS,
                          v_back="km/s", sigma_back="km/s")
    parameters_file = "constant_with_background.json"

    def __init__(self, data, parameters=None, **kwargs):
        background = kwargs.pop("background", None)
        if background is not None:
            import logging
            logging.getLogger(__name__).error(
                "Class %s does not support additional background components.",
                type(self).__name__)
        super().__init__(data=data, parameters=parameters, **kwargs)

    def prepare_data(self, data):
        from .base import with_density_logs
        return with_density_logs(super().prepare_data(data), self.dtype)

    def membership_prior(self, p, data):
        from .base import density_membership
        return density_membership(data["density"], p["f_back"])

    def cluster_background_terms(self, p, data):
        """Per-star (cluster, background, membership-prior) triplet (pure)."""
        v_los = self.rotation_field(p, data)
        sigma_los = self.dispersion_field(p, data)
        lnl_cluster = gaussian_lnlike_terms(data["v"], data["verr"], v_los, sigma_los)
        lnl_back = gaussian_lnlike_terms(data["v"], data["verr"],
                                         p["v_back"], p["sigma_back"])
        return lnl_cluster, lnl_back, self.membership_prior(p, data)

    def lnlike_terms(self, p, data):
        lnl_cluster, lnl_back, m = self.cluster_background_terms(p, data)
        if "ln_density" in data:
            # log-space mixture off the f64-accurate ln_density: NaN-free at
            # f_back = 0
            from .base import density_mixture_terms
            return density_mixture_terms(data["density"], data["ln_density"],
                                         p["f_back"], lnl_cluster, lnl_back)
        return mixture_lnlike_terms(lnl_cluster, lnl_back, m)

    def calculate_membership_probabilities(self, chain, n_burn):
        """A-posteriori membership per star from the best-fit (median) parameters
        (reference constant.py:366-374)."""
        import numpy as np

        bestfit = self.compute_bestfit_values(chain=chain, n_burn=n_burn)
        theta = np.array([bestfit.value(n)[0] for n in self.fitted_parameters])
        p = self.scaled_values(jnp.asarray(theta, dtype=self.dtype))
        lnl_c, lnl_b, m = self.cluster_background_terms(p, self._data_arrays)
        lnl_c, lnl_b, m = map(np.asarray, (lnl_c, lnl_b, m))
        peak = np.maximum(lnl_c, lnl_b)
        num = m * np.exp(lnl_c - peak)
        return num / (num + (1.0 - m) * np.exp(lnl_b - peak))
