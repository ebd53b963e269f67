"""Two-component rotation: sum of two Lynden-Bell curves + Plummer dispersion.

Modernised reimplementation of the reference's ``analysis/double_model.py``.  The
reference classes still use a pre-Parameters ``initials=`` list API that is incompatible
with its own current Runner (double_model.py:57, 62-74 — see SURVEY.md stale-API
ledger); here they are first-class models on the ParamSpec API.

Rotation (double_model.py:99-159):
``v_los = v_sys + 2 (v_max/r_peak) x_pa / (1 + (x_pa/r_peak)^2)
              + 2 (v_max_c/r_peak_c) x_pa_c / (1 + (x_pa_c/r_peak_c)^2)``
with per-component position angles from the (v_maxx, v_maxy) parametrisation.
Note the reference's double model uses ``x_pa/r_peak`` (not ``r/r_peak``) inside the
denominator — preserved here.

Joint prior (double_model.py:161-189): ``0 < r_peak_c <= r_peak`` and
``|v_maxx_c|, |v_maxy_c| <= 50 km/s``.
"""

from __future__ import annotations

import logging

import numpy as np
import jax.numpy as jnp

from .model import ModelFit, _GaussianBackgroundMixin
from .. import units as u
from ..utils.table import Table

logger = logging.getLogger(__name__)

__all__ = ["DoubleModelFit", "DoubleModelFitGB"]


class DoubleModelFit(ModelFit):
    MODEL_PARAMETERS = ModelFit.MODEL_PARAMETERS + ["v_maxx_c", "v_maxy_c", "r_peak_c"]
    INTERNAL_UNITS = dict(ModelFit.INTERNAL_UNITS, v_maxx_c="km/s", v_maxy_c="km/s",
                          r_peak_c="arcmin")
    parameters_file = "double_model.json"

    def rotation_field(self, p, data):
        dx, dy = self._offsets_arcmin(p, data)
        r = jnp.sqrt(dx * dx + dy * dy)
        safe_r = jnp.where(r > 0, r, 1.0)

        def component(vx, vy, r_peak):
            # x_pa = r sin(theta - theta_0); x_pa * v_max = dy vx - dx vy
            x_pa = (dy * vx - dx * vy) / (safe_r * jnp.sqrt(vx * vx + vy * vy + 1e-300))
            v_max = jnp.sqrt(vx * vx + vy * vy)
            x_pa = x_pa * r
            return 2.0 * (v_max / r_peak) * x_pa / (1.0 + (x_pa / r_peak) ** 2)

        return (p["v_sys"]
                + component(p["v_maxx"], p["v_maxy"], p["r_peak"])
                + component(p["v_maxx_c"], p["v_maxy_c"], p["r_peak_c"]))

    def extra_lnprior_fn(self, p):
        """Joint prior in internal units: secondary peak inside primary, bounded
        secondary amplitude (reference double_model.py:161-189)."""
        ok = ((p["r_peak_c"] > 0.0) & (p["r_peak_c"] <= p["r_peak"])
              & (jnp.abs(p["v_maxx_c"]) <= 50.0) & (jnp.abs(p["v_maxy_c"]) <= 50.0))
        return jnp.where(ok, 0.0, -jnp.inf)

    def create_profiles(self, chains, n_burn, radii=None, filename=None) -> Table:
        """Radial profile of the combined two-component rotation curve + dispersion
        (reference double_model.py:218-291)."""
        chains = np.asarray(chains)
        flat = {}
        i = 0
        for name, par in self.parameters.items():
            if par.fixed:
                flat[name] = np.asarray(par.value)
            else:
                flat[name] = chains[:, n_burn:, i].reshape(-1)
                i += 1

        if radii is None:
            radii = u.Quantity(np.logspace(-1, 2.5, 50), u.arcsec)
        radii = u.Quantity(radii, u.arcsec) if not isinstance(radii, u.Quantity) else radii

        def lynden_bell(vx, vy, r_peak, unit):
            r = radii.to(unit).value[:, None]
            v_max = np.sqrt(vx ** 2 + vy ** 2)
            return 2.0 * (v_max / r_peak) * r / (1.0 + (r / r_peak) ** 2)

        v_rot = (lynden_bell(flat["v_maxx"], flat["v_maxy"], flat["r_peak"],
                             self.parameters["r_peak"].unit)
                 + lynden_bell(flat["v_maxx_c"], flat["v_maxy_c"], flat["r_peak_c"],
                               self.parameters["r_peak_c"].unit))
        r_a = radii.to(self.parameters["a"].unit).value[:, None]
        sigma = flat["sigma_max"] / (1.0 + r_a ** 2 / flat["a"] ** 2) ** 0.25

        pv = np.percentile(v_rot, [50, 16, 84, 0.15, 99.85], axis=-1)
        ps = np.percentile(sigma, [50, 16, 84, 0.15, 99.85], axis=-1)

        vel_unit = self.parameters["v_maxx"].unit
        profile = Table({"r": radii})
        for key, arr in (("v_rot", pv), ("sigma", ps)):
            profile[key] = u.Quantity(arr[0], vel_unit)
            profile[f"{key}_lower_1s"] = u.Quantity(arr[1], vel_unit)
            profile[f"{key}_upper_1s"] = u.Quantity(arr[2], vel_unit)
            profile[f"{key}_lower_3s"] = u.Quantity(arr[3], vel_unit)
            profile[f"{key}_upper_3s"] = u.Quantity(arr[4], vel_unit)

        if filename is not None:
            profile.write(filename, fmt="ascii.ecsv", overwrite=True)
        return profile


class DoubleModelFitGB(_GaussianBackgroundMixin, DoubleModelFit):
    MODEL_PARAMETERS = DoubleModelFit.MODEL_PARAMETERS + ["v_back", "sigma_back",
                                                          "f_back"]
    OBSERVABLES = dict(DoubleModelFit.OBSERVABLES, density=None)
    INTERNAL_UNITS = dict(DoubleModelFit.INTERNAL_UNITS,
                          v_back="km/s", sigma_back="km/s")
    parameters_file = "double_model_with_background.json"

    def __init__(self, data, parameters=None, **kwargs):
        background = kwargs.pop("background", None)
        if background is not None:
            logger.error("Class %s does not support additional background components.",
                         type(self).__name__)
        super().__init__(data=data, parameters=parameters, **kwargs)

    def extra_lnprior_fn(self, p):
        """Adds the GB variant's extra constraints: f_back in [0,1],
        0 < sigma_back <= 100 km/s (reference double_model.py:360-366)."""
        base = DoubleModelFit.extra_lnprior_fn(self, p)
        ok = ((p["f_back"] >= 0.0) & (p["f_back"] <= 1.0)
              & (p["sigma_back"] > 0.0) & (p["sigma_back"] <= 100.0))
        return base + jnp.where(ok, 0.0, -jnp.inf)

    def prepare_data(self, data):
        from .base import with_density_logs
        return with_density_logs(super().prepare_data(data), self.dtype)
