"""Config-driven production driver (capability parity with the reference bin/run.py).

Workflow: JSON run-config -> star catalog (+ optional field-star background and MGE
profile/grid) -> JAM (AnalyticalProfiles/Axisymmetric) or analytic (ModelFit/...)
sampling with chunked checkpoints -> chain/corner plots -> model radial profiles ->
binned ConstantFit radial profile (one batched program) -> M/L + mass posterior ->
overlay plot.  Supports --chain restart from a previous checkpoint.

Config schema (JSON):
{
  "prefix": "run1",
  "data": {"file": "catalog.csv", "format": "csv",
            "names": ["ra","dec","v","verr"], "v_sys": 232.7},
  "model": "analytical_profiles" | "axisymmetric" | "model_fit" | ...,
  "mge": "mge.ecsv"            # or "mge_grid": {"<ra>,<dec>": "file.ecsv", ...}
  "background": {"type": "single_stars", "file": "field.csv", "column": "v"},
  "parameters": {"d": {"value": 5.2, "fixed": true}, ...},   # per-parameter set()
  "sampling": {"n_walkers": 100, "n_steps": 500, "n_burn": 100, "n_out": 100,
                "seed": 1,
                "move": "stretch" | "de" | "snooker" | [["stretch",0.5],["de",0.5]],
                "sampler": "ensemble" | "tempered" | "hmc",
                # tempered:  "n_temps": 8, "beta_min": 1e-3, "swap_every": 5
                # hmc:       "n_leapfrog": 10, "n_warmup": 200, "step_size": 0.05
               },
  "parallel": {"axes": {"dp": 4, "sp": 2},        # device mesh for the sampler
               "distributed": {"coordinator": "host0:1234",   # multi-host opt-in
                                "num_processes": 2, "process_id": 0}},
  "binned": {"nstars": 50, "dlogr": 0.2, "n_walkers": 16, "n_steps": 300},
  "profiles": {"n_samples": 100, "n_theta": 10}
}
"""

from __future__ import annotations

import argparse
import json
import logging
import pathlib
import sys

import numpy as np

logger = logging.getLogger(__name__)

_MODELS = {}


def _model_registry():
    global _MODELS
    if not _MODELS:
        from ..models import (AnalyticalProfiles, Axisymmetric, ConstantFit,
                              ConstantFitGB, DoubleModelFit, DoubleModelFitGB,
                              ModelFit, ModelFitConstantBackground, ModelFitGB)
        _MODELS = {
            "constant": ConstantFit, "constant_gb": ConstantFitGB,
            "model_fit": ModelFit, "model_fit_gb": ModelFitGB,
            "model_fit_constant_background": ModelFitConstantBackground,
            "double_model": DoubleModelFit, "double_model_gb": DoubleModelFitGB,
            "axisymmetric": Axisymmetric,
            "analytical_profiles": AnalyticalProfiles,
        }
    return _MODELS


def load_catalog(cfg):
    from .. import units as u
    from ..utils import DataReader, Table

    fmt = cfg.get("format", "csv")
    table = Table.read(cfg["file"], fmt=fmt, names=cfg.get("names"))
    rename = cfg.get("rename", {})
    for old, new in rename.items():
        # preserve the source column's unit through the rename (a plain
        # __setitem__ would silently reset it to dimensionless)
        unit = table.units.get(old)
        table[new] = table.columns.pop(old)
        table.units.pop(old, None)
        if unit is not None:
            table.units[new] = unit
    units_map = cfg.get("units", {"ra": "deg", "dec": "deg", "v": "km/s",
                                  "verr": "km/s"})
    for name, unit in units_map.items():
        if name in table:
            table.units[name] = u.parse_unit(unit)
    if cfg.get("v_sys") is not None:
        table["v"] = u.Quantity(table.value("v") - float(cfg["v_sys"]),
                                table.units["v"])
    return DataReader(table)


def build_background(cfg, v_sys: float = 0.0):
    """Field-star background from the run config.

    ``v_sys``: systemic velocity already subtracted from the SCIENCE catalog
    (``data.v_sys``); the background must live in the same shifted frame, so
    it is subtracted from the field-star velocities / Gaussian mean as well
    (reference bin/run.py:441-442).  A ``v_sys`` key inside the background
    block overrides (use 0 for a catalog already in the shifted frame).
    """
    if cfg is None:
        return None
    from .. import units as u
    from ..background import Gaussian, SingleStars
    from ..utils import Table

    v_sys = float(cfg.get("v_sys", v_sys) or 0.0)
    if cfg["type"] == "gaussian":
        return Gaussian(u.Quantity(float(cfg["mean"]) - v_sys, "km/s"),
                        u.Quantity(cfg["sigma"], "km/s"))
    if cfg["type"] == "single_stars":
        table = Table.read(cfg["file"], fmt=cfg.get("format", "csv"),
                           names=cfg.get("names"))
        v = table.value(cfg.get("column", "v")) - v_sys
        return SingleStars(u.Quantity(v, "km/s"))
    raise ValueError(f"Unknown background type '{cfg['type']}'.")


def build_mesh(cfg):
    """Device mesh (and optional multi-host runtime) from the ``parallel``
    config block.  ``axes`` maps mesh axis names to extents — the sampler
    understands ``dp`` (walkers), ``sp`` (stars) and ``tp`` (temperature
    ladder, tempered sampler only).  A ``distributed`` sub-block wires this
    process into a multi-host runtime first (parallel/distributed.py)."""
    if not cfg:
        return None
    import jax

    from ..parallel import distributed as dist
    from ..parallel import make_mesh

    dcfg = cfg.get("distributed")
    if dcfg is not None:
        dist.initialize(coordinator_address=dcfg.get("coordinator"),
                        num_processes=dcfg.get("num_processes"),
                        process_id=dcfg.get("process_id"),
                        auto=bool(dcfg.get("auto", False)))
    axes = cfg.get("axes")
    if not axes:
        return None
    names = tuple(axes.keys())
    shape = tuple(int(v) for v in axes.values())
    n = int(np.prod(shape))
    devices = jax.devices()
    if n > len(devices):
        raise ValueError(f"parallel.axes {dict(axes)} needs {n} devices; "
                         f"only {len(devices)} available.")
    mesh = make_mesh(names, shape, devices=devices[:n])
    logger.info("device mesh: %s over %d %s device(s)", dict(zip(names, shape)),
                n, devices[0].platform)
    return mesh


def _normalize_move(move_cfg):
    """Config move spec -> the sampler's move argument (name or weighted list).

    JSON entries are ``[name, weight]`` or ``[name, weight, {hyper: value}]``
    (e.g. ``["de", 0.8, {"gamma0": 0.6}]``); the params mapping is passed
    through to :func:`sampler.stretch.normalize_move`, which validates the
    hyperparameter names per move.
    """
    if move_cfg is None:
        return "stretch"
    if isinstance(move_cfg, str):
        return move_cfg
    out = []
    for entry in move_cfg:
        name, weight, *rest = entry
        params = dict(rest[0]) if rest else {}
        out.append((str(name), float(weight), params))
    return out


def make_overlay_plot(profile, binned, filename):
    """Model-vs-binned overlay (reference bin/run.py:107-143): the posterior
    model profile with 1-sigma bands, the per-bin ConstantFit measurements on
    top, and the per-bin rotation-axis angles in the polar panel.

    ``profile``: Table from ``create_profiles`` (r in arcsec);
    ``binned``: Table from ``BinnedFitResult.summary`` (radii in arcmin).
    """
    from ..utils.plots import ProfilePlot

    plot = ProfilePlot()

    r = np.asarray(profile.value("r"))                      # arcsec
    v = np.asarray(profile.value("v_rot"))
    plot.add_rotation_profile(
        r, v, fill_between=True, c="g",
        yerr=(v - np.asarray(profile.value("v_rot_lower_1s")),
              np.asarray(profile.value("v_rot_upper_1s")) - v))
    s = np.asarray(profile.value("sigma"))
    plot.add_dispersion_profile(
        r, s, fill_between=True, c="g",
        yerr=(s - np.asarray(profile.value("sigma_lower_1s")),
              np.asarray(profile.value("sigma_upper_1s")) - s))

    rb = np.asarray(binned.value("r mean")) * 60.0          # arcmin -> arcsec
    rb_lo = rb - np.asarray(binned.value("r min")) * 60.0
    rb_hi = np.asarray(binned.value("r max")) * 60.0 - rb
    for panel, name in (("add_rotation_profile", "v_max"),
                        ("add_dispersion_profile", "sigma_max")):
        y = np.asarray(binned.value(f"{name} median"))
        ylo = np.asarray(binned.value(f"{name} low"))
        yhi = np.asarray(binned.value(f"{name} high"))
        getattr(plot, panel)(rb, y, xerr=(rb_lo, rb_hi), yerr=(ylo, yhi),
                             c="k", marker="o", ls="none")
    theta = np.asarray(binned.value("theta_0 median"))
    terr = 0.5 * (np.asarray(binned.value("theta_0 low"))
                  + np.asarray(binned.value("theta_0 high")))
    plot.add_theta_profile(rb, theta, yerr=terr, c="k", marker="o", ls="none")
    plot.savefig(filename)
    import matplotlib.pyplot as plt
    plt.close(plot.figure)


def _have_matplotlib() -> bool:
    """Plots are optional: without matplotlib the fit still runs."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        logger.warning("matplotlib is not installed: skipping all plots")
        return False
    return True


def main(argv=None):
    parser = argparse.ArgumentParser(description="Run a full kinematics analysis.")
    parser.add_argument("config", help="JSON run-configuration file.")
    parser.add_argument("--chain", default=None,
                        help="Checkpoint file to restart from.")
    parser.add_argument("--skip-binned", action="store_true")
    parser.add_argument("--skip-profiles", action="store_true")
    args = parser.parse_args(argv)

    cfg = json.loads(pathlib.Path(args.config).read_text())
    prefix = cfg.get("prefix", "run")
    logging.basicConfig(level=logging.INFO,
                        handlers=[logging.StreamHandler(),
                                  logging.FileHandler(f"{prefix}.log")])
    logger.info("run configuration: %s", json.dumps(cfg, indent=1))

    from .. import configure_compile_cache

    logger.info("compilation cache: %s", configure_compile_cache())
    plots = _have_matplotlib()

    # The mesh (and especially a parallel.distributed block) must be set up
    # BEFORE any JAX computation: jax.distributed.initialize() raises if the
    # XLA backend is already live, and loading the catalog / building the
    # model below touches jnp.
    mesh = build_mesh(cfg.get("parallel"))

    from .. import units as u

    data = load_catalog(cfg["data"])
    logger.info("loaded %d stars", data.sample_size)
    background = build_background(cfg.get("background"),
                                  v_sys=float(cfg["data"].get("v_sys") or 0.0))

    model_cls = _model_registry()[cfg.get("model", "model_fit")]
    parameters = model_cls.default_parameters()
    for name, spec in cfg.get("parameters", {}).items():
        parameters[name].set(**spec)

    kwargs = {}
    if cfg.get("mge"):
        from ..utils.mge import get_mge
        mge_lum, mge_mass = get_mge(cfg["mge"])
        kwargs.update(mge_lum=mge_lum, mge_mass=mge_mass)
    elif cfg.get("mge_grid"):
        grid = {tuple(float(x) for x in key.split(",")): fname
                for key, fname in cfg["mge_grid"].items()}
        kwargs.update(mge_files=grid)
    if background is not None:
        kwargs.update(background=background)

    sampling = cfg.get("sampling", {})
    seed = sampling.get("seed", 123)
    fit = model_cls(data, parameters=parameters, seed=seed, **kwargs)

    # model tuning knobs (e.g. JAM quadrature orders) from the run config
    _MODEL_OPTIONS = {"n_u", "n_zeta"}
    for name, value in cfg.get("model_options", {}).items():
        if name not in _MODEL_OPTIONS:
            raise ValueError(f"Unknown model option '{name}' "
                             f"(supported: {sorted(_MODEL_OPTIONS)})")
        setattr(fit, name, int(value))
        logger.info("model option %s = %s", name, value)

    pos = None
    if args.chain:
        pos = fit.read_final_chain(args.chain)
        logger.info("restarting from %s (%d walkers)", args.chain, pos.shape[0])

    n_steps = sampling.get("n_steps", 500)
    if isinstance(n_steps, str) and n_steps != "auto":
        raise ValueError(
            f"sampling.n_steps must be an integer or the string \"auto\" "
            f"(got {n_steps!r}).")
    move = _normalize_move(sampling.get("move"))
    sampler_kind = sampling.get("sampler", "ensemble")
    if sampler_kind not in ("ensemble", "tempered", "hmc"):
        raise ValueError(f"Unknown sampling.sampler '{sampler_kind}' "
                         "(supported: ensemble, tempered, hmc).")
    if n_steps == "auto" and sampler_kind != "ensemble":
        raise ValueError('sampling.n_steps = "auto" requires the ensemble '
                         "sampler (tau-based auto-stop).")

    if mesh is not None:
        if sampler_kind == "hmc":
            raise ValueError("sampling.sampler = 'hmc' does not take a device "
                             "mesh; drop the parallel.axes block.")
        want = "tp" if sampler_kind == "tempered" else "dp"
        if want not in mesh.shape:
            raise ValueError(
                f"sampling.sampler = '{sampler_kind}' needs a '{want}' axis in "
                f"parallel.axes (got {dict(mesh.shape)}).")
    mesh_kw = {"mesh": mesh} if mesh is not None else {}
    n_burn = sampling.get("n_burn", 100)
    if sampler_kind == "tempered":
        sampler, log_z = fit.sample_tempered(
            n_walkers=sampling.get("n_walkers", 100), n_steps=n_steps,
            n_temps=int(sampling.get("n_temps", 8)),
            beta_min=float(sampling.get("beta_min", 1e-3)),
            swap_every=int(sampling.get("swap_every", 5)),
            pos=pos, move=move, **mesh_kw)
        logger.info("thermodynamic-integration log-evidence: %.4f", log_z)
        fit.save_current_status(sampler, prefix=prefix)
    elif sampler_kind == "hmc":
        sampler = fit.sample_hmc(
            n_walkers=sampling.get("n_walkers", 32), n_steps=n_steps,
            n_warmup=int(sampling.get("n_warmup", 200)),
            n_leapfrog=int(sampling.get("n_leapfrog", 10)),
            step_size=float(sampling.get("step_size", 0.05)), pos=pos)
        fit.save_current_status(sampler, prefix=prefix)
    elif n_steps == "auto":
        # tau-driven auto-stop: chunks of n_out until the chain certifies its
        # own convergence (Runner.sample_to_convergence); max_steps bounds it
        sampler = fit.sample_to_convergence(
            n_walkers=sampling.get("n_walkers", 100),
            max_steps=int(sampling.get("max_steps", 50_000)),
            check_every=int(sampling.get("n_out", 500)),
            tau_factor=float(sampling.get("tau_factor", 50.0)),
            pos=pos, prefix=prefix, move=move, **mesh_kw)
        logger.info("auto-stop: %d steps, converged=%s, tau=%s",
                    sampler.iteration, sampler.converged,
                    np.array2string(sampler.tau, precision=1))
        n_burn = sampling.get("n_burn")
        if n_burn is None:
            # emcee-recommended default: discard a few autocorrelation times
            n_burn = min(int(3 * float(np.max(sampler.tau))),
                         sampler.iteration // 2)
            logger.info("auto n_burn = %d (3 tau)", n_burn)
    else:
        sampler = fit(n_walkers=sampling.get("n_walkers", 100),
                      n_steps=n_steps,
                      n_out=sampling.get("n_out", 100),
                      pos=pos, prefix=prefix, move=move, **mesh_kw)

    best = fit.compute_bestfit_values(sampler.chain, n_burn=n_burn)
    print(best.to_pandas().to_string())
    if plots:
        fit.plot_chain(sampler.chain, filename=f"{prefix}_chains.png",
                       lnprob=sampler.lnprobability)
        fit.create_triangle_plot(sampler.chain, n_burn=n_burn,
                                 filename=f"{prefix}_corner.png")

    profile = None
    if not args.skip_profiles and hasattr(fit, "create_profiles"):
        prof_cfg = cfg.get("profiles", {})
        profile = fit.create_profiles(sampler.chain, n_burn=n_burn,
                                      filename=f"{prefix}_profile.ecsv",
                                      **({"n_samples": prof_cfg.get("n_samples", 100),
                                          "n_theta": prof_cfg.get("n_theta", 10)}
                                         if "n_samples" in
                                         fit.create_profiles.__code__.co_varnames
                                         else {}))
        logger.info("model profiles written to %s_profile.ecsv", prefix)

    if hasattr(fit, "compute_mass_posterior"):
        masses = fit.compute_mass_posterior(sampler.chain, n_burn=n_burn)
        lo, med, hi = np.percentile(masses, [16, 50, 84])
        logger.info("cluster mass: %.3e (+%.2e/-%.2e) Msun", med, hi - med, med - lo)
        np.save(f"{prefix}_mass_posterior.npy", masses)

    if not args.skip_binned:
        from ..pipelines import fit_radial_bins
        bcfg = cfg.get("binned", {})
        ra_c = fit.parameters["ra_center"].value
        dec_c = fit.parameters["dec_center"].value
        binned = fit_radial_bins(data, ra_c * u.deg, dec_c * u.deg,
                                 nstars=bcfg.get("nstars", 50),
                                 dlogr=bcfg.get("dlogr", 0.2),
                                 n_walkers=bcfg.get("n_walkers", 64),
                                 n_steps=bcfg.get("n_steps", 300), seed=seed,
                                 background=background)
        table = binned.summary(n_burn=bcfg.get("n_steps", 300) // 2)
        table.to_pandas().to_csv(f"{prefix}_binned.csv", index=False)
        logger.info("binned radial profile written to %s_binned.csv", prefix)

        # the headline diagnostic of the reference workflow (bin/run.py:107-143):
        # posterior model bands with the binned measurements overlaid
        if plots and profile is not None and "v_rot" in profile:
            make_overlay_plot(profile, table, f"{prefix}_overlay.png")
            logger.info("model-vs-binned overlay written to %s_overlay.png", prefix)

    logger.info("done.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
