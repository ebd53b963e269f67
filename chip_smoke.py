"""Smoke test of the sampler's main path on a GPU.

Run from the repository root:

    python chip_smoke.py           # one GPU: the five phases below
    python chip_smoke.py --four    # four GPUs: the sharded samplers only

Each phase drives a user entry point at deployment size on the GPU and compares
what comes out with an independent float64 reference on the host, printing one
line with the result and the comparison.  A failed phase raises, so the exit
code is nonzero; the last line of a passing run is one JSON object naming the
device.  Without a GPU the script exits nonzero before any phase runs.

Phases (one GPU):
  1. ModelFit direct tier, 16384 walkers x 1e4 stars (Runner.__call__; on a CUDA
     device the tier runs the fused kernel of ops/lnlike_kernels.py).
  2. ModelFit tensor tier, 16384 walkers x 1e5 stars with finite a/r_peak priors.
  3. Binned ConstantFit profile (pipelines.fit_radial_bins) on the example catalog.
  4. JAM: cli.run on example/omega_cen_config.json, then lnprob of fixed walkers
     on the GPU in float32 against the same model in float64 on the CPU.
  5. SingleStars background above the device threshold (2e4 x 2e4 pairs).
Phases (--four): a dp x sp run_ensemble_sharded ModelFit at 4096 walkers x 1e5
stars and a 4-rung run_tempered_sharded ladder, each against one device.
"""

from __future__ import annotations

import argparse
import json
import math
import pathlib
import subprocess
import sys
import time

import numpy as np

ARCMIN_PER_RAD = 10800.0 / math.pi
RA_C, DEC_C = 201.697, -47.48


# ------------------------------------------------------------------ references
def modelfit_reference(fit, pos):
    """float64 NumPy lnprob of a fixed-centre ModelFit, walker by walker
    (independent of every tier: per-star terms, plain divides and logs)."""
    import jax

    dx, dy = fit.fixed_center_offsets()
    dx, dy = dx * ARCMIN_PER_RAD, dy * ARCMIN_PER_RAD
    r2 = dx * dx + dy * dy
    v, e2 = fit._host_arrays["v"], fit._host_arrays["verr"] ** 2
    scale = fit.compiled.scale_factors({"a": "arcmin", "r_peak": "arcmin"})
    names = fit.compiled.free_names
    lp = np.asarray(jax.jit(jax.vmap(fit.compiled.lnprior))(pos), np.float64)
    out = np.empty(len(pos))
    for w, theta in enumerate(np.asarray(pos, np.float64)):
        p = dict(zip(names, theta))
        a, rp = p["a"] * scale["a"], p["r_peak"] * scale["r_peak"]
        v_los = p["v_sys"] + 2.0 * (dy * p["v_maxx"] - dx * p["v_maxy"]) \
            / (rp * (1.0 + r2 / rp ** 2))
        n = e2 + p["sigma_max"] ** 2 / np.sqrt(1.0 + r2 / a ** 2)
        out[w] = -0.5 * np.sum(np.log(2.0 * np.pi * n) + (v - v_los) ** 2 / n)
    return np.where(np.isfinite(lp), lp + out, -np.inf)


def compare(name, got, ref, rtol, atol):
    """Raise unless ``got`` matches ``ref`` (finite pattern and values);
    return a one-line summary of the worst deviation and the bound."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    ok = np.isfinite(ref)
    if ok.sum() == 0:
        raise AssertionError(f"{name}: no finite reference values")
    if not (np.isfinite(got) == ok).all():
        raise AssertionError(f"{name}: finite pattern differs from reference")
    err = np.abs(got[ok] - ref[ok])
    bound = atol + rtol * np.abs(ref[ok])
    worst = int(np.argmax(err / bound))
    if not (err <= bound).all():
        raise AssertionError(
            f"{name}: |d| {err[worst]:.4g} > {bound[worst]:.4g} "
            f"(rtol {rtol}, atol {atol}, ref {ref[ok][worst]:.6g})")
    return (f"{int(ok.sum())} values, max|d| {err.max():.3g}, "
            f"max rel {np.max(err / np.abs(ref[ok])):.3g} "
            f"<= rtol {rtol} + atol {atol}")


def assert_kernel_compiled(fn, x):
    """The direct tier must run the fused kernel on a CUDA device (no quiet
    fallback to the reference): find it in the compiled program."""
    import jax

    text = jax.jit(fn).lower(x).compile().as_text()
    if "model_lnlike" not in text:
        raise AssertionError("direct tier did not compile the fused kernel")


# ------------------------------------------------------------------ catalogs
def modelfit(n_stars, seed, bounded=True):
    from mcmc_dynamics_jax.mock import make_mock_cluster
    from mcmc_dynamics_jax.models import ModelFit

    data, _ = make_mock_cluster(n_stars=n_stars, ra_center=RA_C,
                                dec_center=DEC_C, sigma_max=15.0, v_max=6.0,
                                theta_0=0.7, r_peak=120.0, a=150.0, seed=seed)
    params = ModelFit.default_parameters()
    params["ra_center"].set(value=RA_C, fixed=True)
    params["dec_center"].set(value=DEC_C, fixed=True)
    params["sigma_max"].set(min=0.0, max=60.0,
                            initials="rng.uniform(8, 25, size=n)")
    for name in ("r_peak", "a"):
        params[name].set(initials="rng.uniform(60, 400, size=n)")
        if bounded:
            params[name].set(min=10.0, max=1000.0)
    return ModelFit(data, parameters=params, seed=seed)


# ------------------------------------------------------------------ phases
def phase_direct(n_walkers=16384, n_stars=10_000, n_steps=40, check=256):
    """ModelFit direct tier through Runner.__call__."""
    import jax.numpy as jnp

    fit = modelfit(n_stars, seed=1)
    if fit._tensor_eligible() or fit._sufficient_eligible():
        raise AssertionError("expected the direct tier at this catalog size")
    lnprob = fit._batched_lnprob_cached()
    assert_kernel_compiled(lnprob, jnp.zeros((n_walkers // 2, 6), fit.dtype)
                           + jnp.asarray(fit.get_initials(1), fit.dtype))
    result = fit(n_walkers=n_walkers, n_steps=n_steps, prefix=None)
    final = result.chain[:check, -1, :]
    # f32 sums of 1e4 terms of magnitude ~3: rounding ~1e-6 relative
    return compare("direct", result.lnprobability[:check, -1],
                   modelfit_reference(fit, final), rtol=2e-6, atol=0.0) \
        + f"; acceptance {np.mean(result.acceptance_fraction):.3f}"


def phase_tensor(n_walkers=16384, n_stars=100_000, n_steps=20, check=256):
    """ModelFit at survey size: auto dispatch must pick the tensor tier."""
    fit = modelfit(n_stars, seed=2)
    if not fit._tensor_eligible():
        raise AssertionError("expected the tensor tier at this catalog size")
    result = fit(n_walkers=n_walkers, n_steps=n_steps, prefix=None)
    final = result.chain[:check, -1, :]
    # Chebyshev truncation at the float32 floor plus full-f32 contractions
    # (ModelTensorStats.lnlike): measured 1.04e-6 relative at these widths
    return compare("tensor", result.lnprobability[:check, -1],
                   modelfit_reference(fit, final), rtol=1e-5, atol=0.0)


def phase_binned(nstars=600, dlogr=0.05, n_walkers=32, n_steps=200):
    """Binned ConstantFit profile (pipelines.fit_radial_bins, sufficient tier)."""
    import jax

    from mcmc_dynamics_jax import units as u
    from mcmc_dynamics_jax.cli.run import load_catalog
    from mcmc_dynamics_jax.pipelines import fit_radial_bins
    from mcmc_dynamics_jax.utils.coordinates import xy_offset_rad

    cfg = json.loads(pathlib.Path("example/omega_cen_config.json").read_text())
    data = load_catalog(cfg["data"])
    ra_c = cfg["parameters"]["ra_center"]["value"]
    dec_c = cfg["parameters"]["dec_center"]["value"]
    res = fit_radial_bins(data, ra_c * u.deg, dec_c * u.deg, nstars=nstars,
                          dlogr=dlogr, n_walkers=n_walkers, n_steps=n_steps)
    ra = np.radians(np.asarray(data.data.value("ra", "deg"), np.float64))
    dec = np.radians(np.asarray(data.data.value("dec", "deg"), np.float64))
    dx, dy = xy_offset_rad(ra, dec, math.radians(ra_c), math.radians(dec_c),
                           xp=np)
    r = np.hypot(dx, dy)
    safe = np.where(r > 0, r, 1.0)
    gx, gy = np.where(r > 0, dy / safe, 0.0), np.where(r > 0, -dx / safe, 0.0)
    v = np.asarray(data.data.value("v", "km/s"), np.float64)
    e2 = np.asarray(data.data.value("verr", "km/s"), np.float64) ** 2
    bins = np.asarray(data.data["bin"])
    lnprior = jax.jit(jax.vmap(res.template.compiled.lnprior))
    got, ref = [], []
    for b in range(res.n_bins):
        sel = bins == b
        final = res.chains[b][:, -1, :]
        for lp, (vs, sg, vx, vy) in zip(np.asarray(lnprior(final)), final):
            n = e2[sel] + sg * sg
            vl = vs + gx[sel] * vx + gy[sel] * vy
            ref.append(lp - 0.5 * np.sum(np.log(2 * np.pi * n)
                                         + (v[sel] - vl) ** 2 / n))
        got.extend(res.log_probs[b][:, -1])
    if not res.template._sufficient_eligible():
        raise AssertionError("expected the sufficient tier")
    # Chebyshev tables at the float32 truncation floor: measured 1.9e-6
    # relative on the card
    return f"{res.n_bins} bins x {n_walkers} walkers: " + compare(
        "binned", got, ref, rtol=2e-5, atol=0.0)


def _jam_fit(cfg, dtype=None):
    from mcmc_dynamics_jax.cli.run import _model_registry, load_catalog
    from mcmc_dynamics_jax.utils.mge import get_mge

    cls = _model_registry()[cfg["model"]]
    params = cls.default_parameters()
    for name, spec in cfg["parameters"].items():
        params[name].set(**spec)
    lum, mass = get_mge(cfg["mge"])
    return cls(load_catalog(cfg["data"]), parameters=params, seed=1,
               mge_lum=lum, mge_mass=mass, dtype=dtype)


def phase_jam(config="example/omega_cen_config.json", n_check=64):
    """cli.run end to end, then JAM lnprob on the GPU (float32) against the
    same model evaluated in float64 on the CPU."""
    import jax
    import jax.numpy as jnp

    from mcmc_dynamics_jax.cli import run as cli_run

    if cli_run.main([config]) != 0:
        raise AssertionError("cli.run failed")
    cfg = json.loads(pathlib.Path(config).read_text())
    fit = _jam_fit(cfg)
    pos = fit.get_initials(n_check)
    got = np.asarray(jax.jit(fit.build_lnprob_batched())(
        jnp.asarray(pos, fit.dtype)))
    jax.config.update("jax_enable_x64", True)
    try:
        with jax.default_device(jax.devices("cpu")[0]):
            ref_fit = _jam_fit(cfg, dtype=jnp.float64)
            ref = np.asarray(jax.jit(ref_fit.build_lnprob_batched())(
                jnp.asarray(pos, jnp.float64)))
    finally:
        jax.config.update("jax_enable_x64", False)
    # tolerance of the accelerator-vs-CPU JAM gate (see PERF.md, precision)
    return f"{fit.n_data} stars: " + compare("jam", got, ref, rtol=2e-5,
                                             atol=0.1)


def phase_background(n_catalog=20_000, n_targets=20_000, check=512):
    """SingleStars KDE background on the device vs the float64 NumPy formula."""
    from mcmc_dynamics_jax import units as u
    from mcmc_dynamics_jax.background import SingleStars

    rng = np.random.default_rng(5)
    vcat = rng.normal(-20.0, 40.0, n_catalog)
    v = rng.normal(0.0, 15.0, n_targets)
    verr = 0.5 + 2.0 * rng.random(n_targets)
    bg = SingleStars(u.Quantity(vcat, "km/s"))
    if n_targets * n_catalog <= bg._DEVICE_THRESHOLD:
        raise AssertionError("size must be above the device threshold")
    got = bg(v, verr, sigma_int=1.0)[:check]
    norm = 1.0 + verr[:check] ** 2
    expo = -np.subtract.outer(vcat, v[:check]) ** 2 / (2.0 * norm)
    top = expo.max(axis=0)
    ref = top + np.log(np.exp(expo - top).sum(axis=0)) \
        - 0.5 * np.log(2.0 * np.pi * norm) - np.log(n_catalog)
    # float32 exponents of magnitude <~ 50 and a 2e4-term sum
    return compare("background", got, ref, rtol=1e-5, atol=1e-4)


def phase_sharded(n_walkers=4096, n_stars=100_000, n_steps=20, check=256):
    """dp x sp run_ensemble_sharded ModelFit over every device, against the
    one-device direct tier and the float64 NumPy reference."""
    import jax

    from mcmc_dynamics_jax.parallel import make_mesh, run_ensemble_sharded
    from mcmc_dynamics_jax.sampler import make_key

    fit = modelfit(n_stars, seed=3)
    mesh = make_mesh(("dp", "sp"))
    res = run_ensemble_sharded(fit, fit.get_initials(n_walkers), make_key(3),
                               n_steps, mesh)
    spans = len(res.final_coords.sharding.device_set)
    if spans != len(jax.devices()):
        raise AssertionError(f"result spans {spans} devices")
    coords = np.asarray(res.final_coords, fit.dtype)[:check]
    data = fit.prepare_data(dict(fit._data_arrays))
    lnprior = jax.vmap(fit.compiled.lnprior)
    one = jax.jit(lambda t: lnprior(t) + fit._direct_lnlike(t, data))
    ref = np.asarray(one(jax.device_put(coords, jax.devices()[0])))
    got = np.asarray(res.final_log_prob)[:check]
    return (f"mesh {dict(mesh.shape)}, result on {spans} devices: vs one "
            "device " + compare("sharded", got, ref, rtol=2e-6, atol=0.0)
            + "; vs float64 " + compare("sharded-f64", got,
                                        modelfit_reference(fit, coords),
                                        rtol=2e-6, atol=0.0))


def phase_tempered(n_walkers=1024, n_stars=10_000, n_steps=20):
    """4-rung run_tempered_sharded ladder, one rung per device."""
    import jax

    from mcmc_dynamics_jax.parallel import make_mesh, run_tempered_sharded
    from mcmc_dynamics_jax.sampler import make_key

    fit = modelfit(n_stars, seed=4)
    mesh = make_mesh(("tp",))
    res = run_tempered_sharded(fit, fit.get_initials(n_walkers), make_key(4),
                               n_steps, mesh, beta_min=0.1)
    spans = len(res.final.coords.sharding.device_set)
    if spans != len(jax.devices()):
        raise AssertionError(f"ladder spans {spans} devices")
    coords = np.asarray(res.final.coords, fit.dtype)
    one = jax.jit(fit._batched_lnprob_cached())
    ref = np.stack([np.asarray(one(jax.device_put(c, jax.devices()[0])))
                    for c in coords])
    return (f"{coords.shape[0]} rungs on {spans} devices, swap acceptance "
            f"{np.round(np.asarray(res.swap_acceptance), 3).tolist()}: "
            + compare("tempered", np.asarray(res.final.log_prob), ref,
                      rtol=2e-6, atol=0.0))


SINGLE = [("modelfit-direct", phase_direct), ("modelfit-tensor", phase_tensor),
          ("binned-constant", phase_binned), ("jam-cli", phase_jam),
          ("singlestars-background", phase_background)]
FOUR = [("sharded-dp-sp", phase_sharded), ("tempered-ladder", phase_tempered)]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--four", action="store_true",
                        help="run the sharded samplers on four GPUs instead")
    args = parser.parse_args(argv)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip(), flush=True)

    import jax

    if jax.default_backend() != "gpu":
        print(f"no GPU: JAX backend is {jax.default_backend()!r}",
              file=sys.stderr)
        return 1
    devices = jax.devices()
    if args.four and len(devices) != 4:
        print(f"--four needs 4 GPUs, found {len(devices)}", file=sys.stderr)
        return 1

    from mcmc_dynamics_jax import configure_compile_cache

    print(f"compile cache: {configure_compile_cache()}", flush=True)
    for name, phase in (FOUR if args.four else SINGLE):
        t0 = time.perf_counter()
        detail = phase()
        print(f"[{name}] ok ({time.perf_counter() - t0:.1f} s): {detail}",
              flush=True)

    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
