"""Micro-benchmark: JAM batched-lnprob walker chunking on the attached device.

The batched Axisymmetric lnprob bounds its live pair-table footprint by
chunking the walker axis with ``lax.map(batch_size=lnprob_chunk)``
(models/jam/axisymmetric.py).  This probe sweeps the chunk size at a
production ensemble size so the default stays measured, not guessed.

Usage: python tools/probe_jam.py [W=512] [chunks=32,64,128,256,512]
       [nstars=1000] [jam=auto|grid|direct]

``jam=grid nstars=16384`` sweeps the chunk for the polar-grid tier, whose
per-walker working set (G grid points) differs from the direct engine's
(N stars) — tune the two independently.
"""
import os
import pathlib
import sys
import time
from functools import partial

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    from mcmc_dynamics_jax import units as u
    from mcmc_dynamics_jax.models import Axisymmetric
    from mcmc_dynamics_jax.utils import MgeReader, Table
    from bench import _mock_catalog

    kv = dict(x.split("=") for x in sys.argv[1:] if "=" in x)
    W = int(kv.get("W", 512))
    chunks = [int(c) for c in kv.get("chunks", "32,64,128,256,512").split(",")]
    n_steps = int(kv.get("steps", 100))
    n_stars = int(kv.get("nstars", 1000))
    if "jam" in kv:
        os.environ["MCMC_JAM"] = kv["jam"]

    # same model/catalog as bench_jam (bench.py) so rates are comparable
    rng = np.random.default_rng(2)
    data, ra_c, dec_c = _mock_catalog(n_stars, rng)
    lum = MgeReader(Table({"i": u.Quantity([5000.0, 1000.0], "solLum/pc2"),
                           "s": u.Quantity([10.0, 40.0], "arcsec"),
                           "q": [0.9, 0.85]}), lum=True)
    mass = MgeReader(Table({"i": u.Quantity([5000.0, 1000.0], "solMass/pc2"),
                            "s": u.Quantity([10.0, 40.0], "arcsec"),
                            "q": [0.9, 0.85]}), lum=False)
    params = Axisymmetric.default_parameters()
    for name, val in dict(d=5.0, beta=0.0, mbh=0.0, ra_center=ra_c,
                          dec_center=dec_c, rbh=1.0, delta_v=0.0).items():
        params[name].set(value=val, fixed=True)
    params["mlr"].set(value=2.0, min=0.1, max=10.0, fixed=False)
    params["barq"].set(value=0.4, fixed=False)
    params["kappa_x"].set(value=0.5, min=-2.0, max=2.0, fixed=False)
    params["kappa_y"].set(value=0.0, min=-2.0, max=2.0, fixed=False)
    fit = Axisymmetric(data, mge_mass=mass, mge_lum=lum, parameters=params)
    free = fit.compiled.free_names
    d = {"mlr": rng.uniform(1.5, 2.5, W),
         "barq": rng.uniform(0.41, 0.45, W),
         "kappa_x": rng.uniform(0.3, 0.7, W),
         "kappa_y": rng.uniform(-0.1, 0.1, W)}
    pos = np.column_stack([d[n] for n in free])

    from mcmc_dynamics_jax.sampler import init_state, run_ensemble

    for chunk in chunks:
        fit.lnprob_chunk = chunk
        lnprob = fit.build_lnprob_batched()
        state = init_state(lnprob, jnp.asarray(pos, fit.dtype),
                           jax.random.PRNGKey(0), batched=True)
        best = {}
        for steps in (n_steps, 2 * n_steps):
            res = run_ensemble(lnprob, state, n_steps=steps, batched=True)
            _ = np.asarray(res.final.coords)
            best[steps] = np.inf
            for _i in range(3):
                t0 = time.perf_counter()
                res = run_ensemble(lnprob, res.final, n_steps=steps,
                                   batched=True)
                _ = np.asarray(res.final.coords)
                best[steps] = min(best[steps], time.perf_counter() - t0)
        dt = best[2 * n_steps] - best[n_steps]
        if dt <= 0:
            dt = best[2 * n_steps] / 2.0
        rate = W * n_steps / dt
        print(f"W={W} chunk={chunk:4d}: {rate:12.3e} evals/s  (dt={dt:.3f}s)",
              flush=True)


if __name__ == "__main__":
    main()
