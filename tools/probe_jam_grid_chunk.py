"""Walker-chunk sweep for the JAM polar-grid tier, on-device.

``Axisymmetric.lnprob_chunk = 64`` was tuned for the DIRECT path at 1e3
stars (tools/probe_jam.py), where the per-walker pair table is ~6 MB and the
optimum came from the backend's tiling of the moment contraction.  The grid
tier changes both knobs: the solve runs at G = n_r x n_phi = 1536 positions
(~9 MB of pair tables per walker) and is followed by an (N, n_r) x (n_r,
chunk*K) interpolation matmul whose efficiency GROWS with the chunk.
This probe sweeps the chunk at the bench row's exact workload (16384 stars,
512 walkers, grid mode) with all variants interleaved in one process
(compare variants only within one process: cross-run timings drift).

    python tools/probe_jam_grid_chunk.py [chunk ...]
"""

import os
import sys

import numpy as np

sys.path.insert(0, ".")


def main():
    chunks = [int(c) for c in sys.argv[1:]] or [16, 32, 64, 128, 256]

    from bench import _measure, _mock_catalog
    from mcmc_dynamics_jax import units as u
    from mcmc_dynamics_jax.models import Axisymmetric
    from mcmc_dynamics_jax.utils import MgeReader, Table

    rng = np.random.default_rng(2)
    lum = MgeReader(Table({"i": u.Quantity([5000.0, 1000.0], "solLum/pc2"),
                           "s": u.Quantity([10.0, 40.0], "arcsec"),
                           "q": [0.9, 0.85]}), lum=True)
    mass = MgeReader(Table({"i": u.Quantity([5000.0, 1000.0], "solMass/pc2"),
                            "s": u.Quantity([10.0, 40.0], "arcsec"),
                            "q": [0.9, 0.85]}), lum=False)

    n_stars, n_walkers = 16384, 512
    data, ra_c, dec_c = _mock_catalog(n_stars, rng)
    params = Axisymmetric.default_parameters()
    for name, val in dict(d=5.0, beta=0.0, mbh=0.0, ra_center=ra_c,
                          dec_center=dec_c, rbh=1.0, delta_v=0.0).items():
        params[name].set(value=val, fixed=True)
    params["mlr"].set(value=2.0, min=0.1, max=10.0, fixed=False)
    params["barq"].set(value=0.4, fixed=False)
    params["kappa_x"].set(value=0.5, min=-2.0, max=2.0, fixed=False)
    params["kappa_y"].set(value=0.0, min=-2.0, max=2.0, fixed=False)

    d = {"mlr": rng.uniform(1.5, 2.5, n_walkers),
         "barq": rng.uniform(0.41, 0.45, n_walkers),
         "kappa_x": rng.uniform(0.3, 0.7, n_walkers),
         "kappa_y": rng.uniform(-0.1, 0.1, n_walkers)}

    os.environ["MCMC_JAM"] = "grid"
    lnprobs = {}
    dtype = None
    for c in chunks:
        fit = Axisymmetric(data, mge_mass=mass, mge_lum=lum,
                           parameters=params.copy())
        fit.jam_grid_chunk = c
        assert fit._jam_grid_spec() is not None
        free = fit.compiled.free_names
        pos = np.column_stack([d[n] for n in free])
        lnprobs[c] = (fit.build_lnprob_batched(), pos)
        dtype = fit.dtype

    best = {c: 0.0 for c in chunks}
    for rep in range(2):            # interleaved rounds, keep the best
        for c in chunks:
            fn, pos = lnprobs[c]
            rate = _measure(fn, pos, dtype, n_steps=80, repeats=2)
            best[c] = max(best[c], rate)
            print(f"rep {rep}  chunk {c:4d}  {rate:9.1f} evals/s", flush=True)
    print()
    for c in chunks:
        print(f"chunk {c:4d}  best {best[c]:9.1f} evals/s")


if __name__ == "__main__":
    main()
