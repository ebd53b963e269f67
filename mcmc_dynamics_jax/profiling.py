"""Observability: sampler throughput counters, step timing, and XLA trace capture.

The reference's only instrumentation is tqdm progress bars and per-chunk mean-lnP
console rows (runner.py:406-437).  Production accelerator sampling needs quantitative
telemetry: this module provides wall-clock/evals-per-second counters around sampler
runs and a context manager hooking ``jax.profiler`` so kernels can be inspected in
TensorBoard/Perfetto.
"""

from __future__ import annotations

import contextlib
import json
import logging
import time
from dataclasses import dataclass, field
from typing import Dict, List

logger = logging.getLogger(__name__)

__all__ = ["SamplerTelemetry", "trace", "benchmark_lnprob"]


@dataclass
class SamplerTelemetry:
    """Accumulates per-chunk sampling statistics.

    One lnprob evaluation = one walker proposal (each full ensemble step proposes
    every walker once).
    """

    n_walkers: int = 0
    records: List[Dict] = field(default_factory=list)

    @contextlib.contextmanager
    def chunk(self, n_steps: int):
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        evals = self.n_walkers * n_steps
        self.records.append({"steps": n_steps, "wall_s": dt,
                             "evals_per_sec": evals / dt if dt > 0 else float("inf")})

    @property
    def total_steps(self) -> int:
        return sum(r["steps"] for r in self.records)

    @property
    def total_wall(self) -> float:
        return sum(r["wall_s"] for r in self.records)

    @property
    def evals_per_sec(self) -> float:
        wall = self.total_wall
        return self.n_walkers * self.total_steps / wall if wall > 0 else float("inf")

    def summary(self) -> Dict:
        return {"n_walkers": self.n_walkers, "steps": self.total_steps,
                "wall_s": round(self.total_wall, 4),
                "evals_per_sec": round(self.evals_per_sec, 1)}

    def log(self):
        logger.info("sampler telemetry: %s", json.dumps(self.summary()))


@contextlib.contextmanager
def trace(log_dir: str = "/tmp/mcmcd_trace", create_perfetto_link: bool = False):
    """Capture an XLA profiler trace around a block (view in TensorBoard/Perfetto)."""
    import jax

    jax.profiler.start_trace(log_dir,
                             create_perfetto_link=create_perfetto_link)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()
        logger.info("XLA trace written to %s", log_dir)


def benchmark_lnprob(runner, n_walkers: int = 1024, n_steps: int = 50,
                     n_repeats: int = 3) -> Dict:
    """Measure sampling throughput of a model's lnprob on the current backend."""
    import numpy as np
    import jax
    import jax.numpy as jnp

    from .sampler import init_state, run_ensemble

    lnprob = runner.build_lnprob_batched()
    pos = runner.get_initials(n_walkers)
    state = init_state(lnprob, jnp.asarray(pos, runner.dtype),
                       jax.random.PRNGKey(0), batched=True)
    res = run_ensemble(lnprob, state, n_steps=n_steps, store_chain=False,
                       batched=True)
    _ = np.asarray(res.final.coords)  # warm-up + compile

    best = float("inf")
    for _ in range(n_repeats):
        t0 = time.perf_counter()
        res = run_ensemble(lnprob, res.final, n_steps=n_steps, store_chain=False,
                           batched=True)
        _ = np.asarray(res.final.coords)
        best = min(best, time.perf_counter() - t0)
    return {"backend": jax.default_backend(), "n_walkers": n_walkers,
            "n_steps": n_steps, "wall_s": round(best, 4),
            "evals_per_sec": round(n_walkers * n_steps / best, 1)}
