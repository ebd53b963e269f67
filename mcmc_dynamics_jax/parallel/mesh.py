"""Device-mesh construction helpers."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

import jax
from jax.sharding import Mesh

__all__ = ["make_mesh", "factorize_devices"]


def factorize_devices(n_devices: int, n_axes: int = 2) -> Tuple[int, ...]:
    """Split a device count into an ``n_axes``-long mesh shape, as balanced
    as an exact factorization allows (largest factors on the leading axes)."""
    if n_axes < 1:
        raise ValueError(f"n_axes must be >= 1 (got {n_axes}).")
    if n_axes == 1:
        return (n_devices,)
    # peel off the largest factor <= the n_axes-th root for the LAST axis,
    # recurse on the rest: 8 devices x 3 axes -> (2, 2, 2); prefer balance:
    # find the factor closest to the root from below (>= 1 always divides)
    root = max(1, round(n_devices ** (1.0 / n_axes)))
    last = 1
    for f in range(1, n_devices + 1):
        if n_devices % f == 0 and f <= root:
            last = f
    return factorize_devices(n_devices // last, n_axes - 1) + (last,)


def make_mesh(axis_names: Sequence[str] = ("dp", "sp"),
              shape: Optional[Sequence[int]] = None,
              devices=None) -> Mesh:
    """Build a mesh over the available devices.

    Default axes for this workload: ``dp`` = walker (data-parallel analog) and
    ``sp`` = star axis (context/sequence-parallel analog: each device holds a slice
    of the catalog and lnlike partial sums are psum'd).  The shape comes from
    :func:`factorize_devices` alone and knows no topology, which fits devices
    joined all to all (NVLink).
    """
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if shape is None:
        shape = factorize_devices(n, len(axis_names))
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {tuple(shape)} needs "
                         f"{int(np.prod(shape))} devices, got {n}")
    dev_array = np.asarray(devices).reshape(shape)
    return Mesh(dev_array, axis_names=tuple(axis_names))
