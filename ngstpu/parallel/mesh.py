"""Device mesh construction for ngstpu's scale-out model.

The reference has no distributed layer at all (SURVEY.md §2c): its
parallelism is thread-per-file + a work-stealing kt_for. This design
replaces that with SPMD over a jax.sharding.Mesh:

- axis "dp": data parallelism over read batches / file shards — the analog
  of thread-per-file (reference fastq_count.c:213-231). Histograms and
  counters merge with psum over this axis.
- axis "coord" (when 2D): shards the genome-coordinate axis of pileup
  bins — this domain's "sequence parallelism".
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(n_devices: int | None = None, coord: int | None = None) -> Mesh:
    """1D ('dp',) mesh by default; any explicit `coord` (including 1) makes
    a 2D ('dp', 'coord') mesh so shard_maps addressing both axes always
    typecheck regardless of the coordinate-axis width."""
    devs = jax.devices()
    n = len(devs) if n_devices is None else n_devices
    if n > len(devs):
        raise ValueError(f"requested a {n}-device mesh, but only "
                         f"{len(devs)} devices are present")
    devs = devs[:n]
    if coord is not None:
        if n % coord:
            raise ValueError(f"n={n} not divisible by coord={coord}")
        arr = np.array(devs).reshape(n // coord, coord)
        return Mesh(arr, ("dp", "coord"))
    return Mesh(np.array(devs), ("dp",))
