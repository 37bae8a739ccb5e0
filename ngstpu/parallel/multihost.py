"""Multi-host scale-out orchestration.

The reference's only scale-out is thread-per-file on one machine
(reference fastq_count.c:213-231). The scale-out model here (SURVEY.md §2c):

- files/chunks are assigned to hosts deterministically (round-robin by
  size-descending order, so shards balance without coordination — no RPC,
  every process computes the same assignment);
- each host processes its shard locally (host I/O + its chips);
- fixed-shape statistics (the 128x512 quality matrix, length histograms,
  counters) merge with jax.lax.psum over the global mesh — the
  reduceStats map-reduce (fastq_count_kthread.c:180-210) as a
  cross-device collective;
- order-sensitive outputs are written per-shard and concatenated by rank
  order (deterministic writer).

Initialize with `jax.distributed.initialize(coordinator_address,
num_processes, process_id)` before use on several hosts; on one host
everything degrades to the local path.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np


def process_info() -> tuple[int, int]:
    """(process_index, process_count) — 1-process safe."""
    try:
        return jax.process_index(), jax.process_count()
    except Exception:
        return 0, 1


def assign_shards(paths: list[str], rank: int | None = None,
                  world: int | None = None) -> list[str]:
    """Deterministic file-shard assignment: stable size-descending order,
    round-robin over ranks (longest-processing-time heuristic). Every rank
    computes the same global assignment with no communication."""
    r, w = process_info()
    rank = r if rank is None else rank
    world = w if world is None else world
    sizes = []
    for p in paths:
        try:
            sizes.append(os.path.getsize(p))
        except OSError:
            sizes.append(0)
    order = sorted(range(len(paths)), key=lambda i: (-sizes[i], paths[i]))
    loads = [0] * world
    mine = []
    for i in order:
        tgt = min(range(world), key=lambda k: loads[k])
        loads[tgt] += max(sizes[i], 1)
        if tgt == rank:
            mine.append(paths[i])
    return mine


def allreduce_stats(arrays: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Sum fixed-shape host statistics across all hosts (the reduceStats
    merge as a DCN collective). Single-process: identity."""
    _, world = process_info()
    if world == 1:
        return arrays
    from jax.experimental import multihost_utils

    return {k: np.sum(multihost_utils.process_allgather(jnp.asarray(v)),
                      axis=0)
            for k, v in arrays.items()}
