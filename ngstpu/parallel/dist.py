"""Distributed (multi-chip / multi-host) execution of the core pipelines.

Replaces the reference's single-machine parallelism (SURVEY.md §2c):
- per-file pthreads + mutex (fastq_count.c:213-231) -> batches sharded over
  the mesh "dp" axis, per-shard histograms merged with lax.psum over the
  device interconnect.
- reduceStats map-reduce (fastq_count_kthread.c:180-210) -> the same psum.
- pileup hash tables (bam2depth.c:86-110) -> sharded scatter-add of
  start/end deltas + psum, prefix-sum sweep replicated (coordinate axis
  sharding is this domain's sequence parallelism).

All functions take a Mesh and use shard_map so the collective layout is
explicit and compiled by XLA into collectives (NCCL on GPUs).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..ops.qcstep import qc_step
from ..ops.pileup import depth_deltas


def sharded_qc_step(mesh: Mesh):
    """Returns a jitted fn: (seq, qual, lens, n_valid_per_shard) -> stats.

    seq/qual [B, L] and lens [B] must have B divisible by mesh 'dp' size.
    n_valid: int32 [n_dp] — number of real rows in each shard.
    Histograms are psum-merged (replicated); gc/packed stay row-sharded.
    """

    def local(seq, qual, lens, n_valid):
        out = qc_step(seq, qual, lens, n_valid[0])
        merged = {
            "cycle_hist": jax.lax.psum(out["cycle_hist"], "dp"),
            "len_hist": jax.lax.psum(out["len_hist"], "dp"),
            "composition": jax.lax.psum(out["composition"], "dp"),
        }
        return merged, out["gc"], out["packed"]

    fn = shard_map(
        local, mesh=mesh,
        in_specs=(P("dp", None), P("dp", None), P("dp"), P("dp")),
        out_specs=({"cycle_hist": P(), "len_hist": P(), "composition": P()},
                   P("dp"), P("dp", None)),
    )
    return jax.jit(fn)


def sharded_pileup(mesh: Mesh, n_pos: int):
    """Returns jitted fn: (starts, ends, valid) -> depth [n_pos].

    Events are sharded over 'dp'; each shard scatters its deltas locally,
    deltas are psum-merged, and the prefix-sum sweep runs replicated.
    """

    def local(starts, ends, valid):
        d = depth_deltas(starts, ends, valid, n_pos)
        d = jax.lax.psum(d, "dp")
        return jnp.cumsum(d)[:-1]

    fn = shard_map(local, mesh=mesh,
                   in_specs=(P("dp"), P("dp"), P("dp")),
                   out_specs=P())
    return jax.jit(fn)


def shard_batch_arrays(mesh: Mesh, *arrays):
    """Device_put arrays with leading-axis 'dp' sharding."""
    out = []
    for a in arrays:
        spec = P("dp", *([None] * (a.ndim - 1)))
        out.append(jax.device_put(a, NamedSharding(mesh, spec)))
    return tuple(out)
