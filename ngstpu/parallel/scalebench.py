"""Scaling-efficiency harness (BASELINE.md: >=80% efficiency 1 -> N).

Measures device-resident throughput of the sharded QC step (psum-merged
histograms — the reduceStats map-reduce of the reference,
fastq_count_kthread.c:180-210) and the sharded dedup sort over 1..N-device
'dp' meshes, reporting weak-scaling efficiency. Run on a host with
several cards:

    python -m ngstpu.parallel.scalebench [--reads-per-chip 262144] [--len 128]

With JAX_PLATFORMS=cpu and
XLA_FLAGS=--xla_force_host_platform_device_count=N this exercises the
mechanics (virtual CPU devices share the same cores, so the printed
efficiency there reflects the harness, not hardware). Inputs are
generated ON DEVICE so the measurement isolates compute+collectives from
host I/O, which bench.py covers.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np


def _bench_mesh(n_dev: int, reads_per_chip: int, read_len: int,
                iters: int = 5, skip_dsort: bool = False) -> dict:
    import jax
    import jax.numpy as jnp

    from .dist import shard_batch_arrays, sharded_qc_step
    from .mesh import make_mesh
    from ..ops.sortengine import dedup_sorted

    mesh = make_mesh(n_dev)
    B = reads_per_chip * n_dev
    rng = np.random.default_rng(0)
    seq = rng.integers(65, 85, (B, read_len), dtype=np.uint8)
    qual = rng.integers(33, 75, (B, read_len), dtype=np.uint8)
    lens = np.full(B, read_len - 10, np.int32)
    n_valid = np.full(n_dev, reads_per_chip, np.int32)

    step = sharded_qc_step(mesh)
    with mesh:
        args = shard_batch_arrays(mesh, seq, qual, lens, n_valid)
        merged, gc, packed = step(*args)  # compile + warm
        jax.block_until_ready((merged, gc, packed))
        t_best = float("inf")
        for _ in range(iters):
            t0 = time.monotonic()
            merged, gc, packed = step(*args)
            # real sync: reduce to scalar and pull
            float(jnp.sum(merged["len_hist"]))
            t_best = min(t_best, time.monotonic() - t0)

    # sharded dedup sort throughput (per-shard local sort under shard_map
    # is what distributed_sort runs twice; this is its compute kernel).
    # Keys pack 4 bytes/uint32 like production (bytes_to_words), not one
    # sort word per byte column of qc_step's packed output.
    from ..ops.sortengine import bytes_to_words_host, sort_partition

    sumq = rng.integers(0, 4000, B).astype(np.uint32)
    # device-resident: transfers excluded (bench.py covers the host path)
    pk = np.asarray(packed)
    if pk.shape[1] % 4:  # zero-pad to a whole number of u32 words
        pk = np.pad(pk, ((0, 0), (0, 4 - pk.shape[1] % 4)))
    wd = jnp.asarray(bytes_to_words_host(np.ascontiguousarray(pk)))
    ld = jnp.asarray(lens)
    qd = jnp.asarray(sumq)
    res = dedup_sorted(wd, ld, qd, jnp.int32(B), maybe_padding=False)
    jax.block_until_ready(res["perm"])
    t_sort = float("inf")
    for _ in range(max(iters - 2, 1)):
        t0 = time.monotonic()
        res = dedup_sorted(wd, ld, qd, jnp.int32(B), maybe_padding=False)
        int(res["n_groups"])
        t_sort = min(t_sort, time.monotonic() - t0)

    # the production single-chip device kernel (tools/pipeline
    # _sort_device_async): key-only sort — the sumQ representative is
    # host arithmetic (rep_counts_host) and these fixed-length keys skip
    # the length pass, two fewer LSD passes than dedup_sorted
    sp = sort_partition(wd, ld, jnp.int32(B), length_key=False,
                        maybe_padding=False)
    jax.block_until_ready(sp[0])
    t_prod = float("inf")
    for _ in range(max(iters - 2, 1)):
        t0 = time.monotonic()
        sp = sort_partition(wd, ld, jnp.int32(B), length_key=False,
                            maybe_padding=False)
        int(jnp.sum(sp[1].astype(jnp.int32)))
        t_prod = min(t_prod, time.monotonic() - t0)

    # full distributed ordered sort (sample-sort: local sorts + all_gather
    # splitters + bucket all_to_all + re-sort), end-to-end incl. shard puts
    from .dsort import distributed_sort

    t_dsort = float("inf")
    if not skip_dsort:
        words_np = np.asarray(wd)
        distributed_sort(mesh, words_np, lens)  # compile + warm
        for _ in range(max(iters - 2, 1)):
            t0 = time.monotonic()
            distributed_sort(mesh, words_np, lens)
            t_dsort = min(t_dsort, time.monotonic() - t0)

    out = dict(n_dev=n_dev, reads=B,
               qc_reads_per_s=B / t_best,
               dedup_reads_per_s=B / t_sort,
               dedup_prod_reads_per_s=B / t_prod)
    if not skip_dsort:
        out["dsort_reads_per_s"] = B / t_dsort
    return out


def main(argv: list[str] | None = None) -> int:
    import jax

    argv = sys.argv[1:] if argv is None else argv
    reads_per_chip, read_len = 262144, 128
    skip_dsort = False
    it = iter(argv)
    for a in it:
        if a == "--reads-per-chip":
            reads_per_chip = int(next(it))
        elif a == "--len":
            read_len = int(next(it))
        elif a == "--skip-dsort":
            skip_dsort = True
    n_all = len(jax.devices())
    sizes = sorted({1, 2, 4, n_all} & set(range(1, n_all + 1)))
    rows = [_bench_mesh(n, reads_per_chip, read_len, skip_dsort=skip_dsort)
            for n in sizes]
    base = rows[0]["qc_reads_per_s"]
    for r in rows:
        r["qc_scaling_eff"] = r["qc_reads_per_s"] / (base * r["n_dev"])
        print(json.dumps({k: round(v, 4) if isinstance(v, float) else v
                          for k, v in r.items()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
