"""Distributed dedup/sort over the 'dp' mesh axis.

The global dedup problem (gzfastq_uniq at 10M+ reads, SURVEY.md §7 "global
dedup at scale") sharded across chips:

1. every shard owns a row slice of the packed key matrix;
2. rows route to the shard that owns their key's hash bucket via
   jax.lax.all_to_all (equal keys share a hash, so every duplicate group
   lands whole on one shard — global ORDER is not needed for grouping);
3. each shard runs the local LSD dedup on what it received;
4. heads/counts are already exact; the host k-way-merges the per-shard
   key-sorted head lists when a globally sorted output is required.

Bucket capacity is provisioned at pad_factor x fair share; overflowing
rows would be dropped silently by the scatter, so the kernel also returns
per-shard received counts for the caller to validate (a production run
would re-shard with a bigger factor on overflow).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

FNV_OFFSET = np.uint32(2166136261)
FNV_PRIME = np.uint32(16777619)


def _hash_rows(words: jax.Array, lens: jax.Array) -> jax.Array:
    """FNV-1a over the key words + length, vectorized. uint32 [b]."""
    h = jnp.full(words.shape[:1], FNV_OFFSET, jnp.uint32)
    W = words.shape[1]
    for w in range(W):
        for shift in (0, 8, 16, 24):
            byte = (words[:, w] >> shift) & 0xFF
            h = (h ^ byte.astype(jnp.uint32)) * FNV_PRIME
    h = (h ^ lens.astype(jnp.uint32)) * FNV_PRIME
    return h


@partial(jax.jit, static_argnames=("mesh", "pad_factor"))
def exchange_dedup(words, lens, sumq, gidx, valid, *, mesh: Mesh,
                   pad_factor: float = 2.0):
    """Fused one-program distributed dedup: hash-bucket all_to_all exchange
    + per-shard stable LSD dedup sort, all inside ONE shard_map — shards
    dedup concurrently on device, and the host only ever sees the sorted
    result columns (no full-matrix round-trip between exchange and dedup).

    (words, lens, sumq, gidx, valid), sharded over 'dp' ->
    (s_words, s_lens, s_gidx, is_head, s_valid), each shard's slice sorted
    by (key words, len, -sumq, global idx) with invalid filler rows last —
    so each group's first row is the representative the single-chip path
    keeps (max sumQ, earliest original index; gzfastq_uniq.c:226).
    """
    n_dp = mesh.devices.size

    def local(words, lens, sumq, gidx, valid):
        b, W = words.shape
        cap = int(pad_factor * b / n_dp) + 8
        h = _hash_rows(words, lens)
        bucket = (h % n_dp).astype(jnp.int32)
        bucket = jnp.where(valid, bucket, n_dp)

        idx = jax.lax.broadcasted_iota(jnp.int32, (b,), 0)
        _, order = jax.lax.sort((bucket, idx), num_keys=1, is_stable=True)
        s_bucket = jnp.take(bucket, order)
        pos = idx - jnp.searchsorted(s_bucket, s_bucket, side="left")
        ok = (pos < cap) & (s_bucket < n_dp)
        dest = jnp.where(ok, s_bucket * cap + pos, n_dp * cap)

        def scatter(x, fill):
            flat = jnp.full((n_dp * cap + 1,) + x.shape[1:], fill, x.dtype)
            flat = flat.at[dest].set(jnp.take(x, order, axis=0))
            return flat[:-1].reshape((n_dp, cap) + x.shape[1:])

        rw = jax.lax.all_to_all(scatter(words, 0), "dp", 0, 0, tiled=False)
        rl = jax.lax.all_to_all(scatter(lens, 0), "dp", 0, 0, tiled=False)
        rq = jax.lax.all_to_all(scatter(sumq, 0), "dp", 0, 0, tiled=False)
        ri = jax.lax.all_to_all(scatter(gidx, 0), "dp", 0, 0, tiled=False)
        rv = jax.lax.all_to_all(scatter(valid.astype(jnp.int32), 0),
                                "dp", 0, 0, tiled=False)
        m = n_dp * cap
        rw = rw.reshape((m, W))
        rl = rl.reshape(m)
        rq = rq.reshape(m)
        ri = ri.reshape(m)
        rv = rv.reshape(m) == 1

        # local dedup sort: global idx as the final key makes ties resolve
        # exactly like the single-chip stable sort
        from ..ops.sortengine import _lsd_perm, _order_u32

        ops = [(~rv).astype(jnp.uint32)]
        ops.extend(rw[:, w] for w in range(W))
        ops.append(_order_u32(rl))
        ops.append(_order_u32(-rq.astype(jnp.int32)))
        ops.append(_order_u32(ri))
        perm = _lsd_perm(ops)
        sw = jnp.take(rw, perm, axis=0)
        sl = jnp.take(rl, perm)
        si = jnp.take(ri, perm)
        sv = jnp.take(rv, perm)
        same = jnp.all(sw[1:] == sw[:-1], axis=1) & (sl[1:] == sl[:-1]) \
            & sv[1:] & sv[:-1]
        is_head = jnp.concatenate([jnp.ones((1,), bool), ~same]) & sv
        return sw, sl, si, is_head, sv

    fn = shard_map(local, mesh=mesh,
                   in_specs=(P("dp", None), P("dp"), P("dp"), P("dp"),
                             P("dp")),
                   out_specs=(P("dp", None), P("dp"), P("dp"), P("dp"),
                              P("dp")))
    return fn(words, lens, sumq, gidx, valid)


def _lex_gt_key(rows, key):
    """rows [b, C] > key [C] lexicographically (strict), vectorized."""
    import jax.numpy as _jnp

    gt = _jnp.zeros(rows.shape[0], bool)
    eq = _jnp.ones(rows.shape[0], bool)
    for c in range(rows.shape[1]):
        gt = gt | (eq & (rows[:, c] > key[c]))
        eq = eq & (rows[:, c] == key[c])
    return gt


@partial(jax.jit, static_argnames=("mesh", "length_first", "pad_factor"))
def sample_sort(words, lens, gidx, valid, *, mesh: Mesh, length_first: bool,
                pad_factor: float):
    """distributed_sort's one device program: per-shard LSD sort, splitter
    all_gather, bucket all_to_all, per-shard re-sort. Returns each shard's
    (original row index, valid) in global key order."""
    from ..ops.sortengine import _lsd_perm

    n_dp = mesh.devices.size
    W = words.shape[1]

    def local(words, lens, gidx, valid):
        b = words.shape[0]
        cap = int(pad_factor * b / n_dp) + 8
        cols = [(~valid).astype(jnp.uint32)]
        if length_first:
            cols.append(lens.astype(jnp.uint32))
        cols.extend(words[:, w] for w in range(W))
        cols.append(gidx.astype(jnp.uint32))
        K = jnp.stack(cols, axis=1)  # [b, C]; unique rows (gidx column)
        C = K.shape[1]
        perm = _lsd_perm([K[:, c] for c in range(C)])
        sK = jnp.take(K, perm, axis=0)
        sv = jnp.take(valid, perm)

        # regular samples of the locally sorted rows -> global splitters
        samp_pos = (jnp.arange(n_dp, dtype=jnp.int32) * b) // n_dp
        samples = jnp.take(sK, samp_pos, axis=0)
        allsamp = jax.lax.all_gather(samples, "dp", axis=0, tiled=True)
        sperm = _lsd_perm([allsamp[:, c] for c in range(C)])
        s_sorted = jnp.take(allsamp, sperm, axis=0)
        spl_pos = jnp.arange(1, n_dp, dtype=jnp.int32) * n_dp - 1
        splitters = jnp.take(s_sorted, spl_pos, axis=0)  # [n_dp-1, C]

        # bucket = number of splitters strictly below the row; monotone
        # over the sorted rows, so in-bucket position is index arithmetic
        bucket = jnp.zeros(b, jnp.int32)
        for s in range(n_dp - 1):
            bucket = bucket + _lex_gt_key(sK, splitters[s]).astype(jnp.int32)
        idx = jax.lax.broadcasted_iota(jnp.int32, (b,), 0)
        pos = idx - jnp.searchsorted(bucket, bucket, side="left")
        ok = (pos < cap) & sv
        dest = jnp.where(ok, bucket * cap + pos, n_dp * cap)

        def scatter(x, fill):
            flat = jnp.full((n_dp * cap + 1,) + x.shape[1:], fill, x.dtype)
            flat = flat.at[dest].set(x)
            return flat[:-1].reshape((n_dp, cap) + x.shape[1:])

        sKx = scatter(sK, 0)
        svx = scatter(sv.astype(jnp.int32), 0)
        rK = jax.lax.all_to_all(sKx, "dp", 0, 0, tiled=False)
        rv = jax.lax.all_to_all(svx, "dp", 0, 0, tiled=False)
        m = n_dp * cap
        rK = rK.reshape(m, C)
        rv = rv.reshape(m) == 1
        # final per-shard sort; invalid filler rows forced last
        rK = rK.at[:, 0].set((~rv).astype(jnp.uint32))
        perm2 = _lsd_perm([rK[:, c] for c in range(C)])
        out_idx = jnp.take(rK[:, C - 1], perm2)
        out_valid = jnp.take(rv, perm2)
        return out_idx.astype(jnp.int32), out_valid

    fn = shard_map(local, mesh=mesh,
                   in_specs=(P("dp", None), P("dp"), P("dp"), P("dp")),
                   out_specs=(P("dp"), P("dp")))
    return fn(words, lens, gidx, valid)


def distributed_sort(mesh: Mesh, words: np.ndarray, lens: np.ndarray,
                     length_first: bool = True, pad_factor: float = 2.0
                     ) -> np.ndarray:
    """Splitter-based distributed ordered sort (sample sort) over 'dp'.

    The multi-chip gzfastq_sort: per-shard LSD sort, regular sampling,
    all_gather'd splitter selection, bucket all_to_all exchange, per-shard
    re-sort — concatenated shards are globally sorted. Returns perm: the
    ORIGINAL row indices in global key order, identical to the single-chip
    lex_argsort(words, lens, length_first) (the original index rides the
    key as the final column, so ties resolve exactly like the stable sort).
    """
    n_dp = mesh.devices.size
    B = words.shape[0]
    pad = (-B) % n_dp
    if pad:
        words = np.pad(words, ((0, pad), (0, 0)))
        lens = np.pad(lens, (0, pad))
    gidx = np.arange(len(lens), dtype=np.int32)
    valid = gidx < B
    # Round-robin re-shard: shard d gets rows d, d+n_dp, ... Contiguous
    # sharding breaks the sample-sort cap invariant when keys correlate
    # with input position (e.g. name sorts of sequentially named reads):
    # one sender then routes its WHOLE slice to one bucket. Interleaving
    # bounds every sender's per-bucket load at ~(global run)/n_dp. gidx
    # still carries the original index, so the returned perm is unaffected.
    rr = np.arange(len(lens)).reshape(-1, n_dp).T.reshape(-1)
    words, lens, gidx, valid = words[rr], lens[rr], gidx[rr], valid[rr]

    with mesh:
        sharding = NamedSharding(mesh, P("dp", None))
        shard1 = NamedSharding(mesh, P("dp"))
        oi, ov = sample_sort(jax.device_put(words, sharding),
                             jax.device_put(lens.astype(np.int32), shard1),
                             jax.device_put(gidx, shard1),
                             jax.device_put(valid, shard1), mesh=mesh,
                             length_first=length_first,
                             pad_factor=pad_factor)
        if any(d.process_index != jax.process_index()
               for d in mesh.devices.flat):
            # multi-controller: only local shards are addressable; tiled
            # process_allgather reassembles the dp-major global layout
            from jax.experimental import multihost_utils

            oi = np.asarray(multihost_utils.process_allgather(oi,
                                                              tiled=True))
            ov = np.asarray(multihost_utils.process_allgather(ov,
                                                              tiled=True))
        else:
            oi, ov = np.asarray(oi), np.asarray(ov)
    if int(ov.sum()) != B:
        raise RuntimeError(
            f"bucket overflow: kept {int(ov.sum())} of {B} rows — "
            f"increase pad_factor")
    return oi[ov].astype(np.int64)


def distributed_dedup(mesh: Mesh, words: np.ndarray, lens: np.ndarray,
                      sumq: np.ndarray, pad_factor: float = 2.0):
    """Full-array entry: shard, exchange, local dedup per shard.

    Returns (keys, klens, counts, rep) as host arrays in GLOBAL key-sorted
    order (key-sorted within each hash shard, then host-merged by key).
    `rep` holds each group's representative as an ORIGINAL row index —
    the first occurrence achieving the maximum quality sum, bit-identical
    to the single-chip dedup_groups result (the global index rides the
    all_to_all as the stable sort's final key).

    Exchange and per-shard dedup run fused in ONE shard_map program
    (exchange_dedup): shards dedup concurrently on device and the host
    only receives the sorted result columns.
    """
    n_dp = mesh.devices.size
    B = words.shape[0]
    pad = (-B) % n_dp
    if pad:
        words = np.pad(words, ((0, pad), (0, 0)))
        lens = np.pad(lens, (0, pad))
        sumq = np.pad(sumq, (0, pad))
    valid = np.arange(len(lens)) < B
    gidx = np.arange(len(lens), dtype=np.int32)

    with mesh:
        args = [jax.device_put(a, NamedSharding(mesh, P("dp", *([None] * (a.ndim - 1)))))
                for a in (words, lens.astype(np.int32),
                          sumq.astype(np.uint32), gidx, valid)]
        sw, sl, si, ih, sv = exchange_dedup(*args, mesh=mesh,
                                            pad_factor=pad_factor)

        multi = any(d.process_index != jax.process_index()
                    for d in mesh.devices.flat)

        def pull(x):
            # multi-controller runs hold only the local shards; tiled
            # process_allgather reassembles the same dp-major layout
            # np.asarray yields single-process
            if multi:
                from jax.experimental import multihost_utils

                return np.asarray(
                    multihost_utils.process_allgather(x, tiled=True))
            return np.asarray(x)

        sw, sl, si, ih, sv = (pull(sw), pull(sl), pull(si), pull(ih),
                              pull(sv))

    # received row count sanity (overflow detection)
    if int(sv.sum()) != B:
        raise RuntimeError(
            f"bucket overflow: received {int(sv.sum())} of {B} rows — "
            f"increase pad_factor")

    # group math per shard slice (valid rows sort first within a shard)
    per = sw.shape[0] // n_dp
    out_keys, out_counts, out_lens, out_rep = [], [], [], []
    for d in range(n_dp):
        sl_ = slice(d * per, (d + 1) * per)
        nv = int(sv[sl_].sum())
        if nv == 0:
            continue
        head_pos = np.flatnonzero(ih[sl_][:nv])
        counts = np.diff(np.append(head_pos, nv))
        out_keys.append(sw[sl_][head_pos])
        out_lens.append(sl[sl_][head_pos])
        out_counts.append(counts)
        out_rep.append(si[sl_][head_pos])
    if not out_keys:
        return (np.zeros((0, words.shape[1]), words.dtype),
                np.zeros(0, np.int32), np.zeros(0, np.int64),
                np.zeros(0, np.int64))
    keys = np.concatenate(out_keys)
    klens = np.concatenate(out_lens)
    counts = np.concatenate(out_counts)
    rep = np.concatenate(out_rep).astype(np.int64)
    # global key order: host lexsort over (words..., len)
    order = np.lexsort(tuple([klens] + [keys[:, w]
                                        for w in range(keys.shape[1] - 1, -1, -1)]))
    return keys[order], klens[order], counts[order], rep[order]
