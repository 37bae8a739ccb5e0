"""Fused per-batch QC step — the framework's flagship device computation.

One jitted pass over a padded read batch computing everything the QC-side
tools need (reference tools fastq_count, bam_sliding_count's GC,
Rgzfastq_uniq's matrices, fastq2twobit's packing):

- per-cycle quality histogram [L, 128] (fastq_count.c:29-35)
- read length histogram [512] (fastq_count.c:110-121)
- per-read GC count (bam_sliding_count.c:84-91, Rgzfastq_uniq.c:50-57)
- per-cycle nucleotide composition [L, 5] (A/C/G/T/N, Rgzfastq_uniq.c:50-57)
- 2-bit packed sequence [B, L//4] (twoBit.h:135-181)

Fusing them means the seq/qual bytes are read from device memory once.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .count import N_CYCLE, N_QUAL
from .twobit import base_codes

NT_ORDER = b"ACGTN"  # composition row order (matches Rfastqc's ACGTN)


@functools.partial(jax.jit, static_argnames=("n_qual", "n_len"))
def qc_step(seq: jax.Array, qual: jax.Array, lens: jax.Array,
            n_valid: jax.Array, n_qual: int = N_QUAL, n_len: int = N_CYCLE):
    B, L = seq.shape
    col = jax.lax.broadcasted_iota(jnp.int32, (B, L), 1)
    row = jax.lax.broadcasted_iota(jnp.int32, (B, 1), 0)
    rowmask = row < n_valid
    mask = (col < lens[:, None]) & rowmask

    # Quality per-cycle histogram (fused one-hot reduce).
    qvals = jax.lax.broadcasted_iota(jnp.int32, (1, 1, n_qual), 2)
    onehot = (qual.astype(jnp.int32)[:, :, None] == qvals) & mask[:, :, None]
    cycle_hist = jnp.sum(onehot, axis=0, dtype=jnp.int32)

    # Length histogram.
    len_hist = jnp.zeros((n_len,), jnp.int32).at[jnp.clip(lens, 0, n_len - 1)
                                                 ].add(rowmask[:, 0].astype(jnp.int32))

    # Per-read GC (count of C/c/G/g among valid cycles).
    up = seq & 0xDF  # ASCII uppercase for letters
    is_gc = ((up == ord("C")) | (up == ord("G"))) & mask
    gc = jnp.sum(is_gc, axis=1, dtype=jnp.int32)

    # Per-cycle base composition over A,C,G,T,N (other chars fall in no row).
    comp_rows = []
    for b in NT_ORDER:
        comp_rows.append(jnp.sum((up == (b & 0xDF)) & mask, axis=0,
                                 dtype=jnp.int32))
    composition = jnp.stack(comp_rows, axis=-1)  # [L, 5]

    # 2-bit packing (N->T, 4 bases/byte, MSB-first).
    codes = base_codes(seq).reshape(B, L // 4, 4)
    packed = (jnp.left_shift(codes[..., 0], 6) | jnp.left_shift(codes[..., 1], 4)
              | jnp.left_shift(codes[..., 2], 2) | codes[..., 3])

    return dict(cycle_hist=cycle_hist, len_hist=len_hist, gc=gc,
                composition=composition, packed=packed)
