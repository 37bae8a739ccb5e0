"""Coverage/pileup as a sorted-event sweep on device.

The reference builds per-chromosome hash tables of alignment-block starts and
ends and sweeps their sorted union maintaining a running depth
(reference bam2depth.c:86-110 fetch_func, 203-236 hash2BedGraph). The
device formulation: scatter-add +1 at block starts and -1 at block ends
into a coordinate-indexed delta array, then depth(x) = prefix-sum of deltas —
an O(n log n)-free, fully parallel scan that XLA maps to an efficient
segmented cumsum. Windowed means are a second scatter-add of depth*bp into
window bins (reference bam2depth.c:132-176 `overlap`).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


@functools.partial(jax.jit, static_argnames=("n_pos",))
def depth_deltas(starts: jax.Array, ends: jax.Array, valid: jax.Array,
                 n_pos: int) -> jax.Array:
    """Scatter alignment-block events into a delta array of length n_pos+1.

    starts/ends: int32 [E] 0-based block [start, end); valid: bool [E].
    depth over [0, n_pos) = cumsum(deltas)[:-1].
    """
    w = valid.astype(jnp.int32)
    d = jnp.zeros((n_pos + 1,), jnp.int32)
    d = d.at[jnp.clip(starts, 0, n_pos)].add(w)
    d = d.at[jnp.clip(ends, 0, n_pos)].add(-w)
    return d


@jax.jit
def depth_from_deltas(deltas: jax.Array) -> jax.Array:
    return jnp.cumsum(deltas)[:-1]


@functools.partial(jax.jit, static_argnames=("n_windows", "window"))
def window_depth_sums(starts: jax.Array, ends: jax.Array, valid: jax.Array,
                      n_windows: int, window: int) -> jax.Array:
    """Σ over reads of bp-overlap with each fixed window (depth·bp per bin).

    Equivalent to the reference's `overlap` accumulation of depth*length
    into window bins (bam2depth.c:132-176) but computed directly from block
    events: each block [s,e) contributes overlap_len to every window it
    intersects. Implemented as two scatter-adds using the prefix-sum trick
    on window boundaries: overlap(b, w) integrated via cumulative
    contribution at block granularity.
    """
    # Clip blocks to the covered range.
    s = jnp.clip(starts, 0, n_windows * window)
    e = jnp.clip(ends, 0, n_windows * window)
    w = valid & (e > s)

    # For each block, distribute its overlap across windows via a delta
    # encoding on a per-window "coverage integral":
    #   f(win) = overlap([s,e), [win*W,(win+1)*W))
    # f is piecewise linear in win; its second difference is sparse. We use
    # the standard 4-point scheme on the integral of depth.
    first_w = s // window
    last_w = (e - 1) // window
    # contribution to first window
    first_len = jnp.minimum(e, (first_w + 1) * window) - s
    last_len = e - jnp.maximum(s, last_w * window)
    same = first_w == last_w
    blk_len = jnp.where(same, e - s, first_len)

    wz = w.astype(jnp.int64) if starts.dtype == jnp.int64 else w.astype(jnp.int32)
    out = jnp.zeros((n_windows + 1,), jnp.int32)
    # first window gets blk_len; full middle windows get `window`;
    # last window gets last_len (when different from first).
    out = out.at[jnp.clip(first_w, 0, n_windows)].add(blk_len * wz)
    # middle windows: add `window` to [first_w+1, last_w) via delta+cumsum
    mid_lo = jnp.clip(first_w + 1, 0, n_windows)
    mid_hi = jnp.clip(last_w, 0, n_windows)
    has_mid = (~same) & w
    deltas = jnp.zeros((n_windows + 1,), jnp.int32)
    deltas = deltas.at[mid_lo].add(jnp.where(has_mid, window, 0))
    deltas = deltas.at[mid_hi].add(jnp.where(has_mid, -window, 0))
    out = out + jnp.cumsum(deltas)
    out = out.at[jnp.clip(last_w, 0, n_windows)].add(
        jnp.where((~same) & w, last_len, 0))
    return out[:n_windows]


def depth_numpy_oracle(starts, ends, n_pos):
    """Brute-force oracle for tests."""
    d = np.zeros(n_pos, dtype=np.int64)
    for s, e in zip(starts, ends):
        d[max(s, 0):min(e, n_pos)] += 1
    return d
