"""Vectorized ragged<->padded byte-array conversions.

Device compute wants fixed shapes; FASTQ/BAM records are ragged. These helpers
convert between a flat byte stream with per-record (start, len) and a padded
[B, Lmax] uint8 matrix with a length vector, using single numpy gathers and
scatters (no per-record Python loops). This is the padded-shape policy used by
the whole host pipeline.
"""

from __future__ import annotations

import numpy as np


def round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def ragged_arange(lens: np.ndarray) -> np.ndarray:
    """[0..l0), [0..l1), ... concatenated. lens: int64 [B] -> int64 [sum]."""
    lens = np.asarray(lens, dtype=np.int64)
    total = int(lens.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    starts = np.zeros(len(lens), dtype=np.int64)
    np.cumsum(lens[:-1], out=starts[1:])
    return np.arange(total, dtype=np.int64) - np.repeat(starts, lens)


def gather_padded(data: np.ndarray, starts: np.ndarray, lens: np.ndarray,
                  lmax: int, pad_value: int = 0) -> np.ndarray:
    """Gather ragged rows data[starts[i]:starts[i]+lens[i]] into [B, lmax] u8.

    Rows may read up to lmax bytes past their start (into the following
    record's bytes); padding is then zeroed with a single masked multiply.
    `data` is extended by lmax sentinel bytes so no clip pass is needed.
    """
    B = len(starts)
    if B == 0:
        return np.zeros((0, lmax), dtype=np.uint8)
    ext = np.empty(len(data) + lmax, dtype=np.uint8)
    ext[:len(data)] = data
    ext[len(data):] = 0
    col = np.arange(lmax, dtype=np.int32)
    idx = starts.astype(np.int32)[:, None] + col[None, :]
    out = ext[idx]
    # zero padding lanes: out *= (col < len) as uint8 mask
    mask = (col[None, :] < lens.astype(np.int32)[:, None])
    if pad_value == 0:
        out *= mask
    else:
        np.putmask(out, ~mask, np.uint8(pad_value))
    return out


def flatten_ragged(padded: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Inverse of gather_padded: [B, Lmax] + lens -> flat valid bytes."""
    lens = np.asarray(lens, dtype=np.int64)
    B, lmax = padded.shape
    col = np.arange(lmax, dtype=np.int64)
    mask = col[None, :] < lens[:, None]
    return padded[mask]


def scatter_fields(total: int, field_starts: list[np.ndarray],
                   field_bytes: list[np.ndarray],
                   field_lens: list[np.ndarray]) -> np.ndarray:
    """Build a flat output buffer by scattering several ragged fields.

    field_starts[f][i] = destination offset of field f of record i;
    field_bytes[f] = the flat bytes of field f (concatenated over records);
    field_lens[f][i] = length of field f of record i.
    """
    out = np.empty(total, dtype=np.uint8)
    for starts, flat, lens in zip(field_starts, field_bytes, field_lens):
        lens = np.asarray(lens, dtype=np.int64)
        dest = np.repeat(starts.astype(np.int64), lens) + ragged_arange(lens)
        out[dest] = flat
    return out
