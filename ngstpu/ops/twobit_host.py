"""Host-side (jax-free) half of the 2-bit DNA codec.

The lookup tables and vectorized numpy pack/unpack live here so the CLI
tools (fastq2twobit / twoBit2seq) can run their host-placement fast path
without importing jax at startup; the
device kernels in ops/twobit.py re-export these for compatibility.
Semantics: reference twoBit.h:54-71,135-181 — T/t/U/u->0, C/c->1,
A/a->2, G/g->3, anything else (incl. N) -> 0 (N packs lossily to T);
four bases per byte, first base in the two most significant bits.
"""

from __future__ import annotations

import numpy as np

# Host-side lookup tables (match initNtVal exactly).
NT_VAL = np.zeros(256, dtype=np.uint8)  # default 0 == T
for ch, v in ((b"Tt", 0), (b"Uu", 0), (b"Cc", 1), (b"Aa", 2), (b"Gg", 3)):
    for c in ch:
        NT_VAL[c] = v
VAL_TO_NT = np.frombuffer(b"TCAGN", dtype=np.uint8).copy()


def pack2bit_np(seq: np.ndarray) -> np.ndarray:
    """[B, L] uint8 bases -> [B, L//4] uint8 packed (L must be %4==0).
    Vectorized host twin of ops.twobit.pack2bit; padding bytes (0) code
    to T(0) like the reference's 'T' fill (twoBit.h:176-179)."""
    B, L = seq.shape
    c = NT_VAL[seq].reshape(B, L // 4, 4)
    return ((c[..., 0] << 6) | (c[..., 1] << 4) | (c[..., 2] << 2)
            | c[..., 3]).astype(np.uint8)


def unpack2bit_np(packed: np.ndarray) -> np.ndarray:
    """[B, P] uint8 packed -> [B, P*4] uint8 base bytes ("TCAG")."""
    vals = np.stack([(packed >> 6) & 3, (packed >> 4) & 3,
                     (packed >> 2) & 3, packed & 3], axis=-1)
    return VAL_TO_NT[vals].reshape(packed.shape[0], packed.shape[1] * 4)


def pack2bit_host(seq_bytes: bytes) -> bytes:
    """Reference-exact host packer (golden oracle for tests)."""
    arr = np.frombuffer(seq_bytes, dtype=np.uint8)
    codes = NT_VAL[arr]
    pad = (-len(codes)) % 4
    if pad:
        codes = np.concatenate([codes, np.zeros(pad, dtype=np.uint8)])
    c = codes.reshape(-1, 4)
    return ((c[:, 0] << 6) | (c[:, 1] << 4) | (c[:, 2] << 2) | c[:, 3]).astype(
        np.uint8).tobytes()


def unpack2bit_host(packed: bytes, n_bases: int) -> bytes:
    arr = np.frombuffer(packed, dtype=np.uint8)
    vals = np.stack([(arr >> 6) & 3, (arr >> 4) & 3, (arr >> 2) & 3, arr & 3],
                    axis=1).reshape(-1)
    return VAL_TO_NT[vals[:n_bases]].tobytes()
