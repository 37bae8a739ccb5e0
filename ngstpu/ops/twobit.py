"""2-bit DNA codec as device vector ops.

Semantics of the reference twoBit.h codec (reference twoBit.h:54-71,135-181):
T/t/U/u -> 0, C/c -> 1, A/a -> 2, G/g -> 3, anything else (incl. N) -> 0
(i.e. N packs lossily to T); four bases per byte, first base in the two most
significant bits; trailing partial byte is padded with 'T' (= 0 bits).
Unpack maps 0..3 -> "TCAG" (reference twoBit.h:66-69 valToNt).

Instead of per-base scalar shifts we compute the 2-bit code with a handful of
vectorized byte compares and pack with a reshape + shift-or, which XLA fuses
into a single elementwise pass.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

# Host-side tables + numpy pack/unpack live in twobit_host (jax-free for
# the CLI startup path); re-exported here for compatibility.
from .twobit_host import (NT_VAL, VAL_TO_NT, pack2bit_host,  # noqa: F401
                          pack2bit_np, unpack2bit_host, unpack2bit_np)


def base_codes(seq: jax.Array) -> jax.Array:
    """uint8 base bytes -> 2-bit codes (uint8 in 0..3), vectorized compares."""
    is_c = (seq == ord("C")) | (seq == ord("c"))
    is_a = (seq == ord("A")) | (seq == ord("a"))
    is_g = (seq == ord("G")) | (seq == ord("g"))
    return (is_c.astype(jnp.uint8) + 2 * is_a.astype(jnp.uint8)
            + 3 * is_g.astype(jnp.uint8))


@jax.jit
def pack2bit(seq: jax.Array) -> jax.Array:
    """[B, L] uint8 bases -> [B, L//4] uint8 packed (L must be %4==0).

    Padding bytes (0) code to T(0), matching the reference's 'T' fill
    (reference twoBit.h:176-179).
    """
    B, L = seq.shape
    codes = base_codes(seq).reshape(B, L // 4, 4)
    return (jnp.left_shift(codes[..., 0], 6) | jnp.left_shift(codes[..., 1], 4)
            | jnp.left_shift(codes[..., 2], 2) | codes[..., 3])


@jax.jit
def unpack2bit(packed: jax.Array) -> jax.Array:
    """[B, P] uint8 packed -> [B, P*4] uint8 base bytes ("TCAG")."""
    vals = jnp.stack([
        jnp.right_shift(packed, 6) & 3,
        jnp.right_shift(packed, 4) & 3,
        jnp.right_shift(packed, 2) & 3,
        packed & 3,
    ], axis=-1)
    lut = jnp.asarray(VAL_TO_NT[:4])
    out = lut[vals]
    return out.reshape(packed.shape[0], packed.shape[1] * 4)


@functools.partial(jax.jit, static_argnames=("words",))
def pack2bit_words(seq: jax.Array, words: int) -> jax.Array:
    """[B, L] bases -> [B, words] uint32 big-endian-packed sort keys.

    Word w holds bases [16w, 16w+16), first base most significant, so
    lexicographic uint32 tuple order == lexicographic base order with
    T<C<A<G (the codec's value order). Used by the sort/dedup engine.
    """
    B, L = seq.shape
    need = words * 16
    if L < need:
        seq = jnp.pad(seq, ((0, 0), (0, need - L)))
    else:
        seq = seq[:, :need]
    codes = base_codes(seq).astype(jnp.uint32).reshape(B, words, 16)
    shifts = jnp.arange(30, -1, -2, dtype=jnp.uint32)
    return jnp.sum(codes << shifts[None, None, :], axis=-1, dtype=jnp.uint32)



