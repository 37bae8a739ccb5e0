"""Host-placement sort/pack primitives — deliberately jax-free.

These are the numpy/native halves of ops/sortengine.py used by the
offset-indexed CLI fast paths, split out so a host-placed invocation
(NGSTPU_LINK=host) never imports jax (the same motivation as
tools/emitters.py). sortengine re-exports every name here, so
device-side callers keep their single import surface.

The rare no-native-lib fallbacks import sortengine lazily and do pay the
jax cost — correctness first, startup speed where it matters.
"""

from __future__ import annotations

import numpy as np


def bytes_to_words_host(padded: np.ndarray) -> np.ndarray:
    """Host-side bytes_to_words (numpy big-endian view)."""
    return np.ascontiguousarray(padded).view(">u4").astype(np.uint32)


# DNA alphabet rank codes for 3-bit packing: 0 reserved for padding so
# shorter-prefix rows sort first; ranks follow ASCII order of the bytes
# ('.' < A < C < G < N < T) so packed-word order == byte-lex order.
_DNA3_RANK = np.zeros(256, dtype=np.uint8)
for _i, _c in enumerate(b".ACGNT"):
    _DNA3_RANK[_c] = _i + 1
DNA3_ALPHABET = frozenset(b".ACGNT")

_DNA3_OK = np.zeros(256, dtype=bool)
_DNA3_OK[0] = True
for _c in DNA3_ALPHABET:
    _DNA3_OK[_c] = True

# 2-bit alphabet: pure ACGT (+ NUL padding). Ranks A=0 C=1 G=2 T=3 follow
# byte order, 16 bases/uint32. Padding (0) collides with 'A' (rank 0), so
# 2-bit words NEVER determine row length — the dedup sort must carry the
# explicit length key (see sortengine.dedup_sorted words_encode_len).
DNA2_ALPHABET = frozenset(b"ACGT")
_DNA2_OK = np.zeros(256, dtype=bool)
_DNA2_OK[0] = True
for _c in DNA2_ALPHABET:
    _DNA2_OK[_c] = True


def _byte_presence(padded: np.ndarray) -> np.ndarray:
    from ..io.native import get_lib

    flat = padded.reshape(-1)
    lib = get_lib()
    if lib is not None and flat.flags.c_contiguous:
        present = np.zeros(256, dtype=np.uint8)
        if len(flat):
            lib.ngs_byte_presence(flat, len(flat), present, 0)
        return present > 0
    return np.bincount(flat, minlength=256) > 0


def classify_alphabet(padded: np.ndarray) -> str:
    """One presence scan -> narrowest sort-key packing for this buffer:
    'dna2' (pure ACGT: 16 bases/word), 'dna3' ({.ACGNT}: 10 bases/word),
    or 'raw' (arbitrary bytes: 4/word)."""
    present = _byte_presence(padded)
    if (~present | _DNA2_OK).all():
        return "dna2"
    if (~present | _DNA3_OK).all():
        return "dna3"
    return "raw"


def is_dna3_compatible(padded: np.ndarray, lens) -> bool:
    """True if all valid bytes are in the 6-char DNA alphabet (host check,
    native single-pass presence scan; numpy bincount fallback)."""
    present = _byte_presence(padded)
    return bool((~present | _DNA3_OK).all())


def _pack_host(padded_np: np.ndarray, kind: str) -> np.ndarray | None:
    """Native threaded rank packing; None when no native lib."""
    from ..io.native import get_lib

    lib = get_lib()
    if lib is None:
        return None
    B, L = padded_np.shape
    per = 16 if kind == "dna2" else 10
    words = (L + per - 1) // per
    out = np.empty((B, words), dtype=np.uint32)
    if B:
        fn = lib.ngs_dna2_pack if kind == "dna2" else lib.ngs_dna3_pack
        fn(np.ascontiguousarray(padded_np), B, L, words, out, 0)
    return out


def pack_words_host(padded_np: np.ndarray, kind: str) -> np.ndarray:
    """Collation-preserving uint32 sort words for `kind` (host array)."""
    if kind in ("dna2", "dna3"):
        out = _pack_host(padded_np, kind)
        if out is not None:
            return out
        from . import sortengine  # no native lib: device packing kernels

        import jax.numpy as jnp

        fn = (sortengine.dna2_words if kind == "dna2"
              else sortengine.dna3_words)
        return np.asarray(fn(jnp.asarray(padded_np)))
    return bytes_to_words_host(padded_np)


def seq_words_host(padded_np: np.ndarray,
                   dna3: bool | None = None) -> np.ndarray:
    """seq_words but kept on the host (for the distributed paths, which
    device_put per-shard slices themselves)."""
    if dna3 is None:
        dna3 = is_dna3_compatible(padded_np, None)
    if dna3:
        return pack_words_host(padded_np, "dna3")
    return bytes_to_words_host(padded_np)


def sort_perm_host(words_np: np.ndarray, lens_np,
                   length_first: bool) -> np.ndarray | None:
    """Host placement of lex_argsort (NGSTPU_LINK=host): native
    256-way bucket scatter + parallel per-bucket sort over the same
    collation words — identical order (length-first or lex-first, ties by
    original index: the stable order the reference's glibc qsort
    realizes for its comparators, gzfastq_sort.c:85-103). Returns None
    when the native library is unavailable."""
    from ..io.native import get_lib

    lib = get_lib()
    if lib is None:
        return None
    B, W = words_np.shape
    perm = np.empty(B, np.int32)
    if B:
        lib.ngs_sort_perm_host(np.ascontiguousarray(words_np),
                               np.ascontiguousarray(lens_np, np.int32),
                               B, W, 1 if length_first else 0, perm, 0)
    return perm


def sum_quality_host(qual_padded: np.ndarray) -> np.ndarray:
    """Per-read quality-byte sum on the host (padding bytes are zero).
    Used by the dedup tools to avoid shipping the quality matrix to the
    device when no histogram is needed."""
    from ..io.native import get_lib

    lib = get_lib()
    B = qual_padded.shape[0]
    if lib is not None and B and qual_padded.flags.c_contiguous:
        out = np.empty(B, dtype=np.uint32)
        lib.ngs_row_sums_u32(qual_padded, B, qual_padded.shape[1], out, 0)
        return out
    return qual_padded.sum(axis=1, dtype=np.uint32)
