"""Device sort/dedup engine — replaces the reference's hash tables and qsort.

The reference dedups with a Redis dict keyed by the exact sequence bytes
(reference gzfastq_uniq.c:194-281) and sorts whole files with qsort on
length-first comparators (reference gzfastq_sort.c:85-103). The device
formulation: pack row bytes into big-endian uint32 words so lexicographic
byte order == lexicographic word-tuple order, then one stable multi-operand
lax.sort; duplicate groups are equal-neighbor segments of the sorted order,
counts are segment sums, and the kept representative (highest quality sum,
earliest occurrence on ties — gzfastq_uniq.c:226 uses strict >) is a
segment max over a packed (sumQ, reverse-index) score.

Collation notes:
- plain lexicographic (sdscmp, gzfastq_uniq.c:142-144 / dump_dict:287-289):
  zero padding sorts shorter-prefix rows first, matching sdscmp's
  shorter-is-smaller tie rule, provided sequences contain no 0x00 bytes.
- length-first (gzfastq_sort.c comp_seq/comp_name): prepend the length as
  the most significant key operand.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

# host-placement halves live in the jax-free ops/hostsort.py (so CLI fast
# paths skip the jax import); re-exported here for device-side callers
from .hostsort import (DNA2_ALPHABET, DNA3_ALPHABET,  # noqa: F401
                       _DNA2_OK, _DNA3_OK, _DNA3_RANK, _byte_presence,
                       _pack_host, bytes_to_words_host, classify_alphabet,
                       is_dna3_compatible, pack_words_host, seq_words_host,
                       sort_perm_host, sum_quality_host)


@jax.jit
def bytes_to_words(padded: jax.Array) -> jax.Array:
    """[B, L] uint8 (L % 4 == 0) -> [B, L//4] uint32 big-endian words."""
    B, L = padded.shape
    w = padded.astype(jnp.uint32).reshape(B, L // 4, 4)
    return (w[..., 0] << 24) | (w[..., 1] << 16) | (w[..., 2] << 8) | w[..., 3]


def seq_words(padded_np: np.ndarray, dna3: bool | None = None) -> jax.Array:
    """Collation-preserving sort words for sequence bytes: 3-bit packed
    (3.3x narrower keys) when the data is plain DNA, raw bytes otherwise.

    The packing happens on the host (native threaded path) when possible:
    transferring [B, ceil(L/10)] uint32 words instead of [B, L] raw bytes
    cuts host->device traffic 2.5x. `dna3` skips the alphabet re-scan when
    the caller has already run is_dna3_compatible.
    """
    if dna3 is None:
        dna3 = is_dna3_compatible(padded_np, None)
    if dna3:
        from ..io.native import get_lib

        lib = get_lib()
        B, L = padded_np.shape
        words = (L + 9) // 10
        if lib is not None and B:
            out = np.empty((B, words), dtype=np.uint32)
            lib.ngs_dna3_pack(np.ascontiguousarray(padded_np), B, L, words,
                              out, 0)
            return jnp.asarray(out)
        return dna3_words(jnp.asarray(padded_np))
    return bytes_to_words(jnp.asarray(padded_np))


@jax.jit
def dna2_words(padded: jax.Array) -> jax.Array:
    """[B, L] uint8 pure-ACGT -> [B, ceil(L/16)] uint32: sixteen 2-bit
    ranks per word (A=0 C=1 G=2 T=3; padding packs as rank 0 = 'A', so
    callers must keep an explicit length key — classify_alphabet gates)."""
    B, L = padded.shape
    ranks = jnp.zeros(padded.shape, jnp.uint32)
    for i, c in enumerate(b"CGT"):
        ranks = jnp.where(padded == c, jnp.uint32(i + 1), ranks)
    groups = (L + 15) // 16
    pad = groups * 16 - L
    if pad:
        ranks = jnp.pad(ranks, ((0, 0), (0, pad)))
    ranks = ranks.reshape(B, groups, 16)
    shifts = jnp.arange(30, -2, -2, dtype=jnp.uint32)
    return jnp.sum(ranks << shifts[None, None, :], axis=-1, dtype=jnp.uint32)


def pack_for_dedup(padded_np: np.ndarray, kind: str | None = None
                   ) -> tuple[jax.Array, bool]:
    """Narrowest sort-key packing for the dedup engine.

    Returns (words on device, words_encode_len): the flag is True only for
    dna3 packing, whose reserved padding rank makes equal words imply equal
    lengths — dedup_sorted then skips the explicit length key pass.
    """
    if kind is None:
        kind = classify_alphabet(padded_np)
    return jnp.asarray(pack_words_host(padded_np, kind)), kind == "dna3"


@jax.jit
def dna3_words(padded: jax.Array) -> jax.Array:
    """[B, L] uint8 DNA -> [B, ceil(L/10)] uint32: ten 3-bit ranks per word.

    3.3x narrower sort keys than raw bytes with identical collation on the
    {., A, C, G, N, T} alphabet (caller must verify via is_dna3_compatible).
    """
    B, L = padded.shape
    ranks = jnp.zeros(padded.shape, jnp.uint32)
    for i, c in enumerate(b".ACGNT"):
        ranks = jnp.where(padded == c, jnp.uint32(i + 1), ranks)
    groups = (L + 9) // 10
    pad = groups * 10 - L
    if pad:
        ranks = jnp.pad(ranks, ((0, 0), (0, pad)))
    ranks = ranks.reshape(B, groups, 10)
    shifts = jnp.arange(27, -3, -3, dtype=jnp.uint32)
    return jnp.sum(ranks << shifts[None, None, :], axis=-1, dtype=jnp.uint32)


def _order_u32(key: jax.Array) -> jax.Array:
    """Order-preserving cast to uint32 (signed ints get a sign-bias)."""
    if key.dtype == jnp.uint32:
        return key
    if key.dtype == jnp.bool_:
        return key.astype(jnp.uint32)
    return jax.lax.bitcast_convert_type(key.astype(jnp.int32),
                                        jnp.uint32) ^ jnp.uint32(0x80000000)


def _lsd_perm(keys_msf: list[jax.Array]) -> jax.Array:
    """Stable lexicographic argsort via LSD passes of 2-operand sorts.

    keys_msf: key arrays in most-significant-first order. Running the
    passes under lax.scan makes XLA compile a SINGLE (uint32 key, perm)
    sort reused for every pass, so compile time is flat in key width.
    Stability makes the original index the implicit final tiebreaker.
    """
    B = keys_msf[0].shape[0]
    ks = jnp.stack([_order_u32(k) for k in reversed(keys_msf)])  # [P, B]
    perm0 = jax.lax.broadcasted_iota(jnp.int32, (B,), 0)
    # inherit the keys' varying-manual-axes so the scan carry typechecks
    # under shard_map (no-op outside: adding varying zeros)
    perm0 = perm0 + (ks[0] * jnp.uint32(0)).astype(jnp.int32)

    def body(perm, key_row):
        k = jnp.take(key_row, perm)
        _, perm = jax.lax.sort((k, perm), num_keys=1, is_stable=True)
        return perm, None

    perm, _ = jax.lax.scan(body, perm0, ks)
    return perm


@functools.partial(jax.jit, static_argnames=("length_first",))
def lex_argsort(words: jax.Array, lens: jax.Array,
                length_first: bool = False) -> jax.Array:
    """Stable argsort of rows by word-tuple lexicographic order.

    words: uint32 [B, W]; lens: int32 [B] (used as the leading key when
    length_first). Returns perm int32 [B].
    """
    B, W = words.shape
    ops = []
    if length_first:
        ops.append(lens)
    ops.extend([words[:, w] for w in range(W)])
    return _lsd_perm(ops)


@functools.partial(jax.jit, static_argnames=("length_first",
                                              "words_encode_len",
                                              "maybe_padding"))
def dedup_sorted(words: jax.Array, lens: jax.Array, sumq: jax.Array,
                 n_valid: jax.Array, length_first: bool = False,
                 words_encode_len: bool = False, maybe_padding: bool = True):
    """Sort rows and compute duplicate-group structure in one jitted pass.

    Padding rows (index >= n_valid) are forced to sort last via a sentinel
    length key and are excluded from groups; callers that know n_valid == B
    statically pass maybe_padding=False to skip that sort pass.
    words_encode_len=True (dna3 packing: reserved padding rank, so equal
    words imply equal lengths) skips the explicit length key pass. Each
    skipped key is one fewer LSD pass over the whole batch.

    Returns dict of device arrays, all [B]:
      perm        sorted order (original row indices; padding rows last)
      is_head     True at the first row of each equal-sequence group
      group_count occurrences of this row's group (valid at heads)
      rep_idx     original index of the kept representative (valid at heads)
      n_groups    scalar: number of distinct sequences
    """
    B, W = words.shape
    idx = jax.lax.broadcasted_iota(jnp.int32, (B,), 0)
    valid = idx < n_valid

    # Sort keys (most significant first): [padding-last sentinel,
    # (len if length_first), words..., len, -sumQ]; stability supplies the
    # original-index tiebreak. Within an equal-sequence group rows land in
    # (sumQ desc, original idx asc) order, so each group's FIRST sorted row
    # IS the representative the reference keeps (strict > replacement,
    # gzfastq_uniq.c:226) — no 64-bit score packing needed.
    ops: list[jax.Array] = []
    if maybe_padding:
        ops.append((~valid).astype(jnp.uint32))
    if length_first:
        ops.append(lens)
    ops.extend([words[:, w] for w in range(W)])
    if not (words_encode_len or length_first):
        ops.append(lens)
    ops.append(-sumq.astype(jnp.int32))
    perm = _lsd_perm(ops)

    s_words = jnp.take(words, perm, axis=0)
    s_lens = jnp.take(lens, perm)
    s_valid = jnp.take(valid, perm)

    same = jnp.all(s_words[1:] == s_words[:-1], axis=1) & \
        (s_lens[1:] == s_lens[:-1]) & s_valid[1:] & s_valid[:-1]
    is_head = jnp.concatenate([jnp.ones((1,), bool), ~same]) & s_valid

    # Counts/representatives fall out of head positions with O(groups) host
    # arithmetic (see dedup_groups), so the device runs no segment ops.
    n_groups = jnp.sum(is_head.astype(jnp.int32))
    return dict(perm=perm, is_head=is_head, n_groups=n_groups)


@functools.partial(jax.jit, static_argnames=("length_key", "maybe_padding"))
def sort_partition(words: jax.Array, lens: jax.Array, n_valid: jax.Array,
                   length_key: bool = True, maybe_padding: bool = True):
    """Key-only stable sort + group heads for one key-range partition.

    Unlike dedup_sorted this carries NO quality-sum operand — one fewer LSD
    pass; the representative (max sumQ, earliest index — reference
    gzfastq_uniq.c:226 strict >) is recovered on the host from the stable
    perm with two reduceats (see rep_counts_host). length_key=False skips
    the length pass when the caller proved all row lengths equal.

    Returns (perm int32 [B], is_head bool [B]); padding rows sort last and
    are excluded from heads.
    """
    B, W = words.shape
    idx = jax.lax.broadcasted_iota(jnp.int32, (B,), 0)
    valid = idx < n_valid
    ops: list[jax.Array] = []
    if maybe_padding:
        ops.append((~valid).astype(jnp.uint32))
    ops.extend([words[:, w] for w in range(W)])
    if length_key:
        ops.append(lens)
    perm = _lsd_perm(ops)
    s_words = jnp.take(words, perm, axis=0)
    s_valid = jnp.take(valid, perm)
    same = jnp.all(s_words[1:] == s_words[:-1], axis=1)
    if length_key:
        s_lens = jnp.take(lens, perm)
        same = same & (s_lens[1:] == s_lens[:-1])
    same = same & s_valid[1:] & s_valid[:-1]
    is_head = jnp.concatenate([jnp.ones((1,), bool), ~same]) & s_valid
    return perm, is_head


def rep_counts_host(perm: np.ndarray, is_head: np.ndarray, n_valid: int,
                    sumq: np.ndarray):
    """Group sizes + representative rows from a stable key-only sort.

    perm/is_head: from sort_partition, already trimmed to valid rows.
    sumq: per-row quality sums (partition-local indexing, same as perm).
    Returns (rep_local [G], counts [G]) with groups in key order; rep is
    the earliest row achieving the group's max sumq (strict-> replacement
    semantics of gzfastq_uniq.c:226 — stability makes perm ascending within
    each group, so the min perm among maximizers is the earliest occurrence).
    """
    head_pos = np.flatnonzero(is_head)
    if len(head_pos) == 0:
        return (np.zeros(0, np.int64), np.zeros(0, np.int64))
    counts = np.diff(np.append(head_pos, n_valid))
    s = sumq[perm].astype(np.int64)
    maxv = np.maximum.reduceat(s, head_pos)
    cand = s >= np.repeat(maxv, counts)
    p64 = np.where(cand, perm.astype(np.int64), np.iinfo(np.int64).max)
    rep_local = np.minimum.reduceat(p64, head_pos)
    return rep_local, counts


# Device bytes the dedup sort may need per byte of key words. With up to
# P = W + 3 LSD passes over B rows of W uint32 words, the device holds the
# words (4BW bytes), the [P, B] key stack (4BP), the perm and the gathered
# key of the current pass plus the sort's own copies of both (16B), and the
# gathered sorted words (4BW): 12BW + 28B in all, 4x the words at W = 7.
# A factor of 8 leaves room for XLA's temporaries and for fragmentation.
DEDUP_HEADROOM = 8

# Largest key set (bytes of words) that dedup_groups sorts on the device;
# None derives it from the device's memory limit. Tests patch it to force
# the host spill path.
DEVICE_DEDUP_LIMIT: int | None = None


def device_dedup_limit() -> int | None:
    """DEVICE_DEDUP_LIMIT, else the device's bytes_limit / DEDUP_HEADROOM;
    None (no limit) where the backend reports no memory limit (CPU)."""
    if DEVICE_DEDUP_LIMIT is not None:
        return DEVICE_DEDUP_LIMIT
    stats = jax.devices()[0].memory_stats() or {}
    if "bytes_limit" not in stats:
        return None
    return int(stats["bytes_limit"]) // DEDUP_HEADROOM


def _dedup_host(words_np: np.ndarray, lens_np: np.ndarray,
                sumq_np: np.ndarray, n_valid: int, length_first: bool):
    """Host spill path for unique-sets beyond device memory (SURVEY.md
    §2b #4): numpy lexsort with identical key order to the device path (the full
    key set — pass-skipping flags only change which NO-OP keys the device
    chain omits, never the resulting order)."""
    # np.lexsort: LAST key is primary. Significance (most->least):
    # validity, (lens if length_first), words[0..W-1], lens, -sumq, idx.
    keys = [np.arange(len(lens_np))]           # idx (least significant)
    keys.append(-sumq_np.astype(np.int64))
    keys.append(lens_np)
    keys.extend(words_np[:, w] for w in range(words_np.shape[1] - 1, -1, -1))
    if length_first:
        keys.append(lens_np)
    keys.append(np.arange(len(lens_np)) >= n_valid)  # padding rows last
    perm = np.lexsort(tuple(keys)).astype(np.int32)[:n_valid]
    sw = words_np[perm]
    sl = lens_np[perm]
    same = (sw[1:] == sw[:-1]).all(axis=1) & (sl[1:] == sl[:-1])
    is_head = np.concatenate([[True], ~same])
    return perm, is_head


def dedup_groups(words: jax.Array, lens, sumq, n_valid: int,
                 length_first: bool = False, words_encode_len: bool = False):
    """Host-side wrapper around dedup_sorted.

    Returns dict of numpy arrays:
      perm      [n_valid] sorted order (original indices)
      head_pos  [G] sorted-row index of each group head
      counts    [G] group sizes
      rep       [G] original index of the representative (first max-sumQ)
      n_groups  int
    Groups are in key-ascending order; heads are the representatives.

    Key sets larger than device_dedup_limit() bytes spill to a host
    lexsort with identical ordering and say so on stderr (the one-device
    memory contingency; several devices should use parallel.dsort).
    """
    nbytes = words.size * 4 if hasattr(words, "size") else words.nbytes
    limit = device_dedup_limit()
    if limit is not None and nbytes > limit:
        import sys

        sys.stderr.write(f"ngstpu: dedup keys of {nbytes} bytes exceed the "
                         f"device limit of {limit} bytes; sorting on the "
                         "host\n")
        perm, is_head = _dedup_host(np.asarray(words), np.asarray(lens),
                                    np.asarray(sumq), n_valid, length_first)
    else:
        res = dedup_sorted(words, lens, sumq, jnp.int32(n_valid),
                           length_first=length_first,
                           words_encode_len=words_encode_len,
                           maybe_padding=words.shape[0] != n_valid)
        perm = np.asarray(res["perm"])
        is_head = np.asarray(res["is_head"])
    head_pos = np.flatnonzero(is_head)
    counts = np.diff(np.concatenate([head_pos, [n_valid]]))
    rep = perm[head_pos]
    return dict(perm=perm, head_pos=head_pos, counts=counts, rep=rep,
                n_groups=len(head_pos))


@jax.jit
def sum_quality(qual: jax.Array, lens: jax.Array) -> jax.Array:
    """Per-read sum of quality bytes over valid cycles
    (reference gzfastq_uniq.c:49-55 SUMQuality)."""
    B, L = qual.shape
    col = jax.lax.broadcasted_iota(jnp.int32, (B, L), 1)
    mask = col < lens[:, None]
    return jnp.sum(jnp.where(mask, qual.astype(jnp.uint32), 0), axis=1)


def np_lex_argsort(padded: np.ndarray, lens: np.ndarray,
                   length_first: bool = False) -> np.ndarray:
    """numpy oracle for tests (stable)."""
    keys = [padded[:, i] for i in range(padded.shape[1] - 1, -1, -1)]
    if length_first:
        keys = keys + [lens]
    return np.lexsort(keys)
