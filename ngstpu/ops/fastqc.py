"""FastQC-equivalent statistics (the Rgzfastq_uniq.c / Rfastqc.R pipeline).

One fused device pass per mate computing the matrices the R bridge returns
(reference Rgzfastq_uniq.c:250-305):
- quality matrix [128 qual x MaxLen cycle] (AssignQuality :42-48)
- nucleotide matrix [5 x MaxLen] with ntVal rows T/C/A/G/N and any other
  byte counted as T (:97-114 initNtVal, STATSEQ :50-57)
- per-read GC fraction (uppercase G/C only, :53)
- length histogram Length[len-1] (1-based bins, :174)
Duplication counts come from the sort-engine dedup over the truncated key
(first 50bp per mate when len>75, :172,180).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

MAX_LEN = 300  # reference Rgzfastq_uniq.c:26
KMER_K = 7  # FastQC Kmer module word size


@functools.partial(jax.jit, static_argnames=("n_qual", "max_len"))
def fastqc_stats(seq: jax.Array, qual: jax.Array, lens: jax.Array,
                 n_valid: jax.Array, n_qual: int = 128,
                 max_len: int = MAX_LEN):
    """Returns dict: quality [L, n_qual], ntval [L, 5], gc_count [B] int32
    (G/C bases per read; gc_fraction turns it into the GC fraction),
    len_hist [max_len] (bin i == length i+1)."""
    B, L = seq.shape
    col = jax.lax.broadcasted_iota(jnp.int32, (B, L), 1)
    row = jax.lax.broadcasted_iota(jnp.int32, (B, 1), 0)
    rowmask = row < n_valid
    mask = (col < lens[:, None]) & rowmask

    qvals = jax.lax.broadcasted_iota(jnp.int32, (1, 1, n_qual), 2)
    onehot = (qual.astype(jnp.int32)[:, :, None] == qvals) & mask[:, :, None]
    quality = jnp.sum(onehot, axis=0, dtype=jnp.int32)  # [L, n_qual]

    # ntVal codes: default T(0); C=1, A=2, G=3, N/'.'=4 (case-insensitive)
    up = seq & 0xDF
    code = jnp.zeros(seq.shape, jnp.int32)
    code = jnp.where(up == ord("C"), 1, code)
    code = jnp.where(up == ord("A"), 2, code)
    code = jnp.where(up == ord("G"), 3, code)
    # only uppercase 'N' and '.' map to N (initNtVal :108 — lowercase 'n'
    # falls through to T)
    code = jnp.where((seq == ord("N")) | (seq == ord(".")), 4, code)
    cvals = jax.lax.broadcasted_iota(jnp.int32, (1, 1, 5), 2)
    ntval = jnp.sum((code[:, :, None] == cvals) & mask[:, :, None], axis=0,
                    dtype=jnp.int32)  # [L, 5]

    is_gc = ((seq == ord("G")) | (seq == ord("C"))) & mask  # uppercase only
    gc_count = jnp.sum(is_gc, axis=1, dtype=jnp.int32)

    lvals = jax.lax.broadcasted_iota(jnp.int32, (1, max_len), 1)
    len_onehot = ((lens - 1)[:, None] == lvals) & rowmask
    len_hist = jnp.sum(len_onehot, axis=0, dtype=jnp.int32)

    return dict(quality=quality, ntval=ntval, gc_count=gc_count,
                len_hist=len_hist)


def gc_fraction(gc_count: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Per-read GC fraction in float32 (reference Rgzfastq_uniq.c:53).

    Divided on the host for both placements: numpy's float32 division is
    correctly rounded, while the GPU's differs from it by 1 ulp in about a
    quarter of the reads, enough to move a read across a GC histogram bin
    edge."""
    n = len(gc_count)
    return (np.asarray(gc_count).astype(np.float32)
            / np.maximum(np.asarray(lens[:n], np.int32), 1).astype(np.float32))


def fastqc_stats_host(seq: np.ndarray, qual: np.ndarray, lens: np.ndarray,
                      n: int, n_qual: int = 128, max_len: int = MAX_LEN):
    """Host placement of fastqc_stats (NGSTPU_LINK=host): the
    quality matrix comes from the threaded native per-cycle histogram
    (ngs_qc_hist) and the nucleotide/GC/length stats from chunked
    vectorized numpy — an original re-expression of the device kernel
    above, NOT a port of the reference C. Outputs match fastqc_stats
    bit-for-bit (tests/test_fastqc.py)."""
    from ..io.native import get_lib

    B, L = seq.shape
    lens32 = np.ascontiguousarray(lens[:n], np.int32)
    quality = np.zeros((L, n_qual), np.int64)
    lib = get_lib()
    if lib is not None and n and qual.flags.c_contiguous:
        hq = np.zeros(L * n_qual, np.uint64)
        hl = np.zeros(L, np.uint64)  # unused: len_hist below is exact
        lib.ngs_qc_hist(qual, lens32, n, L, n_qual, L, hq, hl, 0)
        quality = hq.reshape(L, n_qual).astype(np.int64)
    else:
        for lo in range(0, n, 1 << 18):
            hi = min(lo + (1 << 18), n)
            m = np.arange(L)[None, :] < lens32[lo:hi, None]
            q = np.where(m, qual[lo:hi].astype(np.int64), n_qual)
            for k in range(L):
                quality[k] += np.bincount(q[:, k], minlength=n_qual + 1
                                          )[:n_qual]

    ntval = np.zeros((L, 5), np.int64)
    gc_count = np.zeros(n, np.int32)
    for lo in range(0, n, 1 << 18):
        hi = min(lo + (1 << 18), n)
        s = seq[lo:hi]
        m = np.arange(L)[None, :] < lens32[lo:hi, None]
        up = s & 0xDF
        for code, sel in ((1, up == ord("C")), (2, up == ord("A")),
                          (3, up == ord("G")),
                          (4, (s == ord("N")) | (s == ord(".")))):
            ntval[:, code] += (sel & m).sum(axis=0)
        is_gc = ((s == ord("G")) | (s == ord("C"))) & m
        gc_count[lo:hi] = is_gc.sum(axis=1)
    valid = np.zeros(L, np.int64)  # reads covering cycle k
    cnt = np.bincount(np.clip(lens32, 0, L), minlength=L + 1)
    valid[:] = n - np.cumsum(cnt)[:L]
    ntval[:, 0] = valid - ntval[:, 1:].sum(axis=1)  # T = everything else

    lh = np.zeros(max_len, np.int64)
    in_range = (lens32 >= 1) & (lens32 <= max_len)
    lh[:] = np.bincount(lens32[in_range] - 1, minlength=max_len)
    return dict(quality=quality, ntval=ntval, gc_count=gc_count, len_hist=lh)


def truncated_key(seq: np.ndarray, lens: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The dedup key rule: first 50bp when len > 75, else whole read
    (reference Rgzfastq_uniq.c:172)."""
    key_lens = np.where(lens > 75, 50, lens).astype(np.int32)
    width = max(((int(key_lens.max(initial=1)) + 3) // 4) * 4, 4)
    key = seq[:, :width].copy()
    colm = np.arange(width)[None, :] < key_lens[:, None]
    key *= colm
    return key, key_lens


# FastQC's shipped adapter list (Configuration/adapter_list.txt upstream);
# an ngstpu extension beyond the reference R script (ROADMAP item 5).
ADAPTERS: tuple[tuple[str, bytes], ...] = (
    ("Illumina Universal Adapter", b"AGATCGGAAGAG"),
    ("Illumina Small RNA 3' Adapter", b"TGGAATTCTCGG"),
    ("Illumina Small RNA 5' Adapter", b"GATCGTCGGACT"),
    ("Nextera Transposase Sequence", b"CTGTCTCTTATA"),
    ("SOLID Small RNA Adapter", b"CGCCTTGGCCGT"),
)


@functools.partial(jax.jit, static_argnames=("k",))
def adapter_content(seq: jax.Array, lens: jax.Array, n_valid: jax.Array,
                    adapters: jax.Array, k: int = 12) -> jax.Array:
    """Cumulative adapter content, FastQC-style.

    seq uint8 [B, L]; adapters uint8 [A, k]. Returns int32 [A, L]:
    entry [a, i] = number of valid reads where adapter a matches starting
    at some cycle <= i (exact k-mer match, fully inside the read). The
    FastQC chart is this divided by the read count.
    """
    B, L = seq.shape
    A = adapters.shape[0]
    col = jax.lax.broadcasted_iota(jnp.int32, (B, L), 1)
    row = jax.lax.broadcasted_iota(jnp.int32, (B, 1), 0)
    window_ok = (col + k <= lens[:, None]) & (row < n_valid)

    counts = []
    for a in range(A):
        m = jnp.ones((B, L), bool)
        for j in range(k):
            # seq shifted left by j: position i compares seq[:, i+j]
            shifted = jnp.pad(seq[:, j:], ((0, 0), (0, j)))
            m = m & (shifted == adapters[a, j])
        m = m & window_ok
        seen = jax.lax.cummax(m.astype(jnp.int32), axis=1)
        counts.append(jnp.sum(seen, axis=0, dtype=jnp.int32))
    return jnp.stack(counts)


def adapter_content_host(seq: np.ndarray, lens: np.ndarray, n: int,
                         adapters: np.ndarray, k: int = 12) -> np.ndarray:
    """Host placement of adapter_content. Semantics identical to the
    device kernel; the formulation differs for host speed: one shared
    big-endian uint32 rolling window per chunk turns each 12-byte adapter
    match into three word compares, and the cumulative count comes from a
    bincount of each read's FIRST match position (suffix-summed) instead
    of a cummax over the whole matrix."""
    B, L = seq.shape
    A = adapters.shape[0]
    out = np.zeros((A, L), np.int32)
    # clamp lens to the padded width: positions past L-k can never hold a
    # full adapter in the stored bytes (the device kernel compares padded
    # zeros there and never matches either), and unclamped lens would push
    # the sparse verify's u32 gathers out of bounds
    lens32 = np.minimum(np.asarray(lens[:n], np.int32), L)
    words = k // 4 if k % 4 == 0 else 0
    for lo in range(0, n, 1 << 17):
        hi = min(lo + (1 << 17), n)
        s = seq[lo:hi]
        window_ok = np.arange(L)[None, :] + k <= lens32[lo:hi, None]
        u = None
        if words and L >= 4:
            # rolling big-endian u32 window, built IN PLACE (one cast +
            # three shift/or passes; the obvious 4-temporary expression
            # costs 6x); u[:, i] = bytes i..i+3, width L-3
            u = s[:, :L - 3].astype(np.uint32)
            u <<= 8
            u |= s[:, 1:L - 2]
            u <<= 8
            u |= s[:, 2:L - 1]
            u <<= 8
            u |= s[:, 3:L]
        for a in range(A):
            if u is not None:
                # first-word prescreen leaves ~4^-4 of positions; the
                # remaining words verify sparsely on the candidates
                vals = [np.uint32(int.from_bytes(
                    adapters[a, 4 * w:4 * w + 4].tobytes(), "big"))
                    for w in range(words)]
                m = window_ok[:, :L - 3] & (u == vals[0])
                ri, cj = np.nonzero(m)
                for w in range(1, words):
                    keep = u[ri, cj + 4 * w] == vals[w]
                    ri, cj = ri[keep], cj[keep]
                firsts = np.full(hi - lo, L, np.int64)
                np.minimum.at(firsts, ri, cj)
                first = firsts[firsts < L]
            else:  # k not a multiple of 4: byte-compare fallback
                m = window_ok.copy()
                for j in range(k):
                    m[:, L - j:] = False
                    m[:, :L - j] &= s[:, j:] == adapters[a, j]
                hit = m.any(axis=1)
                first = m.argmax(axis=1)[hit]
            out[a] += np.cumsum(np.bincount(first, minlength=L)[:L]
                                ).astype(np.int32)
    return out


def per_tile_quality_host(qual: np.ndarray, lens: np.ndarray, n: int,
                          tile_idx: np.ndarray, n_tiles: int):
    """Host placement of per_tile_quality (np.add.at row scatter)."""
    B, L = qual.shape
    mask = np.arange(L)[None, :] < np.asarray(lens[:n], np.int32)[:, None]
    phred = (qual[:n].astype(np.int32) - 33) * mask
    sums = np.zeros((n_tiles, L), np.int32)
    counts = np.zeros((n_tiles, L), np.int32)
    np.add.at(sums, tile_idx[:n], phred)
    np.add.at(counts, tile_idx[:n], mask.astype(np.int32))
    return sums, counts


def kmer_position_counts_host(seq: np.ndarray, lens: np.ndarray, n: int,
                              k: int = KMER_K) -> np.ndarray:
    """Host placement of kmer_position_counts (bincount over flattened
    (position, kmer-id) cells)."""
    B, L = seq.shape
    code = np.full(seq.shape, 4, np.int8)
    for ch, v in ((b"A", 0), (b"C", 1), (b"G", 2), (b"T", 3)):
        code[seq == ch[0]] = v
    ids = np.zeros((B, L), np.int32)
    ok = np.ones((B, L), bool)
    for j in range(k):
        cj = np.full((B, L), 4, np.int8)
        cj[:, :L - j] = code[:, j:]
        ok &= cj < 4
        ids = (ids << 2) | np.where(cj < 4, cj, 0).astype(np.int32)
    lens32 = np.asarray(lens[:n], np.int32)
    valid = ok[:n] & (np.arange(L)[None, :] + k <= lens32[:, None])
    n_kmers = 4 ** k
    seg = (np.arange(L, dtype=np.int64)[None, :] * n_kmers
           + ids[:n]).ravel()[valid.ravel()]
    flat = np.bincount(seg, minlength=L * n_kmers)
    return flat.reshape(L, n_kmers).astype(np.int32)


def dedup_groups_host_native(key: np.ndarray, key_lens: np.ndarray):
    """Host dedup for the duplication/overrepresented modules, never
    touching the accelerator link: the bucketed parallel native sort +
    group extraction (ngs_dedup_groups_host, the composite pipeline's
    host engine) when the native library is available, else the numpy
    lexsort spill engine (sortengine._dedup_host) over raw-byte words —
    both return (counts, rep) in key-ascending group order, identical to
    the device dedup_groups."""
    from ..io.native import get_lib
    from .hostsort import classify_alphabet, pack_words_host

    B = len(key_lens)
    if B == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    lens32 = np.ascontiguousarray(key_lens, np.int32)
    lib = get_lib()
    if lib is None:
        # raw-byte packing collates identically to any rank packing, so
        # the group order (and thus counts/rep) matches the device path
        from ..ops.sortengine import _dedup_host, bytes_to_words_host

        words = bytes_to_words_host(key)
        perm, is_head = _dedup_host(words, lens32, np.zeros(B, np.uint32),
                                    B, length_first=False)
        head_pos = np.flatnonzero(is_head)
        counts = np.diff(np.append(head_pos, B)).astype(np.int64)
        return counts, perm[head_pos].astype(np.int64)
    import ctypes

    kind = classify_alphabet(key)
    words = np.ascontiguousarray(pack_words_host(key, kind))
    use_len = 0 if kind == "dna3" else 1
    perm = np.empty(B, np.int32)
    rep = np.empty(B, np.int64)
    counts = np.empty(B, np.int64)
    zeros = np.zeros(B, np.uint32)
    g = lib.ngs_dedup_groups_host(
        words, lens32.ctypes.data_as(ctypes.c_void_p), zeros, use_len, B,
        words.shape[1], perm, rep, counts, 0)
    return counts[:g].copy(), rep[:g].copy()


def adapter_content_numpy(seq_list: list[bytes],
                          adapters=ADAPTERS, max_len: int = 0) -> np.ndarray:
    """Brute-force oracle for tests."""
    L = max_len or max((len(s) for s in seq_list), default=1)
    out = np.zeros((len(adapters), L), dtype=np.int64)
    for a, (_, ad) in enumerate(adapters):
        k = len(ad)
        for s in seq_list:
            first = None
            for i in range(len(s) - k + 1):
                if s[i:i + k] == ad:
                    first = i
                    break
            if first is not None:
                out[a, first:] += 1
    return out


def overrepresented(key: np.ndarray, key_lens: np.ndarray,
                    counts: np.ndarray, rep: np.ndarray, n_reads: int,
                    threshold: float = 0.001, limit: int = 20
                    ) -> list[tuple[bytes, int, float]]:
    """FastQC's overrepresented-sequences table (ngstpu extension): the
    dedup keys (first-50bp rule, truncated_key) occurring in more than
    `threshold` of reads, most frequent first, capped at `limit` rows.

    key/key_lens: the dedup key matrix; counts/rep: group sizes and
    representative ORIGINAL indices from dedup_groups.
    """
    if n_reads == 0 or len(counts) == 0:
        return []
    min_count = max(int(np.floor(threshold * n_reads)) + 1, 2)
    hot = np.flatnonzero(counts >= min_count)
    if len(hot) == 0:
        return []
    order = hot[np.argsort(counts[hot], kind="stable")[::-1]][:limit]
    rows = []
    for g in order:
        i = int(rep[g])
        s = key[i, : int(key_lens[i])].tobytes()
        rows.append((s, int(counts[g]), counts[g] * 100.0 / n_reads))
    return rows


@functools.partial(jax.jit, static_argnames=("n_tiles",))
def per_tile_quality(qual: jax.Array, lens: jax.Array, n_valid: jax.Array,
                     tile_idx: jax.Array, n_tiles: int):
    """Per-tile per-cycle quality accumulation (FastQC per-tile module;
    ngstpu extension beyond the reference R script).

    qual uint8 [B, L] raw ASCII; tile_idx int32 [B] dense tile ordinals in
    [0, n_tiles). Returns (phred_sums int32 [T, L], counts int32 [T, L])
    where phred = ascii - 33. The chart metric is each tile's per-cycle
    mean minus the global per-cycle mean.
    """
    B, L = qual.shape
    col = jax.lax.broadcasted_iota(jnp.int32, (B, L), 1)
    row = jax.lax.broadcasted_iota(jnp.int32, (B, 1), 0)
    mask = (col < lens[:, None]) & (row < n_valid)
    phred = (qual.astype(jnp.int32) - 33) * mask
    sums = jax.ops.segment_sum(phred, tile_idx, num_segments=n_tiles)
    counts = jax.ops.segment_sum(mask.astype(jnp.int32), tile_idx,
                                 num_segments=n_tiles)
    return sums, counts


def parse_tile_ids(batch, step: int = 1):
    """Extract Illumina tile numbers from read names (host side — names
    never go to device). FastQC's rule: split the id on ':'; >=7 fields
    (CASAVA 1.8+) -> field 5, 5..6 fields -> field 3. Returns
    (row_idx int64 [Bs], tile_ordinal int32 [Bs], sorted unique tiles) or
    None when names don't carry tile coordinates."""
    rows, tiles = [], []
    for i in range(0, batch.n, step):
        name = batch.name(i)
        head = name.split(b" ", 1)[0].split(b"\t", 1)[0]
        parts = head.split(b":")
        if len(parts) >= 7:
            f = parts[4]
        elif len(parts) >= 5:
            f = parts[2]
        else:
            return None
        try:
            t = int(f)
        except ValueError:
            return None
        rows.append(i)
        tiles.append(t)
    if not tiles:
        return None
    uniq = sorted(set(tiles))
    if len(uniq) > 2048:  # not plausibly tile numbers
        return None
    lut = {t: j for j, t in enumerate(uniq)}
    ords = np.asarray([lut[t] for t in tiles], np.int32)
    return np.asarray(rows, np.int64), ords, uniq




@functools.partial(jax.jit, static_argnames=("k",))
def kmer_position_counts(seq: jax.Array, lens: jax.Array, n_valid: jax.Array,
                         k: int = KMER_K) -> jax.Array:
    """Per-start-position k-mer counts (FastQC Kmer module; ngstpu
    extension beyond the reference R script).

    Builds the 2-bit id of the k-mer starting at every cycle via k shifted
    compares (A=0 C=1 G=2 T=3, uppercase; windows containing any other
    byte are dropped, as FastQC skips kmers with N) and segment-sums the
    valid windows into an int32 [L, 4^k] table.
    """
    B, L = seq.shape
    col = jax.lax.broadcasted_iota(jnp.int32, (B, L), 1)
    row = jax.lax.broadcasted_iota(jnp.int32, (B, 1), 0)
    code = jnp.full(seq.shape, 4, jnp.int32)
    for ch, v in ((b"A", 0), (b"C", 1), (b"G", 2), (b"T", 3)):
        code = jnp.where(seq == ch[0], v, code)
    ids = jnp.zeros((B, L), jnp.int32)
    ok = jnp.ones((B, L), bool)
    for j in range(k):
        cj = code[:, j:] if j == 0 else jnp.pad(
            code[:, j:], ((0, 0), (0, j)), constant_values=4)
        ok = ok & (cj < 4)
        ids = (ids << 2) | jnp.where(cj < 4, cj, 0)
    valid = ok & (col + k <= lens[:, None]) & (row < n_valid)
    n_kmers = 4 ** k
    seg = col * n_kmers + ids
    flat = jax.ops.segment_sum(valid.astype(jnp.int32).ravel(), seg.ravel(),
                               num_segments=L * n_kmers)
    return flat.reshape(L, n_kmers)


def kmer_id_to_str(kid: int, k: int = KMER_K) -> str:
    out = []
    for _ in range(k):
        out.append("ACGT"[kid & 3])
        kid >>= 2
    return "".join(reversed(out))


def kmer_report(counts: np.ndarray, k: int = KMER_K, limit: int = 20,
                min_total: int = 10, min_ratio: float = 5.0
                ) -> list[tuple[str, int, float, int]]:
    """FastQC-style enrichment table from kmer_position_counts output.

    expected[p, K] = total(K) * windows(p) / total_windows; rows =
    (kmer, total count, max obs/expected, 1-based position of the max),
    kmers with max ratio >= min_ratio, strongest first, capped at limit.
    """
    counts = np.asarray(counts, np.int64)
    totals = counts.sum(axis=0)
    win_per_pos = counts.sum(axis=1)
    total_windows = win_per_pos.sum()
    if total_windows == 0:
        return []
    hot = np.flatnonzero(totals >= min_total)
    if len(hot) == 0:
        return []
    exp = (totals[None, hot] *
           (win_per_pos[:, None] / total_windows))  # [L, |hot|]
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = np.where(exp > 0, counts[:, hot] / exp, 0.0)
    best_pos = ratio.argmax(axis=0)
    best = ratio[best_pos, np.arange(len(hot))]
    keep = np.flatnonzero(best >= min_ratio)
    order = keep[np.argsort(best[keep], kind="stable")[::-1]][:limit]
    return [(kmer_id_to_str(int(hot[j]), k), int(totals[hot[j]]),
             float(best[j]), int(best_pos[j]) + 1) for j in order]


def fastqc_stats_numpy(seq_list: list[bytes], qual_list: list[bytes]):
    """Reference-semantics oracle for tests (direct port)."""
    quality = np.zeros((128, MAX_LEN), dtype=np.int64)
    ntval = np.zeros((5, MAX_LEN), dtype=np.int64)
    len_hist = np.zeros(MAX_LEN, dtype=np.int64)
    gc = []
    nt_map = np.zeros(256, dtype=np.int64)
    for c, v in ((b"Cc", 1), (b"Aa", 2), (b"Gg", 3), (b"N.", 4)):
        for ch in c:
            nt_map[ch] = v
    nt_map[ord("n")] = 0  # lowercase n is NOT mapped to N in initNtVal
    for s, q in zip(seq_list, qual_list):
        L = len(s)
        g = 0
        for i, b in enumerate(s):
            if b in (ord("G"), ord("C")):
                g += 1
            ntval[nt_map[b], i] += 1
        gc.append(g / L if L else 0.0)
        for i, b in enumerate(q):
            quality[b, i] += 1
        len_hist[L - 1] += 1
    return quality, ntval, len_hist, np.array(gc)
