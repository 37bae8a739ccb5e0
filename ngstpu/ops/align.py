"""Batched Smith-Waterman local alignment scoring on the device.

The reference vendors klib's SSE2 striped Smith-Waterman (klib/ksw.{h,c},
SURVEY.md §1 "library headroom" — unused by the CLI tools but part of the
intended capability envelope). The device formulation: affine-gap
Gotoh DP vectorized over a BATCH of read/target pairs — lax.scan walks
query positions while [B, Lt] H/E/F lanes update in parallel, so throughput
scales with batch width instead of SSE lanes.

Scoring: match/mismatch constants (a, -b) like ksw_sse2's common use, gap
open/extend (q, r) with affine semantics  E = max(H - q - r, E - r).
Returns the maximum local score per pair (ksw's `score`).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

NEG = -10_000


@functools.partial(jax.jit, static_argnames=("match", "mismatch", "gap_open",
                                             "gap_extend"))
def sw_score_batch(query: jax.Array, qlens: jax.Array, target: jax.Array,
                   tlens: jax.Array, match: int = 1, mismatch: int = 3,
                   gap_open: int = 5, gap_extend: int = 2) -> jax.Array:
    """query uint8 [B, Lq], target uint8 [B, Lt] (zero-padded) -> int32 [B].

    Local (Smith-Waterman) score with affine gaps; padding positions are
    masked out of the recurrence.
    """
    B, Lq = query.shape
    _, Lt = target.shape
    tcol = jax.lax.broadcasted_iota(jnp.int32, (B, Lt), 1)
    tmask = tcol < tlens[:, None]

    def row(carry, qi):
        H_prev, E, best = carry          # all [B, Lt]
        qbase, qpos = qi                 # [B], [B]
        active = (qpos < qlens)[:, None]
        sub = jnp.where(target == qbase[:, None], match, -mismatch)
        sub = jnp.where(tmask, sub, NEG)
        # H_diag for column j is H_prev[j-1]; column 0 diag is 0 (fresh start)
        H_diag = jnp.pad(H_prev[:, :-1], ((0, 0), (1, 0)))
        E = jnp.maximum(H_prev - gap_open - gap_extend, E - gap_extend)
        h_open = jnp.maximum(H_diag + sub, 0)
        h_with_e = jnp.maximum(h_open, E)

        # F (gap in target) needs a prefix-scan along the row:
        # F[j] = max_k<=j (h_with_e_without_F[k] - gap_open - (j-k)*gap_ext)
        # computed as a running max via associative scan on shifted values.
        g = h_with_e - gap_open
        idx = jnp.arange(Lt)
        shifted = g + idx[None, :] * (-gap_extend) * (-1)  # g + j*ge
        run = jax.lax.associative_scan(jnp.maximum, shifted, axis=1)
        F = jnp.pad((run - idx[None, :] * gap_extend)[:, :-1] - gap_extend,
                    ((0, 0), (1, 0)), constant_values=NEG)
        H = jnp.maximum(h_with_e, F)
        H = jnp.where(active & tmask, H, 0)
        best = jnp.maximum(best, jnp.max(H, axis=1))
        return (H, jnp.where(active, E, NEG), best), None

    H0 = jnp.zeros((B, Lt), jnp.int32)
    E0 = jnp.full((B, Lt), NEG, jnp.int32)
    best0 = jnp.zeros((B,), jnp.int32)
    qpos = jnp.arange(Lq, dtype=jnp.int32)
    (H, E, best), _ = jax.lax.scan(
        row, (H0, E0, best0),
        (query.T.astype(jnp.int32), jnp.broadcast_to(qpos[:, None], (Lq, B))))
    return best


@functools.partial(jax.jit, static_argnames=("match", "mismatch", "gap_open",
                                             "gap_extend"))
def sw_align_batch(query: jax.Array, qlens: jax.Array, target: jax.Array,
                   tlens: jax.Array, match: int = 1, mismatch: int = 3,
                   gap_open: int = 5, gap_extend: int = 2):
    """Full ksw_align surface, batched: best score + END POSITIONS.

    Walks TARGET rows under lax.scan with query positions as vector lanes
    (the transpose of sw_score_batch, matching ksw's orientation so end
    positions carry the same meaning as kswr_t — reference klib/ksw.h:63,
    ksw.c ksw_i16). Returns dict:
      score   int32 [B]  best local score
      te      int32 [B]  END position on the target: FIRST row attaining
                         the global max (ksw's strict `imax > gmax`)
      qe      int32 [B]  END position on the query at that row: first
                         query position attaining the row max in natural
                         order (ksw scans its striped layout here — an
                         SSE artifact we deliberately do not reproduce)
      row_max int32 [B, Lt] per-target-row maxima, the input to the
                         second-best extraction (kswr_second_best).
    Empty/padded rows and lanes are masked; scores must stay < 2^31 (we
    compute exact int32, not ksw's saturating u8/i16 lanes).
    """
    B, Lq = query.shape
    _, Lt = target.shape
    qcol = jax.lax.broadcasted_iota(jnp.int32, (B, Lq), 1)
    qmask = qcol < qlens[:, None]
    idxq = jnp.arange(Lq)

    def row(carry, ti):
        Hd, E, gmax, te, Hmax_row = carry   # Hd/E/Hmax_row [B, Lq]
        tbase, tpos = ti                    # [B], scalar-per-row [B]
        active = (tpos < tlens)[:, None]
        sub = jnp.where(query == tbase[:, None], match, -mismatch)
        sub = jnp.where(qmask, sub, NEG)
        Hdiag = jnp.pad(Hd[:, :-1], ((0, 0), (1, 0)))
        h_noF = jnp.maximum(jnp.maximum(Hdiag + sub, E), 0)
        # F(j) = max_{k<j} (g(k) - (j-1-k)*gape), g = max(H-gapoe, 0)
        # (F-sourced H is dominated since gap_open >= 0, so h_noF suffices)
        g = jnp.maximum(h_noF - gap_open - gap_extend, 0)
        run = jax.lax.associative_scan(
            jnp.maximum, g + idxq[None, :] * gap_extend, axis=1)
        F = jnp.pad(run[:, :-1] - idxq[None, 1:] * gap_extend + gap_extend,
                    ((0, 0), (1, 0)), constant_values=0)
        F = jnp.maximum(F, 0)
        H = jnp.maximum(h_noF, F)
        H = jnp.where(qmask & active, H, 0)
        E2 = jnp.maximum(jnp.maximum(H - gap_open - gap_extend,
                                     E - gap_extend), 0)
        E2 = jnp.where(active, E2, E)
        Hd2 = jnp.where(active, H, Hd)
        m_i = jnp.max(H, axis=1)
        better = (m_i > gmax) & (tpos < tlens)
        gmax2 = jnp.where(better, m_i, gmax)
        te2 = jnp.where(better, tpos, te)
        Hmax2 = jnp.where(better[:, None], H, Hmax_row)
        return (Hd2, E2, gmax2, te2, Hmax2), jnp.where(tpos < tlens, m_i, 0)

    z = jnp.zeros((B, Lq), jnp.int32)
    init = (z, z, jnp.zeros(B, jnp.int32), jnp.full(B, -1, jnp.int32), z)
    tpos = jnp.arange(Lt, dtype=jnp.int32)
    (Hd, E, gmax, te, Hmax), row_max = jax.lax.scan(
        row, init,
        (target.T.astype(jnp.int32), jnp.broadcast_to(tpos[:, None], (Lt, B))))
    qe = jnp.where(gmax > 0,
                   jnp.argmax(Hmax == gmax[:, None], axis=1), -1)
    return dict(score=gmax, te=te, qe=qe.astype(jnp.int32), row_max=row_max.T)


def kswr_second_best(row_max: np.ndarray, score: np.ndarray, te: np.ndarray,
                     minsc: int, max_match: int):
    """Second-best score/end from per-row maxima — the KSW_XSUBO b-array
    logic of ksw.c: rows with row-max >= minsc compress into contiguous
    runs keeping each run's first strict maximum; the second best is the
    best entry whose target end falls outside te ± ceil(score/max_match)
    (ksw.c end of ksw_u8/ksw_i16). Returns (score2, te2) int arrays, -1
    where unset.

    Vectorized across the batch: one numpy pass over the T target rows.
    The C "b array" compresses to chains — a qualifying row starts a chain
    when the previous row was not the chain's stored max, and extends it
    only by strict improvement (the stored-row contiguity quirk of the
    reference code means a non-improving row is DISCARDED and breaks the
    chain) — so each chain's final (max, row) is the only entry the window
    filter ever sees, finalized here the moment the chain dies."""
    B, T = row_max.shape
    rm = row_max.astype(np.int64)
    keep = rm >= minsc
    sc = score.astype(np.int64)
    w = (sc + max_match - 1) // max_match
    low = te.astype(np.int64) - w
    high = te.astype(np.int64) + w
    score2 = np.full(B, -1, np.int64)
    te2 = np.full(B, -1, np.int64)
    alive = np.zeros(B, bool)
    cur_max = np.zeros(B, np.int64)
    eligible = sc > 0

    def finalize(dies, last_row):
        sel = (dies & eligible & ((last_row < low) | (last_row > high))
               & (cur_max > score2))
        score2[sel] = cur_max[sel]
        te2[sel] = last_row

    for i in range(T):
        m = rm[:, i]
        improves = alive & keep[:, i] & (m > cur_max)
        starts = ~alive & keep[:, i]
        dies = alive & ~improves
        finalize(dies, i - 1)
        upd = improves | starts
        cur_max = np.where(upd, m, cur_max)
        alive = upd
    finalize(alive, T - 1)
    none = eligible & (score2 < 0)
    score2[none] = 0  # kswr default score2=0 when tracking found none
    return score2, te2


@functools.partial(jax.jit, static_argnames=("match", "mismatch", "gap_open",
                                             "gap_extend", "w"))
def sw_extend_batch(query: jax.Array, qlens: jax.Array, target: jax.Array,
                    tlens: jax.Array, h0: jax.Array, w: int = 100,
                    match: int = 1, mismatch: int = 3, gap_open: int = 5,
                    gap_extend: int = 2):
    """Batched ksw_extend: banded seed-extension from an anchor scored h0
    (reference klib/ksw.h:65, ksw.c ksw_extend). Per pair returns
    (score, qle, tle): the best extension score (>= h0) and the one-past-
    end query/target lengths of the extension (0 when nothing beats h0).

    Replicates the C semantics exactly as a lax.scan over target rows with
    the adaptive band carried as [beg, end) scalars: row-max ties keep the
    LATER query column (mj), the global max keeps the EARLIEST row
    (strict >), a zero row max terminates the extension, and the band
    narrows to the nonzero H run around mj. F uses the same
    associative-scan propagation as sw_align_batch (gap-open >= gap-extend
    makes F-sourced F dominated by direct propagation).
    """
    B, Lq = query.shape
    _, Lt = target.shape
    gapoe = gap_open + gap_extend
    # band width clamp (ksw_extend "adjust $w"): per-pair max_gap
    max_gap = ((qlens * match - gap_open).astype(jnp.float32) / gap_extend
               + 1.0).astype(jnp.int32)
    w_eff = jnp.minimum(jnp.maximum(max_gap, 1), w)

    jidx = jnp.arange(Lq + 1)
    # first row: A[0]=h0, A[1]=max(h0-gapoe,0), then -gape chain while the
    # previous value > gape (ksw_extend "fill the first row")
    m1 = jnp.maximum(h0 - gapoe, 0)
    chain = m1[:, None] - (jidx[None, :] - 1) * gap_extend
    prev_ok = (m1[:, None] - (jidx[None, :] - 2) * gap_extend) > gap_extend
    A0 = jnp.where(jidx[None, :] == 0, h0[:, None],
                   jnp.where(jidx[None, :] == 1, m1[:, None],
                             jnp.where(prev_ok, chain, 0)))
    A0 = A0.astype(jnp.int32)

    def row(carry, ti):
        A, E, beg, end, best, bi, bj, alive = carry
        tbase, i = ti
        in_t = (i < tlens) & alive
        beg_i = jnp.maximum(beg, i - w_eff)
        end_i = jnp.minimum(jnp.minimum(end, i + w_eff + 1), qlens)
        h1 = jnp.maximum(h0 - (gap_open + gap_extend * (i + 1)), 0)
        lane = jidx[None, :-1]  # query columns 0..Lq-1
        inb = (lane >= beg_i[:, None]) & (lane < end_i[:, None])
        sub = jnp.where(query == tbase[:, None], match, -mismatch)
        h_noF = jnp.maximum(A[:, :-1] + sub, E[:, :-1])
        h_noF = jnp.where(inb, h_noF, NEG)
        # F(beg)=0; F(j+1) = max(F(j)-gape, max(H(j)-gapoe, 0)): the g>=0
        # terms dominate the zero seed, so one max-scan over in-band g
        # (out-of-band forced NEG) reproduces the row recurrence exactly
        g = jnp.where(inb, jnp.maximum(h_noF - gapoe, 0), NEG)
        run = jax.lax.associative_scan(
            jnp.maximum, g + lane * gap_extend, axis=1)
        # F(j) = max_{k<j} (g(k) - (j-1-k)*gape)  [zero seed dominated]
        F = jnp.pad(run[:, :-1] - lane[:, 1:] * gap_extend + gap_extend,
                    ((0, 0), (1, 0)), constant_values=NEG)
        F = jnp.where(lane == beg_i[:, None], 0, F)
        H = jnp.maximum(h_noF, F)
        H = jnp.where(inb, H, 0)
        # row max, ties keep the LATER column (ksw_extend `mj = m>h?mj:j`)
        m = jnp.max(H, axis=1)
        rev_arg = (Lq - 1) - jnp.argmax(H[:, ::-1] == m[:, None], axis=1)
        mj = jnp.where(m > 0, rev_arg.astype(jnp.int32), -1)
        # E(i+1,j) = max(E-gape, max(H-gapoe,0)); only inside the band
        E2 = jnp.where(
            jnp.pad(inb, ((0, 0), (0, 1))),
            jnp.maximum(jnp.pad(E[:, :-1] - gap_extend, ((0, 0), (0, 1)),
                                constant_values=0),
                        jnp.pad(jnp.maximum(H - gapoe, 0), ((0, 0), (0, 1)),
                                constant_values=0)),
            E)
        E2 = jnp.where(jidx[None, :] == end_i[:, None], 0, E2)  # eh[end].e=0
        # A'[j] = H(i, j-1) for j in [beg, end]; A[beg] = h1
        Hs = jnp.pad(H, ((0, 0), (1, 0)))  # Hs[j] = H(j-1)
        upd = (jidx[None, :] >= beg_i[:, None]) & \
            (jidx[None, :] <= end_i[:, None])
        A2 = jnp.where(upd, Hs, A)
        A2 = jnp.where(jidx[None, :] == beg_i[:, None], h1[:, None], A2)
        # band update off the NEW A (= H(i, j-1)): beg' = 1 + last zero in
        # [beg, mj] (else beg); end' = first zero in [mj+2, end] (else end+1)
        zer = A2 == 0
        in_lo = (jidx[None, :] >= beg_i[:, None]) & \
            (jidx[None, :] <= mj[:, None])
        lo_zero = jnp.where(zer & in_lo, jidx[None, :], -1)
        lzmax = jnp.max(lo_zero, axis=1)
        beg2 = jnp.where(lzmax >= 0, lzmax + 1, beg_i)
        in_hi = (jidx[None, :] >= mj[:, None] + 2) & \
            (jidx[None, :] <= end_i[:, None])
        hi_zero = jnp.where(zer & in_hi, jidx[None, :], Lq + 2)
        hzmin = jnp.min(hi_zero, axis=1)
        end2 = jnp.where(hzmin <= Lq + 1, hzmin, end_i + 1)
        # global best: strict >, earliest row; zero row max ends extension
        better = (m > best) & in_t
        best2 = jnp.where(better, m, best)
        bi2 = jnp.where(better, i, bi)
        bj2 = jnp.where(better, mj, bj)
        alive2 = alive & (m > 0) & (i < tlens) | (alive & (i >= tlens))
        keep = in_t[:, None]
        return (jnp.where(keep, A2, A), jnp.where(keep, E2, E),
                jnp.where(in_t, beg2, beg), jnp.where(in_t, end2, end),
                best2, bi2, bj2, alive2), None

    E0 = jnp.zeros((B, Lq + 1), jnp.int32)
    init = (A0, E0, jnp.zeros(B, jnp.int32), qlens.astype(jnp.int32),
            h0.astype(jnp.int32), jnp.full(B, -1, jnp.int32),
            jnp.full(B, -1, jnp.int32), jnp.ones(B, bool))
    tpos = jnp.arange(Lt, dtype=jnp.int32)
    (A, E, beg, end, best, bi, bj, alive), _ = jax.lax.scan(
        row, init,
        (target.T.astype(jnp.int32), jnp.broadcast_to(tpos[:, None], (Lt, B))))
    return best, bj + 1, bi + 1


def ksw_align_scalar(q: bytes, t: bytes, match=1, mismatch=3, gap_open=5,
                     gap_extend=2, minsc=0x10000):
    """Scalar oracle for sw_align_batch: exact-int local SW over target
    rows with ksw's update order (ksw.c ksw_u8/ksw_i16 semantics — H/E/F
    floored at 0 like the saturating lanes, te = first row attaining the
    global max, qe = first in-row max in natural query order, and the
    KSW_XSUBO b-array second-best). Returns a dict of kswr_t fields."""
    Lq, Lt = len(q), len(t)
    gapoe = gap_open + gap_extend
    Hd = np.zeros(Lq, np.int64)
    E = np.zeros(Lq, np.int64)
    gmax, te, Hmax = 0, -1, np.zeros(Lq, np.int64)
    row_max = np.zeros(Lt, np.int64)
    for i in range(Lt):
        H = np.zeros(Lq, np.int64)
        f = 0
        for j in range(Lq):
            sub = match if q[j] == t[i] else -mismatch
            hd = Hd[j - 1] if j else 0
            h = max(hd + sub, E[j], f, 0)
            H[j] = h
            hp = max(h - gapoe, 0)
            E[j] = max(E[j] - gap_extend, hp, 0)
            f = max(f - gap_extend, hp, 0)
        Hd = H
        m = int(H.max()) if Lq else 0
        row_max[i] = m
        if m > gmax:
            gmax, te, Hmax = m, i, H.copy()
    qe = int(np.argmax(Hmax == gmax)) if gmax > 0 else -1
    score2, te2 = kswr_second_best(row_max[None, :], np.array([gmax]),
                                   np.array([te]), minsc, match)
    return dict(score=gmax, te=te, qe=qe, score2=int(score2[0]),
                te2=int(te2[0]), row_max=row_max)


def ksw_extend_scalar(q: bytes, t: bytes, h0: int, w: int = 100, match=1,
                      mismatch=3, gap_open=5, gap_extend=2):
    """Scalar oracle for sw_extend_batch: a direct port of ksw_extend
    (reference klib/ksw.c:362-434) — banded, adaptive [beg,end), row-max
    ties keep the later column, zero row max terminates. TEST ORACLE ONLY.
    Returns (score, qle, tle)."""
    qlen, tlen = len(q), len(t)
    gapoe = gap_open + gap_extend
    h0 = max(h0, 0)
    eh_h = np.zeros(qlen + 2, np.int64)
    eh_e = np.zeros(qlen + 2, np.int64)
    eh_h[0] = h0
    eh_h[1] = h0 - gapoe if h0 > gapoe else 0
    j = 2
    while j <= qlen and eh_h[j - 1] > gap_extend:
        eh_h[j] = eh_h[j - 1] - gap_extend
        j += 1
    max_gap = int((qlen * match - gap_open) / gap_extend + 1.0)
    max_gap = max(max_gap, 1)
    w = min(w, max_gap)
    best, max_i, max_j = h0, -1, -1
    beg, end = 0, qlen
    for i in range(tlen):
        f, h1, m, mj = 0, max(h0 - (gap_open + gap_extend * (i + 1)), 0), 0, -1
        beg = max(beg, i - w)
        end = min(end, i + w + 1, qlen)
        for jj in range(beg, end):
            h, e = eh_h[jj], eh_e[jj]
            eh_h[jj] = h1
            h += match if q[jj] == t[i] else -mismatch
            h = max(h, e, f)
            h1 = h
            if h >= m:
                m, mj = h, jj
            h = max(h - gapoe, 0)
            e = max(e - gap_extend, h)
            eh_e[jj] = e
            f = max(f - gap_extend, h)
        eh_h[end] = h1
        eh_e[end] = 0
        if m == 0:
            break
        if m > best:
            best, max_i, max_j = m, i, mj
        jj = mj
        while jj >= beg and eh_h[jj]:
            jj -= 1
        beg = jj + 1
        jj = mj + 2
        while jj <= end and eh_h[jj]:
            jj += 1
        end = jj
    return best, max_j + 1, max_i + 1


def sw_score_numpy(q: bytes, t: bytes, match=1, mismatch=3, gap_open=5,
                   gap_extend=2) -> int:
    """Reference DP oracle (O(Lq*Lt) scalar)."""
    Lq, Lt = len(q), len(t)
    H = np.zeros((Lq + 1, Lt + 1), dtype=np.int64)
    E = np.full((Lq + 1, Lt + 1), NEG, dtype=np.int64)
    F = np.full((Lq + 1, Lt + 1), NEG, dtype=np.int64)
    best = 0
    for i in range(1, Lq + 1):
        for j in range(1, Lt + 1):
            E[i, j] = max(H[i - 1, j] - gap_open - gap_extend,
                          E[i - 1, j] - gap_extend)
            F[i, j] = max(H[i, j - 1] - gap_open - gap_extend,
                          F[i, j - 1] - gap_extend)
            s = match if q[i - 1] == t[j - 1] else -mismatch
            H[i, j] = max(0, H[i - 1, j - 1] + s, E[i, j], F[i, j])
            best = max(best, H[i, j])
    return int(best)
