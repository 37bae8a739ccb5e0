"""ordered_uniq: ordered dedup with order-statistics (rank) queries.

Capability equivalent of the reference's three ordered-container demos —
kbtree_kseq.c (B-tree dedup, in-order dump), skiplist_kseq.c (rank-skiplist:
`skiplist_key_rank` / `skiplist_search_by_rank`, :96-107) and map_kseq.cpp
(std::map) — expressed as one device sort; ordered iteration is
the sorted order, rank(key) and select(rank) are index arithmetic on the
sorted unique set (SURVEY.md §2b item 5).

Default: dump every unique record in key order as "name rank\\nseq\\n+\\nqual"
(first occurrence kept). -r K prints only ranks 1..K (the skiplist demo's
first-20 loop, skiplist_kseq.c:100-105). stderr reports the unique count
(kbtree_kseq.c:40).
"""

from __future__ import annotations

import getopt
import sys

import numpy as np
import jax.numpy as jnp

from ..io.fastq import read_fastq_file
from ..io.native import format_fastq_take
from ..io.stream import open_output
from ..ops.sortengine import dedup_groups, pack_for_dedup
from ..utils.timing import StageTimer


def ordered_unique(batch):
    """(rep, counts): unique sequences in key order, first-occurrence
    representatives (rank i = row i of the result, 1-based)."""
    words, encode_len = pack_for_dedup(batch.seq)
    g = dedup_groups(words, jnp.asarray(batch.lens),
                     jnp.zeros(batch.n, jnp.uint32), batch.n,
                     length_first=False, words_encode_len=encode_len)
    return g["rep"], g["counts"]


def rank_of(sorted_rep_seqs: list[bytes], seq: bytes) -> int:
    """1-based rank of `seq` in the unique set (bisect = the skiplist's
    key_rank); 0 if absent."""
    import bisect

    i = bisect.bisect_left(sorted_rep_seqs, seq)
    if i < len(sorted_rep_seqs) and sorted_rep_seqs[i] == seq:
        return i + 1
    return 0


def main(argv: list[str]) -> int:
    timer = StageTimer()
    infile, outfile, top_k = "-", "-", 0
    opts, _ = getopt.gnu_getopt(argv, "i:o:r:h?")
    for flag, val in opts:
        if flag == "-i":
            infile = val
        elif flag == "-o":
            outfile = val
        elif flag == "-r":
            top_k = int(val)
        elif flag in ("-h", "-?"):
            sys.stderr.write(
                "Usage: ngstpu ordered_uniq [-i IN] [-o OUT] [-r K]\n"
                "  ordered dedup by sequence; -r K prints only ranks 1..K\n")
            return 1
    if not argv:
        infile = "-"
    batch = read_fastq_file(infile)
    rep, counts = ordered_unique(batch)
    sys.stderr.write(f"{len(rep)}\n")  # kbtree_kseq.c:40 prints kb_size
    if top_k:
        rep = rep[:top_k]
    ranks = np.arange(1, len(rep) + 1, dtype=np.int64)
    out = open_output(outfile)
    text = format_fastq_take(batch.names, batch.name_starts, batch.name_lens,
                             rep, ranks, batch.seq, batch.lens, rep,
                             batch.qual, batch.lens, rep)
    if text is not None:
        out.write(text)
    else:  # no native lib: small-python fallback
        for r, k in zip(rep.tolist(), ranks.tolist()):
            out.write(batch.name(r) + b"\t%d\n" % k)
            out.write(batch.seq_bytes(r) + b"\n+\n")
            out.write(batch.qual_bytes(r) + b"\n")
    if out is not sys.stdout.buffer:
        out.close()
    timer.log("Finished at %.3f s\n")
    return 0
