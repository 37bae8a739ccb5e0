"""pipeline: fused count + trim + uniq over a single pass of the input.

The reference runs fastq_count, fastq_trim and gzfastq_uniq as three
processes, each re-reading (and re-decompressing) the file
(fastq_count.c:106-133, fastq_trim.c:67-108, gzfastq_uniq.c:194-281). The
fused pipeline reads once and runs the QC histogram, the trim slice
and the dedup sort as one overlapped schedule — outputs are identical to
running the three tools separately.

Fast path (plain files, ACGT data, native lib): the input is mmap'd and
indexed in place (io/fastindex.py); ONE fused native pass computes the QC
histograms, quality sums and 2-bit device sort keys while the trim output
is assembled straight from the raw bytes and written by a background
thread; the dedup runs as P key-range partitions on the device so the
emit of partition k overlaps the sort of partition k+1; the duplicate
_sortKeyUniq.fq output is a kernel-side copy_file_range clone. The generic
path (stdin/gzip/wide alphabets) is the chunked padded-batch pipeline.
NGSTPU_LINK=host runs the fast path's dedup sort and the chunked path's
QC histogram on their host engines instead (utils/placement.py); the
outputs are the same bytes.

Usage: ngstpu pipeline -i in.fq -o prefix [-s start] [-e end]
Outputs: {prefix}.count.tsv, {prefix}.trim.fastq, {prefix}_uniq.fq,
{prefix}_sortKeyUniq.fq.
"""

from __future__ import annotations

import getopt
import os
import queue
import sys
import threading

import numpy as np
import jax.numpy as jnp

from ..io.fastq import format_fastq
from ..ops.count import QCAccumulator
from ..ops.sortengine import sum_quality_host
from ..utils.timing import StageTimer
from .emitters import (CHUNK_RECORDS, N_PARTS, _CloningSink, _RingWriter,
                       _fresh, _partition_bounds, _sort_device_async,
                       _sort_host_async)
from .fastq_count import _row
from .fastq_trim import trim_batch
from .gzfastq_uniq import _emit





def run_fast(fused, infile: str, prefix: str, start: int, end: int,
             timer: StageTimer) -> dict | None:
    """Offset-indexed overlapped pipeline over the one-sweep
    index_fastq_fused result. Returns None when the data is not pure ACGT
    (caller falls back to the generic path)."""
    from ..io.fastindex import trim_text
    from ..utils.bufpool import get_buffer

    ix, words_all, sumq_all, hist_q, hist_len, bucket, ok = fused
    if not ok:
        return None
    B = ix.n
    lmax = int(ix.seq_len.max()) if B else 0
    W = words_all.shape[1]

    # dispatch the dedup sort FIRST: its inputs (packed words, quality
    # sums) are complete the moment the fused index pass returns, so the
    # device sorts (or the host sort thread) run concurrently with the
    # whole trim-assembly loop below instead of starting after it
    const_len = B > 0 and int(ix.seq_len.min()) == lmax
    from ..utils.placement import placement

    if placement() == "host":
        rep_groups = _sort_host_async(words_all, ix.seq_len, sumq_all,
                                      const_len)
    else:
        rep_groups = _sort_device_async(words_all, ix.seq_len, sumq_all,
                                        bucket, const_len, W)

    # trim: text assembled straight from the raw bytes per chunk and
    # written by the ring writer (formatting chunk k+1 overlaps writing k)
    cl = np.clip(np.minimum(ix.seq_len.astype(np.int64), end) - start, 0,
                 None)
    trim_rec = ix.name_len.astype(np.int64) + 1 + cl + 3 + cl + 1
    chunk_trim_cap = 1
    for lo in range(0, B, CHUNK_RECORDS):
        chunk_trim_cap = max(chunk_trim_cap,
                             int(trim_rec[lo:lo + CHUNK_RECORDS].sum()))
    ring_names = ["pipe.trim0", "pipe.trim1", "pipe.trim2"]
    tf = open(_fresh(prefix + ".trim.fastq"), "wb")
    from .emitters import _RecyclingSink

    trim_writer = _RingWriter(_RecyclingSink(tf), ring_names)
    try:
        for lo in range(0, B, CHUNK_RECORDS):
            hi = min(lo + CHUNK_RECORDS, B)
            name = trim_writer.acquire()
            buf = get_buffer(name, chunk_trim_cap)
            total = trim_text(ix, lo, hi, start, end, buf)
            trim_writer.submit(name, buf, total)
        timer.checkpoint("parse")
        # the trim writer keeps draining in the background: the trim file
        # write overlaps the dedup sort + uniq emit below (it only gates
        # the final return, where close() joins and surfaces any IO error)

        acc = QCAccumulator.from_host_partials(hist_q, hist_len)
        with open(prefix + ".count.tsv", "w") as out:
            out.write(_row(infile, acc))
        timer.checkpoint("dispatch")

        # stream the emit: format/write group block k while block k+1 is
        # still sorting (device) or while the writer drains (host); the
        # duplicate output is cloned range-by-range kernel-side per block
        n_groups = 0
        from ..io.fastindex import uniq_text

        uniq_path = prefix + "_uniq.fq"
        with open(_fresh(uniq_path), "wb", buffering=0) as uf, \
                open(_fresh(prefix + "_sortKeyUniq.fq"), "wb",
                     buffering=0) as cf:
            writer = _RingWriter(_CloningSink(uf, cf), ["pipe.emit0",
                                                        "pipe.emit1"])
            try:
                for rep, counts in rep_groups:
                    n_groups += len(rep)
                    if len(rep) == 0:
                        continue
                    name = writer.acquire()
                    view, total = uniq_text(ix, rep, counts, name)
                    writer.submit(name, view, total)
            finally:
                writer.close()
    finally:
        try:
            trim_writer.close()
        finally:
            tf.close()
    timer.checkpoint("uniq_write")
    return dict(n=B, n_groups=n_groups, stages=dict(timer.stages))


def run_generic(infile: str, prefix: str, start: int, end: int,
                timer: StageTimer) -> dict:
    from ..io.fastq import FastqChunkReader, concat_batches
    from ..ops.sortengine import (classify_alphabet, dedup_sorted,
                                  pack_for_dedup, pack_words_host)

    # Parse chunk-by-chunk, overlapping host decode with device transfers:
    # each chunk's quality histogram is dispatched and its packed sort
    # words shipped while the reader inflates the next chunk. Sort keys use
    # the narrowest packing the first chunk's alphabet allows (2-bit for
    # pure ACGT); a later chunk with a wider alphabet forces one consistent
    # repack of the whole batch at the end (rare: N-containing tails).
    acc = QCAccumulator()
    batches = []
    word_chunks = []
    sumq_parts = []
    kind: str | None = None
    mixed = False
    for chunk in FastqChunkReader(infile):
        acc.add_batch(chunk.qual, chunk.lens, chunk.n)
        sumq_parts.append(sum_quality_host(chunk.qual))
        if not mixed:
            k = classify_alphabet(chunk.seq)
            if kind is None:
                kind = k
            if k == kind:
                word_chunks.append(jnp.asarray(pack_words_host(chunk.seq,
                                                               kind)))
            else:
                mixed = True
        batches.append(chunk)
    batch = concat_batches(batches)
    timer.checkpoint("parse")

    if not mixed and word_chunks:
        wmax = max(w.shape[1] for w in word_chunks)
        words = jnp.concatenate(
            [jnp.pad(w, ((0, 0), (0, wmax - w.shape[1])))
             if w.shape[1] != wmax else w for w in word_chunks])
        encode_len = kind == "dna3"
    else:
        # alphabet widened mid-file: one consistent repack
        words, encode_len = pack_for_dedup(batch.seq)
    sumq = jnp.asarray(np.concatenate(sumq_parts) if sumq_parts
                       else np.zeros(0, np.uint32))
    res = dedup_sorted(words, jnp.asarray(batch.lens), sumq,
                       jnp.int32(batch.n), length_first=False,
                       words_encode_len=encode_len, maybe_padding=False)
    timer.checkpoint("dispatch")

    # 2) trim (host slice + write) overlaps the device sort; the threaded
    # writer overlaps formatting chunk k+1 with writing chunk k
    from ..io.native import format_fastq_take
    from ..utils.iopipe import TeeWriter

    seq_t, qual_t, lens_t = trim_batch(batch, start, end)
    seq_t = np.ascontiguousarray(seq_t)
    qual_t = np.ascontiguousarray(qual_t)
    with open(prefix + ".trim.fastq", "wb") as f:
        tee = TeeWriter([f])
        try:
            step = 1 << 18
            done = False
            for lo in range(0, batch.n, step):
                idx = np.arange(lo, min(lo + step, batch.n), dtype=np.int64)
                text = format_fastq_take(
                    batch.names, batch.name_starts, batch.name_lens, idx,
                    None, seq_t, lens_t, idx, qual_t, lens_t, idx)
                if text is None:
                    break
                tee.write(text)
            else:
                done = True
        finally:
            tee.close()
        if not done:  # no native lib: single formatted write
            f.seek(0)
            f.truncate()
            f.write(format_fastq(batch.names, batch.name_starts,
                                 batch.name_lens, seq_t, qual_t, lens_t))
    timer.checkpoint("trim_write")

    # 3) pull dedup results, group math on host
    perm = np.asarray(res["perm"])
    is_head = np.asarray(res["is_head"])
    timer.checkpoint("dedup_pull")
    head_pos = np.flatnonzero(is_head)
    counts = np.diff(np.concatenate([head_pos, [batch.n]]))
    rep = perm[head_pos]
    n_groups = len(head_pos)

    with open(prefix + ".count.tsv", "w") as out:
        out.write(_row(infile, acc))

    # the two uniq outputs are identical records in identical order (we
    # emit key-sorted for both) — format once, write both concurrently;
    # the tee threads overlap the two file writes with formatting
    with open(prefix + "_uniq.fq", "wb") as f1, \
            open(prefix + "_sortKeyUniq.fq", "wb") as f2:
        tee = TeeWriter([f1, f2])
        try:
            _emit(tee, batch, rep, counts)
        finally:
            tee.close()
    timer.checkpoint("uniq_write")
    return dict(n=batch.n, n_groups=n_groups,
                stages=dict(timer.stages))


def run(infile: str, prefix: str, start: int, end: int,
        timer: StageTimer | None = None) -> dict:
    timer = timer or StageTimer()
    if not os.environ.get("NGSTPU_NO_FASTPATH"):
        from ..io.fastindex import index_fastq_fused

        fused = index_fastq_fused(infile, pool="pipe")
        if fused is not None:
            info = run_fast(fused, infile, prefix, start, end, timer)
            if info is not None:
                return info
            # non-ACGT alphabet: rerun on the generic chunked path
    return run_generic(infile, prefix, start, end, timer)


def main(argv: list[str]) -> int:
    timer = StageTimer()
    infiles, prefix, start, end = [], "out", 0, 400
    opts, extra = getopt.gnu_getopt(argv, "i:o:s:e:h?")
    for flag, val in opts:
        if flag == "-i":
            infiles.append(val)
        elif flag == "-o":
            prefix = val
        elif flag == "-s":
            start = int(val)
        elif flag == "-e":
            end = int(val)
        elif flag in ("-h", "-?"):
            sys.stderr.write(
                "Usage: ngstpu pipeline -i in.fq [-i in2.fq ...] -o prefix"
                " [-s start] [-e end]\n"
                "  multi-lane runs share one process: compiled programs are\n"
                "  reused and the next lane's bytes prefetch in background\n")
            return 1
    infiles += extra
    if not infiles:
        infiles = ["-"]

    def prefetch(path):
        try:
            with open(path, "rb") as f:  # warm the page cache
                while f.read(32 << 20):
                    pass
        except OSError:
            pass

    for k, infile in enumerate(infiles):
        if k + 1 < len(infiles) and infiles[k + 1] != "-":
            threading.Thread(target=prefetch, args=(infiles[k + 1],),
                             daemon=True).start()
        out_prefix = prefix if len(infiles) == 1 else f"{prefix}.{k + 1}"
        info = run(infile, out_prefix, start, end, timer)
        sys.stderr.write(f"{infile}: reads: {info['n']}\n"
                         f"unique: {info['n_groups']}\n")
    timer.log("Finished at %.3f s\n")
    return 0
