"""gzfastq_sort: whole-file FASTQ sort by sequence or name on the device.

Parity target: reference gzfastq_sort.c. Comparators are length-first, then
strcmp (comp_name :85-93, comp_seq :95-103); glibc qsort is stable
(mergesort), so ties keep input order — our stable device sort matches.
Output file = outfile + "_sort_by_name.fq" / "_sort_by_seq.fq"
(:122-128); default outfile "-" streams to stdout. -r (preallocation hint)
is accepted and ignored — we size from the data.
"""

from __future__ import annotations

import getopt
import sys

import numpy as np

from ..io.fastq import format_fastq, read_fastq_file
from ..io.stream import open_output, with_suffix
from ..utils.placement import placement
from ..utils.timing import StageTimer

# jax and the device sort engine import lazily (inside the device
# branches), so a host-placement run never starts a JAX client.

OUT_CHUNK = 1 << 20


def emit_permuted(out, batch, perm: np.ndarray) -> None:
    """Write records of `batch` in `perm` order (fused native gather+format,
    chunked fallback)."""
    from ..io.native import format_fastq_take

    if len(perm):
        text = format_fastq_take(batch.names, batch.name_starts,
                                 batch.name_lens, perm, None,
                                 batch.seq, batch.lens, perm,
                                 batch.qual, batch.lens, perm)
        if text is not None:
            out.write(text)
            return
    for lo in range(0, len(perm), OUT_CHUNK):
        sub = batch.take(perm[lo:lo + OUT_CHUNK])
        out.write(format_fastq(sub.names, sub.name_starts, sub.name_lens,
                               sub.seq, sub.qual, sub.lens))


def _mesh_perm(words_host: np.ndarray, lens: np.ndarray,
               mesh_n: int) -> np.ndarray:
    """Distributed sample-sort over an `mesh_n`-device mesh
    (parallel/dsort.py); raises when -m exceeds the devices present."""
    from ..parallel.dsort import distributed_sort
    from ..parallel.mesh import make_mesh

    return distributed_sort(make_mesh(mesh_n), words_host,
                            np.asarray(lens, np.int32), length_first=True)


def _run_sort_fast(infile: str, outfile: str, by_name: bool,
                   timer: StageTimer) -> bool:
    """Offset-indexed whole-file sort (round-4 fast path): mmap + index,
    collation words packed chunk-wise straight from the offsets (the
    padded byte matrix never materializes whole), the device LSD
    permutation (the native 256-bucket sort under NGSTPU_LINK=host), and
    records emitted from the raw bytes in permuted order
    (io/fastindex.take_text) with a ring writer overlapping format and
    file writes. Roughly halves both the wall time and the peak RSS of
    the generic padded-batch path at the 10M-read scale (the reference
    loads and qsorts every record in memory, gzfastq_sort.c:243-249).
    Returns False when the fast path does not apply."""
    import ctypes
    import os

    from ..io.fastindex import index_fastq, take_text
    from ..io.native import get_lib
    from ..ops.hostsort import sort_perm_host
    from ..utils.bufpool import get_buffer, get_matrix
    from .emitters import _RingWriter, _fresh

    if (not outfile or outfile.startswith("-")
            or os.environ.get("NGSTPU_NO_FASTPATH")):
        return False
    lib = get_lib()
    if lib is None:
        return False
    from ..utils.timing import StageRusage

    ru = StageRusage()
    ix = index_fastq(infile, pool="sort.ix")
    if ix is None or ix.n == 0:
        return False
    B = ix.n
    timer.log("done read file at %.3f s\n")
    ru.checkpoint("index")
    offs = ix.name_off if by_name else ix.seq_off
    klens = np.ascontiguousarray(ix.name_len if by_name else ix.seq_len,
                                 np.int32)
    lmax = max(int(klens.max()), 4)

    # pack collation words straight from the offsets. Sequences try the
    # 3-bit DNA packing (identical collation on {.ACGNT}, 3.3x narrower
    # keys) in ONE fused native pass (ngs_dna3_pack_ofs — no padded
    # intermediate); a wider alphabet restarts the pack raw (chunked
    # fill_padded + big-endian view). Names always pack raw.
    kind = "raw" if by_name else "dna3"
    if kind == "dna3":
        W = (lmax + 9) // 10
        words = get_matrix("sort.words", B, W, np.uint32)
        if lib.ngs_dna3_pack_ofs(ix.data, offs, klens, B, W, words, 0):
            kind = "raw"
    if kind == "raw":
        CH = 1 << 20
        lmax4 = (lmax + 3) // 4 * 4
        W = lmax4 // 4
        words = get_matrix("sort.words", B, W, np.uint32)
        for lo in range(0, B, CH):
            hi = min(lo + CH, B)
            padded = get_buffer("sort.pad", (hi - lo) * lmax4
                                ).reshape(hi - lo, lmax4)
            # (ngs_fill_padded zero-fills each row's tail itself)
            lib.ngs_fill_padded(ix.data, offs[lo:hi],
                                klens[lo:hi], hi - lo, lmax4, padded, 0)
            words[lo:hi] = padded.view(">u4")

    v = placement()
    if v == "host":
        # constant-length keys make the length-first comparator vacuous;
        # dropping it lets the host engine bucket by the leading packed
        # byte (256-way parallel radix) instead of collapsing every row
        # into one length bucket (a single-threaded sort at 10M rows)
        const = B > 0 and int(klens.min()) == int(klens.max())
        if const:
            # STREAMED sort->emit (round 5): byte buckets ARE output
            # order when lengths are constant, so a sorter thread hands
            # each finished bucket to the emitter while later buckets
            # still radix — the sort stage leaves the critical path
            _stream_sorted_emit(ix, words, outfile, by_name, timer, ru)
            return True
        perm = sort_perm_host(words, klens, True)
    else:
        import jax.numpy as jnp

        from ..ops.sortengine import lex_argsort

        perm = np.asarray(lex_argsort(jnp.asarray(words),
                                      jnp.asarray(klens),
                                      length_first=True))
    timer.log("done qsort file at %.3f s\n")
    ru.checkpoint("pack_sort")

    suffix = "_sort_by_name.fq" if by_name else "_sort_by_seq.fq"
    with open(_fresh(with_suffix(outfile, suffix)), "wb",
              buffering=0) as f:
        from .emitters import _RecyclingSink

        w = _RingWriter(_RecyclingSink(f), ["sort.emitA", "sort.emitB"])
        try:
            for lo in range(0, B, 1 << 19):
                sl = perm[lo:lo + (1 << 19)]
                name = w.acquire()
                view, total = take_text(ix, sl, name)
                w.submit(name, view, total)
        finally:
            w.close()
    timer.log("done write file at %.3f s\n")
    ru.checkpoint("emit_write")
    ru.dump(tool="gzfastq_sort", reads=B, placement=v)
    return True


def _stream_sorted_emit(ix, words: np.ndarray, outfile: str, by_name: bool,
                        timer: StageTimer, ru) -> None:
    """Constant-length host sort with the radix streamed under the emit:
    ngs_msd_scatter_u32 builds the stable 256-bucket permutation, a
    sorter thread radixes buckets in ascending (== output) order
    (ngs_sort_perm_range, GIL released), and the main thread formats +
    submits each completed bucket range to the ring writer. Order is
    identical to sort_perm_host(words, lens, length_first) on equal
    lengths — covered by the byte-parity oracle tests."""
    import ctypes
    import queue
    import threading

    from ..io.fastindex import take_text
    from ..io.native import get_lib
    from ..utils.bufpool import get_buffer
    from .emitters import _RecyclingSink, _RingWriter, _fresh

    lib = get_lib()
    B, W = words.shape
    perm = get_buffer("sort.perm", 4 * B, np.int32)[:B]
    boff = np.zeros(257, np.int64)
    lib.ngs_msd_scatter_u32(words, B, W, perm, boff)
    done_q: "queue.Queue[int]" = queue.Queue()
    box: list = []

    def sorter():
        try:
            for k in range(256):
                if boff[k + 1] > boff[k]:
                    lib.ngs_sort_perm_range(words, W, perm,
                                            int(boff[k]), int(boff[k + 1]))
                done_q.put(k)
        except BaseException as e:  # pragma: no cover - surfaced below
            box.append(e)
            done_q.put(-1)

    t = threading.Thread(target=sorter, daemon=True)
    t.start()
    timer.log("done qsort file at %.3f s\n")
    ru.checkpoint("pack_sort")
    suffix = "_sort_by_name.fq" if by_name else "_sort_by_seq.fq"
    with open(_fresh(with_suffix(outfile, suffix)), "wb",
              buffering=0) as f:
        w = _RingWriter(_RecyclingSink(f), ["sort.emitA", "sort.emitB"])
        try:
            emitted = 0   # buckets formatted
            ready = -1    # highest contiguous sorted bucket
            # group small buckets: submit once >= this many rows ready
            MIN_ROWS = 1 << 18
            pend_lo = 0
            while emitted < 256:
                k = done_q.get()
                if k < 0:
                    raise box[0]
                ready = k
                lo, hi = pend_lo, int(boff[ready + 1])
                if hi - lo >= MIN_ROWS or ready == 255:
                    for clo in range(lo, hi, 1 << 19):
                        chi = min(clo + (1 << 19), hi)
                        name = w.acquire()
                        view, total = take_text(
                            ix, perm[clo:chi].astype(np.int64), name)
                        w.submit(name, view, total)
                    pend_lo = hi
                emitted = ready + 1
        finally:
            w.close()
    t.join()
    timer.log("done write file at %.3f s\n")
    ru.checkpoint("emit_write")
    ru.dump(tool="gzfastq_sort", reads=B, placement="host")


def sort_perm_by_seq(batch, mesh_n: int = 0) -> np.ndarray:
    if mesh_n > 1:
        from ..ops.hostsort import seq_words_host

        return _mesh_perm(seq_words_host(batch.seq), batch.lens, mesh_n)
    if placement() == "host":
        from ..ops.hostsort import seq_words_host, sort_perm_host

        perm = sort_perm_host(seq_words_host(batch.seq), batch.lens, True)
        if perm is not None:
            return perm
    import jax.numpy as jnp

    from ..ops.sortengine import lex_argsort, seq_words

    words = seq_words(batch.seq)
    return np.asarray(lex_argsort(words, jnp.asarray(batch.lens),
                                  length_first=True))


def sort_perm_by_name(batch, mesh_n: int = 0) -> np.ndarray:
    from ..io.native import fill_padded

    lmax = max(int(batch.name_lens.max(initial=0)), 4)
    lmax = (lmax + 3) // 4 * 4
    padded = fill_padded(batch.names, batch.name_starts, batch.name_lens, lmax)
    if mesh_n > 1:
        from ..ops.hostsort import bytes_to_words_host

        return _mesh_perm(bytes_to_words_host(padded), batch.name_lens,
                          mesh_n)
    if placement() == "host":
        from ..ops.hostsort import bytes_to_words_host, sort_perm_host

        perm = sort_perm_host(bytes_to_words_host(padded), batch.name_lens,
                              True)
        if perm is not None:
            return perm
    import jax.numpy as jnp

    from ..ops.sortengine import bytes_to_words, lex_argsort

    words = bytes_to_words(jnp.asarray(padded))
    return np.asarray(lex_argsort(words, jnp.asarray(batch.name_lens),
                                  length_first=True))


def main(argv: list[str]) -> int:
    timer = StageTimer()
    infile, outfile = "-", "-"
    by_name = by_seq = 0
    if not argv:
        _usage()
        return 1
    import os

    mesh_n = int(os.environ.get("NGSTPU_MESH", "0"))
    opts, _ = getopt.gnu_getopt(argv, "i:o:r:m:nsh?")
    for flag, val in opts:
        if flag == "-i":
            infile = val
        elif flag == "-o":
            outfile = val
        elif flag == "-r":
            pass  # preallocation hint: unnecessary here
        elif flag == "-m":
            mesh_n = int(val)
        elif flag == "-n":
            by_name, by_seq = 1, 0
        elif flag == "-s":
            by_name, by_seq = 0, 1
        elif flag in ("-h", "-?"):
            _usage()
            return 1
    if not by_name and not by_seq:
        by_seq = 1
    sys.stderr.write(f"name: {by_name}\tseq: {by_seq}\n")

    if mesh_n <= 1 and _run_sort_fast(infile, outfile, bool(by_name),
                                      timer):
        return 0
    batch = read_fastq_file(infile)
    timer.log("done read file at %.3f s\n")
    if by_name:
        perm = sort_perm_by_name(batch, mesh_n)
        out = open_output(with_suffix(outfile, "_sort_by_name.fq"))
    else:
        perm = sort_perm_by_seq(batch, mesh_n)
        out = open_output(with_suffix(outfile, "_sort_by_seq.fq"))
    timer.log("done qsort file at %.3f s\n")
    emit_permuted(out, batch, perm)
    if out is not sys.stdout.buffer:
        out.close()
    else:
        out.flush()
    timer.log("done write file at %.3f s\n")
    return 0


def _usage() -> None:
    sys.stderr.write(
        "Usage: ngstpu gzfastq_sort [-i Infile] [-o OUTFILE] [-r reads_num] [-s|-n] [-h]\n"
        "   [-i Infile] = Infile.\n"
        "   [-o OUTPUT] = OUTPUT file. default is stdout\n"
        "   [-s ] sort by sequence.\n"
        "   [-m MESH] shard the sort over a MESH-device dp mesh"
        " (ngstpu extension; env NGSTPU_MESH).\n"
        "   [-n ] sort by sequence name.\n")
