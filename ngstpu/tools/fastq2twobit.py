"""fastq2twobit: pack FASTQ sequences into the reference 2-bit container.

Parity target: reference fastq2twobit.c. Container = 2-byte header
{uint8 readLen, uint8 packedLen} taken from the FIRST emitted record
(:150-156), then per-record ceil(len/4) packed bytes (each record packs its
OWN length, :150). Records are emitted in REVERSE input order — the
reference loads into a prepend list and dumps head-first without the
(commented-out) sort (:101-113 dump_array with arrays[i++]).
Output file gets the reference's accidental "_sort_by_seq.fq"
("_sort_by_name.fq" with -n) suffix (:128); default "-" -> stdout.
Packing is the device 2-bit kernel (T/U->0, C->1, A->2, G->3, N->T,
reference twoBit.h:54-71,167-181).
"""

from __future__ import annotations

import getopt
import sys

import numpy as np

from ..io.fastq import read_fastq_file
from ..io.stream import open_output, with_suffix
from ..utils.timing import StageTimer

# jax / the device kernel import lazily: the 2-bit pack is a byte-table
# op the host runs at memory speed (ops.twobit_host.pack2bit_np) unless a
# co-located device link makes shipping the matrix worthwhile.

import os


def _run_fast(infile: str, outfile: str, by_name: int, by_seq: int,
              timer: StageTimer) -> bool:
    """Offset-indexed pack (round-5): mmap + index, then chunked
    fill_padded -> numpy 2-bit pack -> ragged flatten, walking records in
    REVERSE input order (the reference's prepend-list dump,
    fastq2twobit.c:101-113) without ever materializing the padded batch.
    Returns False when the fast path does not apply (stdout, gz handled
    via the shared inflate, no native lib)."""
    from ..io.fastindex import index_fastq
    from ..io.native import get_lib
    from ..ops.twobit_host import pack2bit_np
    from ..utils.bufpool import get_buffer

    lib = get_lib()
    if lib is None or outfile.startswith("-") or not outfile:
        return False
    ix = index_fastq(infile, pool="f2b.ix")
    if ix is None:
        return False
    timer.log("done read file at %.3f s\n")
    suffix = ("_sort_by_name.fq" if (by_name and not by_seq)
              else "_sort_by_seq.fq")
    B = ix.n
    with open(with_suffix(outfile, suffix), "wb") as out:
        if B:
            last = B - 1
            read_len = int(ix.seq_len[last]) & 0xFF
            packed_len = ((int(ix.seq_len[last]) + 3) // 4) & 0xFF
            out.write(bytes([read_len, packed_len]))
            CH = 1 << 19
            lmax = max(int(ix.seq_len.max()), 1)
            lmax4 = (lmax + 3) // 4 * 4
            for hi in range(B, 0, -CH):
                lo = max(hi - CH, 0)
                k = hi - lo
                # reversed record order within the chunk
                offs = ix.seq_off[lo:hi][::-1].copy()
                lens = ix.seq_len[lo:hi][::-1].copy()
                padded = get_buffer("f2b.pad", k * lmax4).reshape(k, lmax4)
                lib.ngs_fill_padded(ix.data, offs, lens, k, lmax4,
                                    padded, 0)
                packed = pack2bit_np(padded)
                plens = ((lens.astype(np.int64) + 3) // 4).astype(np.int32)
                col = np.arange(packed.shape[1])
                flat = packed[col[None, :] < plens[:, None]]
                out.write(flat.tobytes())
    timer.log("done write file at %.3f s\n")
    return True


def main(argv: list[str]) -> int:
    timer = StageTimer()
    infile, outfile = "-", "-"
    by_name = by_seq = 0
    if not argv:
        _usage()
        return 1
    opts, _ = getopt.gnu_getopt(argv, "i:o:nsh?")
    for flag, val in opts:
        if flag == "-i":
            infile = val
        elif flag == "-o":
            outfile = val
        elif flag == "-n":
            by_name, by_seq = 1, 0
        elif flag == "-s":
            by_name, by_seq = 0, 1
        elif flag in ("-h", "-?"):
            _usage()
            return 1
    sys.stderr.write(f"name: {by_name}\tseq: {by_seq}\n")

    if not os.environ.get("NGSTPU_NO_FASTPATH") \
            and _run_fast(infile, outfile, by_name, by_seq, timer):
        return 0
    batch = read_fastq_file(infile, need=("seq",))
    timer.log("done read file at %.3f s\n")
    from ..utils.placement import placement

    seq = np.ascontiguousarray(batch.seq)
    if seq.shape[1] % 4:
        seq = np.pad(seq, ((0, 0), (0, 4 - seq.shape[1] % 4)))
    if placement() == "device" and seq.nbytes >= (8 << 20):
        import jax.numpy as jnp

        from ..ops.twobit import pack2bit

        packed = np.asarray(pack2bit(jnp.asarray(seq)))  # [B, Lmax//4]
    else:
        from ..ops.twobit_host import pack2bit_np

        packed = pack2bit_np(seq)
    suffix = "_sort_by_name.fq" if (by_name and not by_seq) else "_sort_by_seq.fq"
    out = open_output(with_suffix(outfile, suffix))

    order = np.arange(batch.n - 1, -1, -1)  # reverse input order
    lens = batch.lens
    if batch.n:
        first = int(order[0])
        read_len = int(lens[first]) & 0xFF
        packed_len = ((int(lens[first]) + 3) // 4) & 0xFF
        out.write(bytes([read_len, packed_len]))
        # each record contributes ceil(len/4) bytes of its own packed row
        plens = ((lens[order].astype(np.int64) + 3) // 4).astype(np.int32)
        rows = packed[order]
        # ragged flatten of leading plens[i] bytes per row
        col = np.arange(rows.shape[1])
        flat = rows[col[None, :] < plens[:, None]]
        out.write(flat.tobytes())
    if out is not sys.stdout.buffer:
        out.close()
    else:
        out.flush()
    timer.log("done write file at %.3f s\n")
    return 0


def _usage() -> None:
    sys.stderr.write(
        "Usage: ngstpu fastq2twobit [-i Infile] [-o OUTFILE] [-s|-n] [-h]\n")
