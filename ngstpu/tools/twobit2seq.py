"""twoBit2seq: unpack the 2-bit container back into one sequence per line.

Parity target: reference twoBit2seq.c. Reads the 2-byte header
{readLen, packedLen} (:63-64), then fixed packedLen-byte records, unpacking
each to readLen bases with valToNt ("TCAG", :68-69). Output file =
outfile + ".decompress" (:108), default outfile "out". Input is plain
binary (not gzip).
"""

from __future__ import annotations

import getopt
import sys

import numpy as np

from ..utils.timing import StageTimer


def main(argv: list[str]) -> int:
    timer = StageTimer()
    infile, outfile = "-", "out"
    if not argv:
        _usage()
        return 1
    opts, _ = getopt.gnu_getopt(argv, "i:o:c:h?")
    for flag, val in opts:
        if flag == "-i":
            infile = val
        elif flag == "-o":
            outfile = val
        elif flag == "-c":
            pass  # compress level accepted, unused (matches reference)
        elif flag in ("-h", "-?"):
            _usage()
            return 1

    data = (sys.stdin.buffer.read() if infile.startswith("-") or infile == ""
            else open(infile, "rb").read())
    if outfile.startswith("-") or outfile == "":
        out = sys.stdout.buffer
    else:
        out = open(outfile + ".decompress", "wb")
    if len(data) >= 2:
        read_len, packed_len = data[0], data[1]
        payload = np.frombuffer(data, dtype=np.uint8, offset=2)
        n_rec = len(payload) // packed_len if packed_len else 0
        rows = payload[: n_rec * packed_len].reshape(n_rec, packed_len)
        from ..utils.placement import placement

        if placement() == "device" and rows.nbytes >= (8 << 20):
            import jax.numpy as jnp

            from ..ops.twobit import unpack2bit

            bases = np.asarray(unpack2bit(jnp.asarray(rows)))[:, :read_len]
        else:
            from ..ops.twobit_host import unpack2bit_np

            bases = unpack2bit_np(rows)[:, :read_len]
        block = np.concatenate(
            [bases, np.full((n_rec, 1), 0x0A, np.uint8)], axis=1)
        out.write(block.tobytes())
    if out is not sys.stdout.buffer:
        out.close()
    else:
        out.flush()
    timer.log("done read file at %.3f s\n")
    return 0


def _usage() -> None:
    sys.stderr.write(
        "Usage: ngstpu twoBit2seq [-i Infile] [-o OUTFILE] [-c level] [-h]\n")
