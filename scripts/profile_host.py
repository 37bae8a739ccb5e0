#!/usr/bin/env python
"""Fine-grained profile of the composite HOST placement path (dev tool).

Under NGSTPU_LINK=host (the placement bench.py gives its CLI children)
the dedup sort runs in native C++ (ngs_dedup_sort_host). This mirrors
tools/pipeline.run_fast's host path stage by stage with inline timers.
"""
from __future__ import annotations

import ctypes
import os
import pathlib
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import numpy as np

N_READS = int(os.environ.get("NGSTPU_BENCH_READS", 1 << 21))
READ_LEN = 100
TRIM_END = 50


def fixture() -> pathlib.Path:
    d = REPO / ".cache" / "bench"
    d.mkdir(parents=True, exist_ok=True)
    p = d / f"comp_{N_READS}x{READ_LEN}.fq"
    if not p.exists():
        from ngstpu.testing.fixtures import random_fastq_fast
        p.write_bytes(random_fastq_fast(N_READS, READ_LEN, seed=123,
                                        dup_frac=0.3))
    return p


def profile_once(path, prefix):
    from ngstpu.io.fastindex import (fused_stats, index_fastq, trim_text,
                                     uniq_text)
    from ngstpu.io.native import get_lib
    from ngstpu.ops.sortengine import rep_counts_host
    from ngstpu.tools.pipeline import (_CloningSink, _RingWriter,
                                       CHUNK_RECORDS)
    from ngstpu.utils.bufpool import get_buffer, get_matrix

    lib = get_lib()
    T = {}
    t_all = time.monotonic()

    t0 = time.monotonic()
    ix = index_fastq(str(path))
    T["index"] = time.monotonic() - t0

    t_setup = time.monotonic()
    B = ix.n
    lmax = int(ix.seq_len.max())
    W = max(1, -(-lmax // 16))
    words_all = get_matrix("pipe.words", B, W, np.uint32)
    sumq_all = get_buffer("pipe.sumq", 4 * B, np.uint32)
    hist_q = np.zeros((512, 128), np.uint64)
    hist_len = np.zeros(512, np.uint64)
    bucket = np.zeros(256, np.uint32)

    start, end = 0, TRIM_END
    cl = np.clip(np.minimum(ix.seq_len.astype(np.int64), end) - start, 0,
                 None)
    trim_rec = ix.name_len.astype(np.int64) + 1 + cl + 3 + cl + 1
    chunk_trim_cap = 1
    for lo in range(0, B, CHUNK_RECORDS):
        chunk_trim_cap = max(chunk_trim_cap,
                             int(trim_rec[lo:lo + CHUNK_RECORDS].sum()))

    T["setup"] = time.monotonic() - t_setup
    t_fused = t_trim = t_submit = 0.0
    if True:
        t0 = time.monotonic()
        tf = open(prefix + ".trim.fastq", "wb")
        T["trim_open"] = time.monotonic() - t0
        writer = _RingWriter(tf, ["pipe.trim0", "pipe.trim1", "pipe.trim2"])
        try:
            for lo in range(0, B, CHUNK_RECORDS):
                hi = min(lo + CHUNK_RECORDS, B)
                t0 = time.monotonic()
                ok = fused_stats(ix, lo, hi, W, words_all[lo:hi],
                                 sumq_all[lo:hi], hist_q, hist_len, bucket)
                t_fused += time.monotonic() - t0
                t0 = time.monotonic()
                name = writer.acquire()
                buf = get_buffer(name, chunk_trim_cap)
                total = trim_text(ix, lo, hi, start, end, buf)
                t_trim += time.monotonic() - t0
                t0 = time.monotonic()
                writer.submit(name, buf, total)
                t_submit += time.monotonic() - t0
        except BaseException:
            writer.close()
            raise
    trim_writer_close = writer.close
    T["fused_stats"] = t_fused
    T["trim_fmt"] = t_trim
    T["trim_submit"] = t_submit

    from ngstpu.ops.count import QCAccumulator
    from ngstpu.tools.fastq_count import _row
    t0 = time.monotonic()
    acc = QCAccumulator.from_host_partials(hist_q, hist_len)
    with open(prefix + ".count.tsv", "w") as out:
        out.write(_row(str(path), acc))
    T["count_row"] = time.monotonic() - t0


    const_len = int(ix.seq_len.min()) == lmax
    # host placement, mirrors _sort_host (fused native sort+groups)
    t0 = time.monotonic()
    perm = get_buffer("pipe.perm", 4 * B, np.int32)[:B]
    rep_all = get_buffer("pipe.rep", 8 * B, np.int64)[:B]
    cnt_all = get_buffer("pipe.cnt", 8 * B, np.int64)[:B]
    lens = np.ascontiguousarray(ix.seq_len, np.int32)
    G = lib.ngs_dedup_groups_host(
        words_all, lens.ctypes.data_as(ctypes.c_void_p), sumq_all,
        0 if const_len else 1, B, words_all.shape[1], perm, rep_all,
        cnt_all, 0)
    T["host_sortgroups"] = time.monotonic() - t0

    t_fmt = t_sub = 0.0
    uniq_path = prefix + "_uniq.fq"
    n_groups = G
    step = 1 << 19
    t0 = time.monotonic()
    uf = open(uniq_path, "wb", buffering=0)
    cf = open(prefix + "_sortKeyUniq.fq", "wb", buffering=0)
    T["uniq_open"] = time.monotonic() - t0
    with uf, cf:
        writer = _RingWriter(_CloningSink(uf, cf), ["pipe.emit0",
                                                    "pipe.emit1"])
        try:
            for lo in range(0, G, step):
                hi2 = min(lo + step, G)
                rep = rep_all[lo:hi2]
                cnt = cnt_all[lo:hi2]
                t0 = time.monotonic()
                name = writer.acquire()
                view, total = uniq_text(ix, rep, cnt, name)
                t_fmt += time.monotonic() - t0
                t0 = time.monotonic()
                writer.submit(name, view, total)
                t_sub += time.monotonic() - t0
        finally:
            t0 = time.monotonic()
            writer.close()
            T["emit_close"] = time.monotonic() - t0
    t0 = time.monotonic()
    trim_writer_close()
    T["trimdrain_tail"] = time.monotonic() - t0
    T["emit_fmt"] = t_fmt
    T["emit_submit"] = t_sub

    T["TOTAL"] = time.monotonic() - t_all
    T["n_groups"] = n_groups
    return T


def main():
    path = fixture()
    work = REPO / ".cache" / "bench" / "work"
    work.mkdir(parents=True, exist_ok=True)
    prefix = str(work / "prof")
    for r in range(int(os.environ.get("ROUNDS", "4"))):
        T = profile_once(path, prefix)
        print(f"--- round {r} total={T.pop('TOTAL'):.3f}s "
              f"groups={T.pop('n_groups')}")
        for k, v in T.items():
            if v >= 0.005:
                print(f"  {k:18s} {v:7.3f}s")


if __name__ == "__main__":
    main()
