"""Per-stage profile of the event-mode bam2depth pipeline.

Runs each stage of the production path in isolation over a BAM fixture and
records wall + process-CPU seconds (process_time counts every thread, so a
native parallel stage reports its full core-seconds). It shows the
inflate floor: on an N-core host, wall-clock cannot beat (total
core-seconds)/N, and inflate_1t is the irreducible per-core cost of BGZF
decode (libdeflate raw-DEFLATE).

The reference pays the same decode through zlib inside libbam
(reference bam2depth.c:308 samopen + bgzf reads), single-threaded.
"""

from __future__ import annotations

import ctypes
import time

import numpy as np


def _timed(fn):
    w0, c0 = time.monotonic(), time.process_time()
    out = fn()
    return out, time.monotonic() - w0, time.process_time() - c0


def profile_stages(path: str, flag_mask: int = 0x704,
                   window: int = 20000) -> dict:
    """Stage-isolated profile: returns {"stages": {name: {"wall_s",
    "cpu_s"}}, counts...}. Requires the native library."""
    from ..io.bgzf import _scan_blocks_ex
    from ..io.native import get_lib
    from ..io.bam import parse_header
    from ..ops.bamops import pileup_emit_runs

    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    res: dict = {"path": path, "stages": {}}

    def stage(name, fn, **counts):
        out, w, c = _timed(fn)
        res["stages"][name] = {"wall_s": round(w, 3), "cpu_s": round(c, 3),
                               **counts}
        return out

    with open(path, "rb") as f:
        data = f.read()
    res["compressed_bytes"] = len(data)

    (starts, lens, isizes, _), w, c = _timed(lambda: _scan_blocks_ex(data))
    res["stages"]["bgzf_scan"] = {"wall_s": round(w, 3),
                                  "cpu_s": round(c, 3),
                                  "blocks": len(starts)}
    starts = np.ascontiguousarray(starts)
    lens = np.ascontiguousarray(lens)
    isizes = np.ascontiguousarray(isizes)
    total = int(isizes.sum())
    res["inflated_bytes"] = total
    out = np.empty(total, np.uint8)
    out[::4096] = 0  # pre-fault: page faults are allocator, not decode
    offs = np.zeros(len(starts), np.int64)
    np.cumsum(isizes[:-1], out=offs[1:])
    sizes = np.empty(len(starts), np.int64)
    arr = np.frombuffer(data, np.uint8)

    def inflate(nt):
        rc = lib.ngs_bgzf_inflate_blocks(arr, starts, lens, len(starts),
                                         out, offs, isizes, sizes, 0, nt)
        assert rc == 0 and (sizes == isizes).all()

    stage("inflate_parallel", lambda: inflate(0))
    # per-core floor number: min of 2 draws (single draws can land on a
    # VM throughput trough)
    best_w = best_c = float("inf")
    for _ in range(2):
        _, w, c = _timed(lambda: inflate(1))
        best_w, best_c = min(best_w, w), min(best_c, c)
    res["stages"]["inflate_1core"] = {"wall_s": round(best_w, 3),
                                      "cpu_s": round(best_c, 3)}

    header, body_off = parse_header(bytes(out[:1 << 16].tobytes()))
    body = np.ascontiguousarray(out[body_off:])
    n_refs = header.n_refs

    # event extraction (production single walk, ngs_bam_m_events)
    cap = max(1 << 20, len(body) // 4)
    tid_b = np.empty(cap, np.int32)
    st_b = np.empty(cap, np.int32)
    en_b = np.empty(cap, np.int32)
    for a in (tid_b, st_b, en_b):
        a[::1024] = 0  # pre-fault: page faults are allocator, not extract
    n_ev = ctypes.c_int64()
    cons = ctypes.c_int64()
    mono = np.array([1, -1], np.int32)

    def extract():
        rc = lib.ngs_bam_m_events(body, len(body), n_refs, flag_mask,
                                  tid_b, st_b, en_b, cap,
                                  ctypes.byref(n_ev), ctypes.byref(cons),
                                  mono)
        assert rc == 0
    stage("event_extract", extract)
    E = int(n_ev.value)
    res["events"] = E

    tids, ss, se = tid_b[:E], st_b[:E], en_b[:E]
    bounds = np.searchsorted(tids, np.arange(n_refs + 1))

    # fused sweep+intervals+format+bins (production ngs_pileup_emit_se)
    def emit():
        nb = 0
        for t in range(n_refs):
            lo, hi = int(bounds[t]), int(bounds[t + 1])
            if lo >= hi:
                continue
            ns = hi - lo
            pos = np.concatenate([ss[lo:hi], se[lo:hi]])
            delta = np.concatenate([np.ones(ns, np.int32),
                                    -np.ones(ns, np.int32)])
            nw = header.ref_lens[t] // window + 1
            rows, _bins = pileup_emit_runs(
                pos, delta, header.ref_names[t].encode(), window, nw)
            nb += len(rows)
        return nb
    nb = stage("fused_sweep_emit", emit)
    res["bedgraph_bytes"] = nb

    res["core_seconds_total"] = round(
        sum(res["stages"][k]["cpu_s"]
            for k in ("bgzf_scan", "inflate_parallel", "event_extract",
                      "fused_sweep_emit")), 3)
    res["inflate_core_seconds"] = res["stages"]["inflate_1core"]["cpu_s"]
    return res
