#!/usr/bin/env python
"""Bring-up smoke of ngstpu's device path on a GPU.

One process and one card (the default):

- `pipeline` (count + trim + uniq) on its fast path, and again on its
  chunked path (NGSTPU_NO_FASTPATH=1), through the CLI entry point with the
  device placement: a cold run (compiles) and a warm run;
- the same `pipeline` with NGSTPU_LINK=host, whose outputs are the
  reference: every output file of every device run must equal it byte for
  byte;
- `gzfastq_sort -s`, device (cold and warm) against NGSTPU_LINK=host;
- a kernels phase that runs each device op compiled for the card at a real
  width, compares it exactly with its host or numpy reference and prints
  its time beside its byte bound.

The input is one Illumina-lane-sized single-end library, 10,000,000 reads
x 100 bp with 30% duplicates, made by ngstpu.testing.fixtures'
random_fastq_fast from a fixed seed, 2.5M reads per call. Everything is
written under .cache/chip_smoke/ in the checkout.

`--devices 4` runs only the four-card path instead: gzfastq_uniq -m 4 and
gzfastq_sort -s -m 4 on a 40M-read library (4 lanes; the free disk may cut
it, no lower than 20M, and the cut is printed), each output file compared
by size and SHA-256 with the same tool run on one card without -m (one
run's outputs on disk at a time), and dryrun_multichip(4). Each -m run must
compile and run its sharded program (read from the jit cache) and leave a
nonzero peak_bytes_in_use on every card of the mesh.

The script exits non-zero and prints no result when JAX has no GPU, when
the native library did not load, when a device program a phase needs did
not run (read from the jit caches, not from the placement setting), when
any output differs from its reference, or when any phase raises. The last
line of a passing run is {"ok": true, "device": {...}}.

Usage: python chip_smoke.py [--devices 4]
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import pathlib
import shutil
import subprocess
import sys
import time
import traceback

REPO = pathlib.Path(__file__).resolve().parent
WORK = REPO / ".cache" / "chip_smoke"

LANE_READS = 10_000_000
READ_LEN = 100
DUP_FRAC = 0.3
SEED = 20261016
CHUNK_READS = 2_500_000   # reads per random_fastq_fast call
CHUNK_PEAK_BYTES = 8 << 30  # a call's peak RSS at CHUNK_READS (7.6 GB seen)
TRIM_END = 50             # pipeline -e, as bench.py runs it
MULTI_MIN_READS = 20_000_000
# disk the four-card path needs per read: the fixture (~219 B) plus one
# run's gzfastq_uniq outputs (~340 B); runs are compared by digest, so only
# one run's outputs are on disk at a time
MULTI_DISK_PER_READ = 600

# Device-memory bandwidth by jax device_kind (NVIDIA data sheets: H100 SXM
# 3.35 TB/s, H100 PCIe 2.0 TB/s). The byte bounds below divide by it.
PEAK_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
    "NVIDIA H100 PCIe": 2.0e12,
}

PIPELINE_OUTPUTS = (".count.tsv", ".trim.fastq", "_uniq.fq",
                    "_sortKeyUniq.fq")
SORT_OUTPUTS = ("_sort_by_seq.fq",)
UNIQ_OUTPUTS = ("_uniq.fq", "_sortKeyUniq.fq")


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------- fixture

def _fixture_chunk(args: tuple[int, int, int]) -> bytes:
    k, n, seed = args
    from ngstpu.testing.fixtures import random_fastq_fast

    return random_fastq_fast(n, READ_LEN, seed=seed + k,
                             name_prefix=f"lane{k}", dup_frac=DUP_FRAC)


def make_fixture(path: pathlib.Path, n_reads: int,
                 seed: int = SEED) -> pathlib.Path:
    """n_reads x 100 bp SE FASTQ, CHUNK_READS reads per generator call
    (chunk k uses seed + k), chunks made in parallel by spawned processes
    that never import jax, as many as cores and free memory allow. Kept
    across runs; written via a temp name."""
    if path.exists():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    jobs = [(k, min(CHUNK_READS, n_reads - lo), seed)
            for k, lo in enumerate(range(0, n_reads, CHUNK_READS))]
    free = os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    workers = min(len(jobs), os.cpu_count() or 1, free // CHUNK_PEAK_BYTES)
    tmp = path.with_name(path.name + ".part")
    t0 = time.perf_counter()
    with open(tmp, "wb") as f:
        if len(jobs) == 1 or workers <= 1:
            for job in jobs:
                f.write(_fixture_chunk(job))
        else:
            import multiprocessing
            from concurrent.futures import ProcessPoolExecutor

            # a worker that dies raises BrokenProcessPool here (a
            # multiprocessing.Pool would wait for it forever)
            ctx = multiprocessing.get_context("spawn")
            with ProcessPoolExecutor(workers, mp_context=ctx) as pool:
                for data in pool.map(_fixture_chunk, jobs):
                    f.write(data)
    os.replace(tmp, path)
    log(f"fixture {path.name}: {n_reads} reads x {READ_LEN} bp, "
        f"{path.stat().st_size} bytes, made in "
        f"{time.perf_counter() - t0:.3f} s")
    return path


# ---------------------------------------------------------------- helpers

@contextlib.contextmanager
def _env(**kv: str | None):
    """Set (or, with None, unset) environment variables for a block."""
    old = {k: os.environ.get(k) for k in kv}
    try:
        for k, v in kv.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _cli(argv: list[str], **env: str | None) -> float:
    """Run one ngstpu CLI command in this process; returns its wall time."""
    from ngstpu.tools.cli import main as cli_main

    with _env(**env):
        t0 = time.perf_counter()
        rc = cli_main(argv)
        dt = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"ngstpu {' '.join(argv)} exited {rc}")
    return dt


def _same_bytes(a: pathlib.Path, b: pathlib.Path) -> None:
    """Raise unless the two files hold the same bytes."""
    sa, sb = a.stat().st_size, b.stat().st_size
    if sa != sb:
        raise RuntimeError(f"{a.name} has {sa} bytes, {b.name} has {sb}")
    step = 16 << 20
    with open(a, "rb") as fa, open(b, "rb") as fb:
        off = 0
        while True:
            ca, cb = fa.read(step), fb.read(step)
            if ca != cb:
                i = next(j for j in range(min(len(ca), len(cb)))
                         if ca[j] != cb[j])
                raise RuntimeError(f"{a.name} and {b.name} differ at byte "
                                   f"{off + i}")
            if not ca:
                return
            off += len(ca)


def _outputs(prefix: pathlib.Path, suffixes) -> list[pathlib.Path]:
    return [prefix.with_name(prefix.name + s) for s in suffixes]


def _compare_outputs(prefix: pathlib.Path, ref: pathlib.Path, suffixes,
                     what: str) -> None:
    for got, want in zip(_outputs(prefix, suffixes), _outputs(ref, suffixes)):
        _same_bytes(got, want)
    log(f"  {what}: {len(suffixes)} output files byte-identical to "
        f"{ref.name}*")


def _digests(prefix: pathlib.Path, suffixes) -> list[tuple[int, str]]:
    """(size, sha256) of each output file."""
    out = []
    for p in _outputs(prefix, suffixes):
        h = hashlib.sha256()
        with open(p, "rb") as f:
            while chunk := f.read(16 << 20):
                h.update(chunk)
        out.append((p.stat().st_size, h.hexdigest()))
    return out


def _remove(prefix: pathlib.Path, suffixes) -> None:
    for p in _outputs(prefix, suffixes):
        p.unlink(missing_ok=True)


def _peak_bytes(device=None) -> str:
    import jax

    stats = (device or jax.devices()[0]).memory_stats() or {}
    v = stats.get("peak_bytes_in_use")
    return "not reported" if v is None else str(v)


def _mesh_peaks(n_dev: int) -> list[str]:
    """peak_bytes_in_use of each of the first n_dev devices; raises when a
    GPU reports none or zero (a card the mesh never used)."""
    import jax

    devs = jax.devices()[:n_dev]
    peaks = [_peak_bytes(d) for d in devs]
    if jax.default_backend() == "gpu":
        idle = [d.id for d, p in zip(devs, peaks) if not p.isdigit()
                or int(p) == 0]
        if idle:
            raise RuntimeError(f"devices {idle} report no peak_bytes_in_use")
    return peaks


def _programs_run(programs: dict) -> list[str]:
    """Names of the jitted programs that hold a compiled entry."""
    return [name for name, fn in programs.items() if fn._cache_size()]


def _device_phase(label: str, argv, prefix: pathlib.Path,
                  ref: pathlib.Path, suffixes, programs: dict,
                  env: dict) -> None:
    """Cold then warm device run of one CLI command; each must dispatch
    every program in `programs` (checked on the cold run, after clearing
    the jit caches) and match the reference outputs byte for byte."""
    import jax

    jax.clear_caches()
    cold = _cli(argv(prefix), NGSTPU_LINK=None, **env)
    missing = sorted(set(programs) - set(_programs_run(programs)))
    if missing:
        raise RuntimeError(f"{label}: device program(s) {missing} did not "
                           "run")
    _compare_outputs(prefix, ref, suffixes, f"{label} cold")
    _remove(prefix, suffixes)
    warm = _cli(argv(prefix), NGSTPU_LINK=None, **env)
    _compare_outputs(prefix, ref, suffixes, f"{label} warm")
    _remove(prefix, suffixes)
    log(f"phase {label}: device programs {sorted(programs)} ran; "
        f"cold {cold:.3f} s, warm {warm:.3f} s, first-call overhead "
        f"(compile) {cold - warm:.3f} s; peak_bytes_in_use {_peak_bytes()}")


def _host_reference(label: str, argv, ref: pathlib.Path,
                    programs: dict, env: dict | None = None) -> None:
    """NGSTPU_LINK=host run of one CLI command; it must dispatch none of
    `programs`."""
    import jax

    jax.clear_caches()
    dt = _cli(argv(ref), NGSTPU_LINK="host", **(env or {}))
    ran = _programs_run(programs)
    if ran:
        raise RuntimeError(f"{label} host run dispatched device programs "
                           f"{ran}")
    log(f"phase {label} host reference (NGSTPU_LINK=host): {dt:.3f} s")


# ------------------------------------------------------------- main path

def phase_main_path(fixture: pathlib.Path, work: pathlib.Path) -> None:
    """pipeline (fast and chunked path) and gzfastq_sort -s on the device,
    each against its NGSTPU_LINK=host run, outputs byte for byte."""
    from ngstpu.ops import count, sortengine

    work.mkdir(parents=True, exist_ok=True)
    fq = str(fixture)

    def pipeline(prefix):
        return ["pipeline", "-i", fq, "-o", str(prefix), "-s", "0",
                "-e", str(TRIM_END)]

    def sort(prefix):
        return ["gzfastq_sort", "-i", fq, "-s", "-o", str(prefix)]

    fast = {"sort_partition": sortengine.sort_partition}
    chunked = {"qc _accumulate": count._accumulate,
               "dedup_sorted": sortengine.dedup_sorted}
    ref = work / "pipe_host"
    _host_reference("pipeline", pipeline, ref, {**fast, **chunked})
    _device_phase("pipeline fast path", pipeline, work / "pipe_dev", ref,
                  PIPELINE_OUTPUTS, fast, {"NGSTPU_NO_FASTPATH": None})
    _device_phase("pipeline chunked path", pipeline, work / "pipe_chunk",
                  ref, PIPELINE_OUTPUTS, chunked,
                  {"NGSTPU_NO_FASTPATH": "1"})
    _remove(ref, PIPELINE_OUTPUTS)

    programs = {"lex_argsort": sortengine.lex_argsort}
    ref = work / "sort_host"
    _host_reference("gzfastq_sort", sort, ref, programs)
    _device_phase("gzfastq_sort", sort, work / "sort_dev", ref,
                  SORT_OUTPUTS, programs, {"NGSTPU_NO_FASTPATH": None})
    _remove(ref, SORT_OUTPUTS)


# --------------------------------------------------------------- kernels

def _memory(compiled) -> str:
    m = compiled.memory_analysis()
    if m is None:
        return "not reported"
    keys = ("argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "generated_code_size_in_bytes")
    return " ".join(f"{k}={getattr(m, k)}" for k in keys if hasattr(m, k))


def _time_op(name: str, fn, static: dict, args: tuple, bound_bytes: float,
             fresh=None):
    """Compile fn at these shapes, run it, time three warm calls (each
    ended by block_until_ready) and print the time beside the byte bound.
    `fresh` rebuilds donated arguments before each call. Returns the
    first call's outputs as numpy."""
    import jax
    import numpy as np

    t0 = time.perf_counter()
    compiled = fn.lower(*args, **static).compile()
    t_compile = time.perf_counter() - t0
    out = jax.block_until_ready(compiled(*(fresh() if fresh else args)))
    out = jax.tree.map(np.asarray, out)
    times = []
    for _ in range(3):
        a = fresh() if fresh else args
        t0 = time.perf_counter()
        jax.block_until_ready(compiled(*a))
        times.append(time.perf_counter() - t0)
    best = min(times)
    kind = jax.devices()[0].device_kind
    peak = PEAK_BYTES_PER_S.get(kind)
    if peak is None:
        bound = f"no bandwidth entry for {kind!r}"
    else:
        t_bound = bound_bytes / peak
        bound = (f"byte bound {bound_bytes:.0f} B / {peak:.3g} B/s = "
                 f"{t_bound * 1e3:.3f} ms, share {t_bound / best:.4f}")
    shapes = ", ".join(f"{a.dtype}{list(a.shape)}" for a in args)
    log(f"  op {name} ({shapes}): compile {t_compile:.3f} s, warm min "
        f"{best * 1e3:.3f} ms of {[round(t * 1e3, 3) for t in times]} ms; "
        f"{bound}; memory_analysis: {_memory(compiled)}")
    return out


def _exact(name: str, got, want) -> None:
    import numpy as np

    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape:
        raise RuntimeError(f"{name}: shape {got.shape} != reference "
                           f"{want.shape}")
    if got.dtype.kind == "f" and not np.array_equal(got, want):
        gi = got.astype(np.float32).view(np.int32).astype(np.int64)
        wi = want.astype(np.float32).view(np.int32).astype(np.int64)
        ulp = int(np.abs(gi - wi).max())
        raise RuntimeError(f"{name}: float32 results differ by up to {ulp} "
                           f"ulp in {int((gi != wi).sum())} places")
    if not np.array_equal(got, want):
        bad = int((got != want).sum())
        raise RuntimeError(f"{name}: {bad} of {got.size} values differ from "
                           "the reference")


def kernel_sizes(n_reads: int) -> dict:
    """Row counts of the kernels phase for a lane of n_reads reads."""
    return dict(partition=max(n_reads // 4, 1024), dedup=n_reads,
                lex=n_reads, events=1 << max((n_reads * 16 // 10
                                              ).bit_length(), 10),
                twobit=max(n_reads // 4, 1024),
                fastqc=max(n_reads // 10, 1024),
                kmer=max(n_reads // 50, 256))


def _dup_words(rng, rows: int, width: int, hi: int):
    """Random uint32 key rows, 30% of them copies of other rows."""
    import numpy as np

    w = rng.integers(0, hi, (rows, width), dtype=np.uint64).astype(np.uint32)
    dup = rng.random(rows) < DUP_FRAC
    w[dup] = w[rng.integers(0, rows, int(dup.sum()))]
    return w


def phase_kernels(fixture: pathlib.Path, n_reads: int) -> None:
    """Each device op at a real width against its reference, exactly."""
    import jax.numpy as jnp
    import numpy as np

    from ngstpu.io.fastq import FastqChunkReader
    from ngstpu.io.native import get_lib
    from ngstpu.ops import bamops, count, fastqc, sortengine, twobit
    from ngstpu.ops import twobit_host
    from ngstpu.utils.padding import bucket_rows, pad_rows

    lib = get_lib()
    sz = kernel_sizes(n_reads)
    rng = np.random.default_rng(SEED)
    log(f"phase kernels: sizes {sz}")

    # sort_partition: one of the four key-range partitions of the lane,
    # 2-bit keys W = 7 (100 bp), constant length, no padding rows
    B, W = sz["partition"], 7
    words = _dup_words(rng, B, W, 1 << 32)
    lens = np.full(B, READ_LEN, np.int32)
    want_perm, want_head = sortengine._dedup_host(
        words, lens, np.zeros(B, np.uint32), B, False)
    perm, head = _time_op(
        "sort_partition", sortengine.sort_partition,
        dict(length_key=False, maybe_padding=False),
        (jnp.asarray(words), jnp.asarray(lens), jnp.int32(B)),
        bound_bytes=12.0 * B * W + 4.0 * B * W + 5.0 * B)
    _exact("sort_partition perm", perm, want_perm)
    _exact("sort_partition is_head", head, want_head)

    # dedup_sorted: the whole lane's keys with quality sums (chunked path)
    B = sz["dedup"]
    words = _dup_words(rng, B, W, 1 << 32)
    lens = np.full(B, READ_LEN, np.int32)
    sumq = rng.integers(0, 41 * READ_LEN, B).astype(np.uint32)
    want_perm, want_head = sortengine._dedup_host(words, lens, sumq, B, False)
    res = _time_op(
        "dedup_sorted", sortengine.dedup_sorted,
        dict(length_first=False, words_encode_len=False,
             maybe_padding=False),
        (jnp.asarray(words), jnp.asarray(lens), jnp.asarray(sumq),
         jnp.int32(B)),
        bound_bytes=12.0 * B * (W + 2) + 4.0 * B * W + 5.0 * B)
    _exact("dedup_sorted perm", res["perm"], want_perm)
    _exact("dedup_sorted is_head", res["is_head"], want_head)
    del words, sumq, res

    # lex_argsort, length first: gzfastq_sort -s keys (3-bit, W = 10),
    # lengths spread as after adapter trimming; few distinct words, so
    # ties exercise stability
    B, W = sz["lex"], 10
    words = _dup_words(rng, B, W, 1 << 8)
    lens = rng.integers(30, READ_LEN + 1, B).astype(np.int32)
    padded = words.astype(">u4").view(np.uint8).reshape(B, 4 * W)
    want = sortengine.np_lex_argsort(padded, lens, length_first=True)
    got = _time_op("lex_argsort", sortengine.lex_argsort,
                   dict(length_first=True),
                   (jnp.asarray(words), jnp.asarray(lens)),
                   bound_bytes=12.0 * B * (W + 1))
    _exact("lex_argsort perm", got, want)
    del words, padded, want, got

    # QC histogram at the batch shape the chunked path gives this fixture
    chunk = next(iter(FastqChunkReader(str(fixture))))
    rows = bucket_rows(chunk.qual.shape[0])
    qual = pad_rows(chunk.qual, rows)
    lens = pad_rows(chunk.lens.astype(np.int32), rows)
    n = chunk.n
    hq = np.zeros((count.N_CYCLE, count.N_QUAL), np.uint64)
    hl = np.zeros(count.N_CYCLE, np.uint64)
    q = np.ascontiguousarray(chunk.qual[:n])
    lib.ngs_qc_hist(q, np.ascontiguousarray(chunk.lens[:n], np.int32), n,
                    q.shape[1], count.N_QUAL, count.N_CYCLE, hq, hl, 0)
    d_qual, d_lens = jnp.asarray(qual), jnp.asarray(lens)

    def fresh():
        return (jnp.zeros((count.N_CYCLE, count.N_QUAL), jnp.int32),
                jnp.zeros((count.N_CYCLE,), jnp.int32), d_qual, d_lens,
                jnp.int32(n))

    tq, tl = _time_op("qc _accumulate", count._accumulate, {}, fresh(),
                      bound_bytes=float(qual.size), fresh=fresh)
    _exact("qc cycle histogram", tq, hq.astype(np.int32))
    _exact("qc length histogram", tl, hl.astype(np.int32))

    # pileup sweep over 2^24 coverage events (+1 starts, -1 ends)
    E = sz["events"]
    pos = rng.integers(0, 100_000_000, E).astype(np.int32)
    delta = np.where(rng.random(E) < 0.5, 1, -1).astype(np.int32)
    u_pos = np.empty(E, np.int64)
    u_depth = np.empty(E, np.int64)
    k = lib.ngs_pileup_sweep(pos, delta, E, u_pos, u_depth, 0)
    s_pos, cum, is_last = _time_op(
        "sparse_pileup_sweep", bamops.sparse_pileup_sweep, {},
        (jnp.asarray(pos), jnp.asarray(delta), jnp.int32(E)),
        bound_bytes=17.0 * E)
    _exact("pileup positions", s_pos[is_last].astype(np.int64), u_pos[:k])
    _exact("pileup depths", cum[is_last].astype(np.int64), u_depth[:k])

    # 2-bit pack / unpack (fastq2twobit / twoBit2seq)
    B = sz["twobit"]
    seq = np.frombuffer(b"ACGTN", np.uint8)[rng.integers(0, 5, (B, READ_LEN))]
    packed = _time_op("pack2bit", twobit.pack2bit, {}, (jnp.asarray(seq),),
                      bound_bytes=1.25 * seq.size)
    _exact("pack2bit", packed, twobit_host.pack2bit_np(seq))
    unpacked = _time_op("unpack2bit", twobit.unpack2bit, {},
                        (jnp.asarray(packed),), bound_bytes=1.25 * seq.size)
    _exact("unpack2bit", unpacked, twobit_host.unpack2bit_np(packed))

    # fastqc device matrices against the host placement
    B = sz["fastqc"]
    seq = np.frombuffer(b"ACGTN", np.uint8)[rng.integers(0, 5, (B, READ_LEN))]
    qual = rng.integers(33, 75, (B, READ_LEN)).astype(np.uint8)
    lens = rng.integers(30, READ_LEN + 1, B).astype(np.int32)
    col = np.arange(READ_LEN)[None, :] < lens[:, None]
    seq, qual = seq * col, qual * col
    d_seq, d_qual, d_lens = map(jnp.asarray, (seq, qual, lens))
    st = _time_op("fastqc_stats", fastqc.fastqc_stats, {},
                  (d_seq, d_qual, d_lens, jnp.int32(B)),
                  bound_bytes=2.0 * seq.size)
    host = fastqc.fastqc_stats_host(seq, qual, lens, B)
    for key in ("quality", "ntval", "len_hist", "gc_count"):
        _exact(f"fastqc {key}", st[key].astype(np.int64), host[key])
    ad = np.frombuffer(b"".join(a for _, a in fastqc.ADAPTERS),
                       np.uint8).reshape(len(fastqc.ADAPTERS), -1)
    ac = _time_op("adapter_content", fastqc.adapter_content, {},
                  (d_seq, d_lens, jnp.int32(B), jnp.asarray(ad)),
                  bound_bytes=float(seq.size))
    _exact("adapter_content", ac,
           fastqc.adapter_content_host(seq, lens, B, ad))
    tiles = rng.integers(0, 64, B).astype(np.int32)
    sums, cnts = _time_op("per_tile_quality", fastqc.per_tile_quality,
                          dict(n_tiles=64),
                          (d_qual, d_lens, jnp.int32(B), jnp.asarray(tiles)),
                          bound_bytes=float(qual.size))
    h_sums, h_cnts = fastqc.per_tile_quality_host(qual, lens, B, tiles, 64)
    _exact("per_tile_quality sums", sums, h_sums)
    _exact("per_tile_quality counts", cnts, h_cnts)
    K = sz["kmer"]
    kc = _time_op("kmer_position_counts", fastqc.kmer_position_counts, {},
                  (d_seq[:K], d_lens[:K], jnp.int32(K)),
                  bound_bytes=float(K * READ_LEN))
    _exact("kmer_position_counts", kc,
           fastqc.kmer_position_counts_host(seq[:K], lens[:K], K))
    log(f"phase kernels: every op equals its reference; peak_bytes_in_use "
        f"{_peak_bytes()}")


# ------------------------------------------------------------- four cards

def phase_multi(fixture: pathlib.Path, work: pathlib.Path,
                n_dev: int) -> None:
    """gzfastq_uniq -m and gzfastq_sort -s -m against one card (every
    output file's size and sha256 equal; the sharded program compiled and
    ran, every card of the mesh held data), then dryrun_multichip(n_dev)."""
    import importlib.util

    import jax

    from ngstpu.parallel import dsort

    work.mkdir(parents=True, exist_ok=True)
    fq = str(fixture)
    for tool, argv, suffixes, program in (
            ("gzfastq_uniq", lambda p, m: ["gzfastq_uniq", "-1", fq, "-o",
                                           str(p)] + m, UNIQ_OUTPUTS,
             {"exchange_dedup": dsort.exchange_dedup}),
            ("gzfastq_sort", lambda p, m: ["gzfastq_sort", "-i", fq, "-s",
                                           "-o", str(p)] + m, SORT_OUTPUTS,
             {"sample_sort": dsort.sample_sort})):
        one, mesh = work / f"{tool}_one", work / f"{tool}_mesh"
        t1 = _cli(argv(one, []), NGSTPU_LINK=None)
        want = _digests(one, suffixes)
        _remove(one, suffixes)
        jax.clear_caches()
        tm = _cli(argv(mesh, ["-m", str(n_dev)]), NGSTPU_LINK=None)
        if not _programs_run(program):
            raise RuntimeError(f"{tool} -m {n_dev}: sharded program "
                               f"{list(program)} did not run")
        peaks = _mesh_peaks(n_dev)
        got = _digests(mesh, suffixes)
        _remove(mesh, suffixes)
        if got != want:
            raise RuntimeError(f"{tool} -m {n_dev} outputs {got} differ "
                               f"from one card's {want}")
        log(f"phase {tool} -m {n_dev}: sharded program {list(program)} "
            f"ran; {len(suffixes)} output files equal to one card's (size, "
            f"sha256) {want}; one card {t1:.3f} s, {n_dev} cards {tm:.3f} s; "
            f"peak_bytes_in_use per device {peaks}")
    spec = importlib.util.spec_from_file_location(
        "graft_entry", REPO / "__graft_entry__.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    t0 = time.perf_counter()
    mod.dryrun_multichip(n_dev)
    log(f"phase dryrun_multichip({n_dev}): ok in "
        f"{time.perf_counter() - t0:.3f} s")


# ------------------------------------------------------------------ main

def _card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0 or not r.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip()


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, default=1, choices=(1, 4),
                    help="4 runs only the four-card path")
    args = ap.parse_args(argv)

    sys.path.insert(0, str(REPO))
    import ngstpu

    if pathlib.Path(ngstpu.__file__).resolve().parent.parent != REPO:
        print(f"chip_smoke: ngstpu imported from {ngstpu.__file__}, not "
              "from this checkout", file=sys.stderr)
        return 1
    from ngstpu.utils.jaxsetup import compile_cache_dir, setup_jax_cache

    setup_jax_cache()
    import jax

    if jax.default_backend() != "gpu":
        print(f"chip_smoke: JAX backend is {jax.default_backend()!r}, not "
              "'gpu'", file=sys.stderr)
        return 1
    if len(jax.devices()) < args.devices:
        print(f"chip_smoke: needs {args.devices} GPUs, JAX sees "
              f"{len(jax.devices())}", file=sys.stderr)
        return 1
    from ngstpu.io.native import _SO, get_lib

    if get_lib() is None:
        print("chip_smoke: the native library did not load", file=sys.stderr)
        return 1
    # keep every buffer inside the process (no /dev/shm pool files)
    os.environ["NGSTPU_SHM_POOL"] = "0"
    for k in ("NGSTPU_LINK", "NGSTPU_NO_FASTPATH", "NGSTPU_MESH"):
        os.environ.pop(k, None)

    log(f"card: {_card_line()}")
    log(f"jax {jax.__version__}; backend {jax.default_backend()}; devices "
        f"{[d.device_kind for d in jax.devices()]}; native library loaded "
        f"from {_SO}; compile cache {compile_cache_dir()}")

    lanes = 4 if args.devices == 4 else 1
    n_reads = lanes * LANE_READS
    WORK.mkdir(parents=True, exist_ok=True)
    free = shutil.disk_usage(WORK).free
    log(f"disk: {free} bytes free under {WORK}")
    if args.devices == 4:
        fit = ((free - (4 << 30)) // MULTI_DISK_PER_READ
               // CHUNK_READS * CHUNK_READS)
        n_reads = min(n_reads, fit)
        if n_reads < MULTI_MIN_READS:
            print(f"chip_smoke: --devices 4 needs at least "
                  f"{MULTI_MIN_READS} reads (disk fits {fit})",
                  file=sys.stderr)
            return 1
        if n_reads < lanes * LANE_READS:
            log(f"four-card library cut from {lanes * LANE_READS} to "
                f"{n_reads} reads to fit the free disk")
    failed: list[str] = []

    def run(name, fn, *a):
        t0 = time.perf_counter()
        try:
            fn(*a)
            log(f"phase {name}: ok in {time.perf_counter() - t0:.3f} s")
        except Exception:  # noqa: BLE001 - every phase reports; exit is 1
            traceback.print_exc()
            log(f"phase {name}: FAILED after {time.perf_counter() - t0:.3f} s")
            failed.append(name)

    fixture = WORK / f"se_{n_reads}x{READ_LEN}_seed{SEED}.fq"
    run("fixture", make_fixture, fixture, n_reads)
    if not fixture.exists():
        log("no fixture: nothing else can run")
        return 1
    if args.devices == 4:
        run("multi-card", phase_multi, fixture, WORK / "multi",
            args.devices)
    else:
        run("main path", phase_main_path, fixture, WORK / "main")
        run("kernels", phase_kernels, fixture, n_reads)
    if failed:
        log(f"chip_smoke: FAILED phases: {failed}")
        return 1
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
