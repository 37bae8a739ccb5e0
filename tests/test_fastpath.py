"""Fast-path (offset-indexed) pipeline vs the generic chunked path.

The fast path (io/fastindex.py + tools/pipeline.run_fast) must produce
byte-identical outputs to the generic path on every input class it accepts,
and fall back cleanly on the ones it does not (gzip, wide alphabets,
missing trailing newline).
"""

import gzip
import os

import numpy as np
import pytest

from ngstpu.testing.fixtures import random_fastq
from ngstpu.tools.pipeline import run


def _outputs(prefix):
    return {s: open(prefix + s, "rb").read()
            for s in (".count.tsv", ".trim.fastq", "_uniq.fq",
                      "_sortKeyUniq.fq")}


def _run_both(tmp_path, data: bytes, start=0, end=50):
    p = tmp_path / "in.fq"
    p.write_bytes(data)
    run(str(p), str(tmp_path / "fast"), start, end)
    os.environ["NGSTPU_NO_FASTPATH"] = "1"
    try:
        run(str(p), str(tmp_path / "gen"), start, end)
    finally:
        del os.environ["NGSTPU_NO_FASTPATH"]
    fast, gen = _outputs(str(tmp_path / "fast")), _outputs(str(tmp_path / "gen"))
    for k in gen:
        if k == ".count.tsv":  # first column is the input path echo
            assert fast[k].split(b"\t")[1:] == gen[k].split(b"\t")[1:], k
        else:
            assert fast[k] == gen[k], k
    return fast


def test_fastpath_matches_generic_acgt(tmp_path):
    _run_both(tmp_path, random_fastq(3000, read_len=100, seed=11,
                                     dup_frac=0.5))


def test_fastpath_matches_generic_varlen(tmp_path):
    recs = []
    rng = np.random.default_rng(7)
    for i in range(800):
        L = int(rng.integers(20, 90))
        seq = bytes(rng.choice(list(b"ACGT"), L).astype(np.uint8))
        qual = bytes(rng.integers(33, 74, L).astype(np.uint8))
        recs.append(b"@r%d x\n%s\n+\n%s\n" % (i, seq, qual))
    # force duplicates with differing quality sums (rep selection)
    recs = recs + recs[:200][::-1]
    _run_both(tmp_path, b"".join(recs), start=5, end=40)


def test_fastpath_falls_back_on_n_bases(tmp_path):
    data = random_fastq(500, read_len=60, seed=3, dup_frac=0.3)
    # inject an N into one sequence line
    lines = data.split(b"\n")
    lines[5] = lines[5][:10] + b"N" + lines[5][11:]
    _run_both(tmp_path, b"\n".join(lines))


def test_fastpath_gzip_applies(tmp_path):
    """gzip inputs now take the fast path (inflate + same index); the
    pipeline must still produce correct counts from .gz."""
    raw = random_fastq(300, read_len=50, seed=5, dup_frac=0.2)
    p = tmp_path / "in.fq.gz"
    p.write_bytes(gzip.compress(raw))
    from ngstpu.io.fastindex import index_fastq

    ix = index_fastq(str(p), pool="t.skip")
    assert ix is not None and ix.n == 300
    info = run(str(p), str(tmp_path / "gz"), 0, 30)
    assert info["n"] == 300


def test_fastpath_skips_missing_trailing_newline(tmp_path):
    raw = random_fastq(100, read_len=40, seed=9, dup_frac=0.0)
    p = tmp_path / "no_nl.fq"
    p.write_bytes(raw[:-1])
    from ngstpu.io.fastindex import index_fastq

    assert index_fastq(str(p)) is None


def test_fastpath_bad_line_count(tmp_path):
    p = tmp_path / "bad.fq"
    p.write_bytes(b"@r1\nACGT\n+\n")
    from ngstpu.io.fastindex import index_fastq

    with pytest.raises(ValueError):
        index_fastq(str(p))


def test_fastpath_host_sort_placement(tmp_path, monkeypatch):
    """NGSTPU_LINK=host routes the dedup sort to the native host engine;
    outputs must stay byte-identical to the device placement."""
    data = random_fastq(2500, read_len=80, seed=21, dup_frac=0.5)
    p = tmp_path / "in.fq"
    p.write_bytes(data)
    run(str(p), str(tmp_path / "dev"), 0, 40)
    monkeypatch.setenv("NGSTPU_LINK", "host")
    run(str(p), str(tmp_path / "host"), 0, 40)
    for s in (".trim.fastq", "_uniq.fq", "_sortKeyUniq.fq"):
        assert (tmp_path / ("dev" + s)).read_bytes() == \
            (tmp_path / ("host" + s)).read_bytes(), s


def test_host_sort_varlen_matches_numpy():
    """ngs_dedup_sort_host vs np.lexsort oracle, ragged lengths."""
    import pytest as _pytest

    from ngstpu.io.native import get_lib

    lib = get_lib()
    if lib is None:
        _pytest.skip("no native lib")
    import ctypes

    rng = np.random.default_rng(4)
    B, W = 5000, 3
    words = rng.integers(0, 1 << 8, (B, W)).astype(np.uint32)  # many dups
    lens = rng.integers(0, 50, B).astype(np.int32)
    perm = np.empty(B, np.int32)
    is_head = np.empty(B, np.uint8)
    lib.ngs_dedup_sort_host(np.ascontiguousarray(words),
                            lens.ctypes.data_as(ctypes.c_void_p), 1,
                            B, W, perm, is_head, 0)
    keys = [np.arange(B), lens] + [words[:, w] for w in range(W - 1, -1, -1)]
    expect = np.lexsort(tuple(keys))
    assert (perm == expect).all()
    sw, sl = words[perm], lens[perm]
    same = (sw[1:] == sw[:-1]).all(axis=1) & (sl[1:] == sl[:-1])
    assert (is_head.view(bool) == np.concatenate([[True], ~same])).all()


def test_rep_counts_host_strict_replacement():
    """Representative = earliest row with the max quality sum (the strict->
    replacement of reference gzfastq_uniq.c:226)."""
    from ngstpu.ops.sortengine import rep_counts_host

    # one group of 4 rows (already 'sorted'), sumq peaks twice
    perm = np.array([2, 0, 1, 3], np.int32)  # original indices, ascending? no
    perm = np.array([0, 1, 2, 3], np.int32)
    is_head = np.array([True, False, False, False])
    sumq = np.array([5, 9, 9, 3], np.uint32)
    rep, counts = rep_counts_host(perm, is_head, 4, sumq)
    assert counts.tolist() == [4]
    assert rep.tolist() == [1]  # first of the two max-sumq rows


def test_dedup_groups_host_matches_rep_counts():
    """ngs_dedup_groups_host (fused sort+group extraction) vs the
    ngs_dedup_sort_host + rep_counts_host composition."""
    import ctypes

    from ngstpu.io.native import get_lib
    from ngstpu.ops.sortengine import rep_counts_host

    lib = get_lib()
    if lib is None:
        pytest.skip("no native lib")
    rng = np.random.default_rng(9)
    for use_len in (0, 1):
        B, W = 4000, 3
        words = np.ascontiguousarray(
            rng.integers(0, 1 << 7, (B, W)).astype(np.uint32))
        lens = rng.integers(10, 14, B).astype(np.int32)
        sumq = rng.integers(0, 500, B).astype(np.uint32)
        perm = np.empty(B, np.int32)
        is_head = np.empty(B, np.uint8)
        lib.ngs_dedup_sort_host(words,
                                lens.ctypes.data_as(ctypes.c_void_p),
                                use_len, B, W, perm, is_head, 0)
        exp_rep, exp_cnt = rep_counts_host(perm, is_head.view(bool), B, sumq)
        perm2 = np.empty(B, np.int32)
        rep = np.empty(B, np.int64)
        counts = np.empty(B, np.int64)
        g = lib.ngs_dedup_groups_host(
            words, lens.ctypes.data_as(ctypes.c_void_p), sumq, use_len,
            B, W, perm2, rep, counts, 0)
        assert g == len(exp_rep)
        np.testing.assert_array_equal(rep[:g], exp_rep)
        np.testing.assert_array_equal(counts[:g], exp_cnt)


def test_uniq_pe_fast_path_matches_generic(tmp_path, monkeypatch):
    """PE dedup through the offset-indexed fast path: (a) the fast path is
    actually taken on plain ACGT files, (b) outputs are byte-identical to
    the generic padded-batch path."""
    from ngstpu.testing.fixtures import random_fastq_pair
    from ngstpu.tools import gzfastq_uniq as gu
    from ngstpu.utils.timing import StageTimer

    r1, r2 = random_fastq_pair(400, read_len=60, seed=77)

    def dup(data, k):
        recs = data.split(b"\n")
        recs = [b"\n".join(recs[i:i + 4]) for i in range(0, len(recs) - 1, 4)]
        return b"\n".join(recs + recs[:k]) + b"\n"

    p1, p2 = tmp_path / "r1.fq", tmp_path / "r2.fq"
    p1.write_bytes(dup(r1, 150))
    p2.write_bytes(dup(r2, 150))
    taken = gu._run_pe_fast(str(p1), str(p2), str(tmp_path / "fast"),
                            StageTimer())
    assert taken, "PE fast path must apply to plain ACGT files"
    monkeypatch.setenv("NGSTPU_NO_FASTPATH", "1")
    gu.run_pe(str(p1), str(p2), str(tmp_path / "gen"), StageTimer())
    for mate in ("_1_uniq.fq", "_2_uniq.fq"):
        assert (tmp_path / ("fast" + mate)).read_bytes() == \
            (tmp_path / ("gen" + mate)).read_bytes(), mate


def test_uniq_pe_fast_rep_selection(tmp_path):
    """PE representative = first occurrence achieving the max total quality
    sum across BOTH mates (reference gzfastq_uniq.c:215-229)."""
    from ngstpu.tools import gzfastq_uniq as gu
    from ngstpu.utils.timing import StageTimer

    def rec(name, seq, qual):
        return f"@{name}\n{seq}\n+\n{qual}\n".encode()

    seq = "ACGTACGT"
    # pair key identical across 3 occurrences; occ2 has the best total sumQ
    p1 = (rec("a 1", seq, "IIIIIIII") + rec("b 1", seq, "JJJJJJJJ")
          + rec("c 1", seq, "JJJJJJJJ"))
    p2 = (rec("a 2", "TTTTAAAA", "IIIIIIII") + rec("b 2", "TTTTAAAA",
                                                   "JJJJJJJJ")
          + rec("c 2", "TTTTAAAA", "IIIIIIII"))
    f1, f2 = tmp_path / "m1.fq", tmp_path / "m2.fq"
    f1.write_bytes(p1)
    f2.write_bytes(p2)
    taken = gu._run_pe_fast(str(f1), str(f2), str(tmp_path / "o"),
                            StageTimer())
    assert taken
    u1 = (tmp_path / "o_1_uniq.fq").read_bytes()
    u2 = (tmp_path / "o_2_uniq.fq").read_bytes()
    assert u1 == b"@b 1\t3\nACGTACGT\n+\nJJJJJJJJ\n"
    assert u2 == b"@b 2\t3\nTTTTAAAA\n+\nJJJJJJJJ\n"


def test_index_fastq_gz_input(tmp_path):
    """gzip inputs take the offset-indexed fast path (transparent gzdopen
    of reference IO_stream.h:122-136): the index over the inflated bytes
    must equal the plain-file index, and the composite pipeline must
    produce byte-identical outputs from .fq and .fq.gz."""
    from ngstpu.io.fastindex import index_fastq

    data = random_fastq(1200, read_len=70, seed=33, dup_frac=0.4)
    p = tmp_path / "in.fq"
    pz = tmp_path / "in.fq.gz"
    p.write_bytes(data)
    pz.write_bytes(gzip.compress(data, mtime=0))
    ix = index_fastq(str(p))
    ixz = index_fastq(str(pz), pool="t.gz")
    assert ixz is not None, "gz input must take the fast path"
    assert ix.n == ixz.n
    np.testing.assert_array_equal(ix.seq_len, ixz.seq_len)
    np.testing.assert_array_equal(
        ix.data[ix.seq_off[5]:ix.seq_off[5] + ix.seq_len[5]],
        ixz.data[ixz.seq_off[5]:ixz.seq_off[5] + ixz.seq_len[5]])

    run(str(p), str(tmp_path / "plain"), 0, 40)
    run(str(pz), str(tmp_path / "gz"), 0, 40)
    for s in (".trim.fastq", "_uniq.fq", "_sortKeyUniq.fq"):
        assert (tmp_path / ("plain" + s)).read_bytes() == \
            (tmp_path / ("gz" + s)).read_bytes(), s


def test_index_fastq_gz_multimember_and_corrupt(tmp_path):
    """Concatenated gzip members inflate as one logical stream; corrupt
    gzip returns None (generic path surfaces the error)."""
    from ngstpu.io.fastindex import index_fastq

    d1 = random_fastq(300, read_len=50, seed=1)
    d2 = random_fastq(200, read_len=50, seed=2)
    pz = tmp_path / "mm.fq.gz"
    pz.write_bytes(gzip.compress(d1, mtime=0) + gzip.compress(d2, mtime=0))
    ix = index_fastq(str(pz), pool="t.mm")
    assert ix is not None and ix.n == 500

    bad = bytearray(gzip.compress(d1, mtime=0))
    bad[len(bad) // 2] ^= 0xFF
    pbad = tmp_path / "bad.fq.gz"
    pbad.write_bytes(bytes(bad))
    assert index_fastq(str(pbad), pool="t.bad") is None


def test_gz_inflate_size_gate_routes_to_generic(tmp_path, monkeypatch):
    """A .gz whose estimated inflated size exceeds NGSTPU_GZ_INFLATE_MAX
    must NOT take the whole-file-inflate fast path (index_fastq returns
    None); the tool still produces byte-identical output through the
    chunked generic reader (round-3 verdict item 4: bounded .gz memory)."""
    from ngstpu.io.fastindex import index_fastq

    data = random_fastq(800, read_len=60, seed=44, dup_frac=0.3)
    p = tmp_path / "big.fq"
    pz = tmp_path / "big.fq.gz"
    p.write_bytes(data)
    pz.write_bytes(gzip.compress(data, mtime=0))

    monkeypatch.setenv("NGSTPU_GZ_INFLATE_MAX", "1024")  # ~everything over
    assert index_fastq(str(pz), pool="t.gate") is None, \
        "oversized .gz must route to the generic path"
    # plain files are unaffected by the gate
    assert index_fastq(str(p)) is not None

    run(str(pz), str(tmp_path / "gated"), 0, 40)
    monkeypatch.delenv("NGSTPU_GZ_INFLATE_MAX")
    run(str(p), str(tmp_path / "plain"), 0, 40)
    for s in (".trim.fastq", "_uniq.fq", "_sortKeyUniq.fq"):
        assert (tmp_path / ("gated" + s)).read_bytes() == \
            (tmp_path / ("plain" + s)).read_bytes(), s


def test_gz_multimember_parallel_inflate(tmp_path):
    """A pigz-style multi-member .gz decodes member-parallel (boundaries
    from the magic scan, sizes from the ISIZE trailers) with output
    identical to the sequential walk; a payload that happens to CONTAIN
    the gzip magic (level-0 stored block) must either be handled by the
    false-boundary pruning (round 5) or fall back to the sequential
    path — output identical either way."""
    import zlib

    import numpy as np

    from ngstpu.io.fastindex import (_inflate_gz_members_parallel,
                                     index_fastq)
    from ngstpu.io.native import get_lib

    lib = get_lib()
    if lib is None:
        pytest.skip("native library unavailable")

    parts = [random_fastq(400, read_len=60, seed=100 + i, dup_frac=0.2)
             for i in range(5)]
    pz = tmp_path / "mm.fq.gz"
    pz.write_bytes(b"".join(gzip.compress(p, mtime=0) for p in parts))
    raw = np.fromfile(pz, np.uint8)
    out = _inflate_gz_members_parallel(lib, raw, "t.par")
    assert out is not None, "multi-member file must take the parallel path"
    assert out.tobytes() == b"".join(parts)
    ix = index_fastq(str(pz), pool="t.par2")
    assert ix is not None and ix.n == 2000

    # false candidate: a stored (level-0) member whose payload embeds the
    # gzip magic — round 5's pruning removes the false boundary (an
    # implausible mid-stream "ISIZE"), so the parallel path now decodes
    # this correctly; if a pathological layout ever defeats pruning the
    # self-validating decode returns None and the sequential walk covers
    # it — either way the bytes must be exact
    name_trap = b"@r\x1f\x8b\x08\x00trap\nACGT\n+\n!!!!\n"
    co = zlib.compressobj(0, zlib.DEFLATED, 16 + 15)
    trap = co.compress(name_trap) + co.flush()
    pz2 = tmp_path / "trap.fq.gz"
    pz2.write_bytes(gzip.compress(parts[0], mtime=0) + trap)
    raw2 = np.fromfile(pz2, np.uint8)
    out2 = _inflate_gz_members_parallel(lib, raw2, "t.trap")
    if out2 is not None:
        assert out2.tobytes() == parts[0] + name_trap
    ix2 = index_fastq(str(pz2), pool="t.trap2")
    assert ix2 is not None and ix2.n == 401


def test_host_radix_sort_adversarial():
    """Radix upgrade stress (round-5): deep shared prefixes force the
    per-word recursion through all W words; lens > 255 exercise the
    clamped length bucket of ngs_sort_perm_host where comparison sort
    must keep the length-primary collation."""
    import ctypes

    from ngstpu.io.native import get_lib
    from ngstpu.ops.sortengine import sort_perm_host

    lib = get_lib()
    if lib is None:
        pytest.skip("no native lib")
    rng = np.random.default_rng(31)
    B, W = 60_000, 7
    words = np.zeros((B, W), np.uint32)
    # 4 shared prefixes over words 0..4; only words 5..6 discriminate
    words[:, :5] = np.array([0xDEADBEEF, 1, 2, 3, 4], np.uint32)[None, :]
    words[:, 0] += rng.integers(0, 4, B).astype(np.uint32)
    words[:, 5] = rng.integers(0, 50, B)
    words[:, 6] = rng.integers(0, 1 << 32, B, dtype=np.uint64).astype(np.uint32)
    words = np.ascontiguousarray(words)
    lens = rng.integers(200, 400, B).astype(np.int32)  # spans the 255 clamp

    # dedup host sort (use_len=1) vs lexsort
    perm = np.empty(B, np.int32)
    is_head = np.empty(B, np.uint8)
    lib.ngs_dedup_sort_host(words, lens.ctypes.data_as(ctypes.c_void_p), 1,
                            B, W, perm, is_head, 0)
    keys = [np.arange(B), lens] + [words[:, w] for w in range(W - 1, -1, -1)]
    np.testing.assert_array_equal(perm, np.lexsort(tuple(keys)))

    # length-first host sort: length primary incl. the >255 clamp bucket
    host = sort_perm_host(words, lens, True)
    keys_lf = [np.arange(B)] + [words[:, w] for w in range(W - 1, -1, -1)] \
        + [lens]
    np.testing.assert_array_equal(host, np.lexsort(tuple(keys_lf)))

    # lex-first host sort (no length key at all)
    host2 = sort_perm_host(words, lens, False)
    keys_nf = [np.arange(B)] + [words[:, w] for w in range(W - 1, -1, -1)]
    np.testing.assert_array_equal(host2, np.lexsort(tuple(keys_nf)))


def test_cloning_sink_fallback_without_cfr(tmp_path, monkeypatch):
    """If copy_file_range fails mid-stream, the threaded clone falls back
    to pread from f1 (the authoritative bytes) — never the producer's
    pooled buffer, which may be reused by then. Outputs must stay
    byte-identical."""
    import os as _os

    from ngstpu.tools.emitters import _CloningSink

    calls = {"n": 0}
    real_cfr = _os.copy_file_range

    def flaky(*a, **k):
        calls["n"] += 1
        if calls["n"] > 1:
            raise OSError(38, "cfr disabled mid-stream")
        return real_cfr(*a, **k)

    monkeypatch.setattr(_os, "copy_file_range", flaky)
    rng = np.random.default_rng(8)
    chunks = [rng.integers(65, 91, 1 << 20, dtype=np.uint8).tobytes()
              for _ in range(5)]
    with open(tmp_path / "a.bin", "wb", buffering=0) as f1, \
            open(tmp_path / "b.bin", "wb", buffering=0) as f2:
        sink = _CloningSink(f1, f2)
        for c in chunks:
            sink.write(memoryview(c))
        sink.close()
    a = (tmp_path / "a.bin").read_bytes()
    b = (tmp_path / "b.bin").read_bytes()
    assert a == b == b"".join(chunks)
    assert calls["n"] >= 2  # the failure path actually ran


def test_gz_false_boundary_repair(tmp_path):
    """A false boundary whose following bytes parse as a DEFLATE
    stored-block prefix defeats BOTH cheap filters (the 4KB zlib probe
    sees 'needs more input', and a planted plausible 'ISIZE' passes the
    ratio test) — the decode-driven repair loop (round 5) must identify
    the consecutive failed-member run, merge it, and still produce exact
    bytes through the parallel path."""
    import struct
    import zlib

    from ngstpu.io.fastindex import _inflate_gz_members_parallel
    from ngstpu.io.native import get_lib

    lib = get_lib()
    if lib is None:
        pytest.skip("native library unavailable")

    rng = np.random.default_rng(7)
    part0 = random_fastq(400, read_len=60, seed=1, dup_frac=0.2)
    part2 = random_fastq(400, read_len=60, seed=2, dup_frac=0.2)
    # middle member is STORED (level 0), so its payload bytes appear
    # verbatim in the compressed stream — embed a fake gzip header
    # followed by a stored-block prefix claiming 0xFFFF upcoming bytes
    # (the probe window ends first: no zlib error), preceded by a
    # plausible fake ISIZE for the piece the false boundary terminates
    trap = (struct.pack("<I", 5000)            # fake "ISIZE" = 5000
            + b"\x1f\x8b\x08\x00"              # gzip magic, FLG=0
            + b"\x00\x00\x00\x00\x00\x03"      # mtime/XFL/OS
            + b"\x00\xff\xff\x00\x00")         # stored block, LEN=0xFFFF
    filler = rng.integers(97, 123, 6000, dtype=np.uint8).tobytes()
    text1 = filler + trap + filler + b"\n"
    co = zlib.compressobj(0, zlib.DEFLATED, 16 + 15)
    member1 = co.compress(text1) + co.flush()

    pz = tmp_path / "trapstored.fq.gz"
    pz.write_bytes(gzip.compress(part0, mtime=0) + member1
                   + gzip.compress(part2, mtime=0))
    raw = np.fromfile(pz, np.uint8)
    out = _inflate_gz_members_parallel(lib, raw, "t.repair")
    assert out is not None, "repair loop must keep the parallel path"
    assert out.tobytes() == part0 + text1 + part2


def test_write_all_finishes_short_raw_writes():
    """Raw (unbuffered) files may write less than asked; the emit sinks
    must keep writing until every byte is out, and fail loudly when a
    write makes no progress."""
    import io

    from ngstpu.tools.emitters import _write_all

    class _Trickle(io.RawIOBase):
        def __init__(self, step):
            self.buf, self.step = bytearray(), step

        def writable(self):
            return True

        def write(self, b):
            k = min(self.step, len(b))
            self.buf += bytes(b[:k])
            return k

    data = np.arange(1000, dtype=np.uint32).view(np.uint8)
    f = _Trickle(7)
    _write_all(f, data)
    assert bytes(f.buf) == data.tobytes()
    with pytest.raises(OSError, match="no progress"):
        _write_all(_Trickle(0), data)
