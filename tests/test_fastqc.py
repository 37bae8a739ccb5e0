import numpy as np
import pytest

from ngstpu.ops.fastqc import (MAX_LEN, fastqc_stats, fastqc_stats_numpy,
                               gc_fraction, truncated_key)
from ngstpu.testing.fixtures import random_fastq
from ngstpu.tools.cli import main as cli_main


def _parse(data: bytes):
    lines = data.split(b"\n")
    recs = [(lines[i + 1], lines[i + 3]) for i in range(0, len(lines) - 1, 4)]
    return [r[0] for r in recs], [r[1] for r in recs]


def test_stats_vs_numpy_oracle(tmp_path):
    data = random_fastq(300, read_len=90, var_len=True, with_n=True, seed=80)
    seqs, quals = _parse(data)
    q_ref, nt_ref, len_ref, gc_ref = fastqc_stats_numpy(seqs, quals)

    from ngstpu.io.fastq import read_fastq_file
    p = tmp_path / "x.fq"
    p.write_bytes(data)
    b = read_fastq_file(str(p))
    res = fastqc_stats(np.asarray(b.seq), np.asarray(b.qual),
                       np.asarray(b.lens), np.int32(b.n))
    L = res["quality"].shape[0]
    assert (np.asarray(res["quality"])[:L].T == q_ref[:, :L]).all()
    assert (np.asarray(res["ntval"])[:L].T == nt_ref[:, :L]).all()
    assert (np.asarray(res["len_hist"]) == len_ref).all()
    gc = gc_fraction(np.asarray(res["gc_count"])[:b.n], b.lens)
    assert np.allclose(gc, gc_ref, atol=1e-6)


def test_truncated_key_rule():
    seq = np.zeros((3, 128), dtype=np.uint8)
    seq[:, :100] = ord("A")
    lens = np.array([100, 75, 40], dtype=np.int32)
    key, key_lens = truncated_key(seq, lens)
    assert list(key_lens) == [50, 75, 40]


def test_fastqc_cli(tmp_path, monkeypatch):
    p1 = tmp_path / "r1.fq"
    p1.write_bytes(random_fastq(200, read_len=80, seed=81, dup_frac=0.3))
    monkeypatch.chdir(tmp_path)
    rc = cli_main(["fastqc", "qc", str(p1)])
    assert rc == 0
    for sfx in ("_quality_mate1.tsv", "_nucleotide_mate1.tsv",
                "_length_mate1.tsv", "_gc_mate1.tsv", "_duplication.tsv",
                "_quality_heatmap_mate1.png", "_nucleotide_mate1.png",
                "_duplication.png"):
        f = tmp_path / ("qc" + sfx)
        assert f.exists() and f.stat().st_size > 0, sfx
    assert (tmp_path / "qc_quality_heatmap_mate1.png").read_bytes()[:4] == b"\x89PNG"


def test_adapter_content_matches_oracle():
    from ngstpu.ops.fastqc import ADAPTERS, adapter_content, adapter_content_numpy
    import jax.numpy as jnp

    rng = np.random.default_rng(11)
    B, L = 400, 80
    seq = rng.choice(np.frombuffer(b"ACGT", np.uint8), (B, L))
    lens = rng.integers(20, L + 1, B).astype(np.int32)
    # plant adapters at random offsets in some reads
    ad = ADAPTERS[0][1]
    for i in range(0, B, 7):
        off = int(rng.integers(0, lens[i] - len(ad))) if lens[i] > len(ad) else 0
        if off + len(ad) <= lens[i]:
            seq[i, off:off + len(ad)] = np.frombuffer(ad, np.uint8)
    seq = np.where(np.arange(L)[None, :] < lens[:, None], seq, 0).astype(np.uint8)

    adm = np.frombuffer(b"".join(a for _, a in ADAPTERS),
                        np.uint8).reshape(len(ADAPTERS), -1)
    got = np.asarray(adapter_content(jnp.asarray(seq), jnp.asarray(lens),
                                     jnp.int32(B), jnp.asarray(adm)))
    seqs = [seq[i, :lens[i]].tobytes() for i in range(B)]
    want = adapter_content_numpy(seqs, max_len=L)
    assert np.array_equal(got, want)


def test_overrepresented_table(tmp_path):
    from ngstpu.tools.fastqc import run

    rng = np.random.default_rng(12)
    hot = b"ACGTACGTACGTACGTACGTACGTACGTACGTACGTACGT"  # 40bp, < 50 key limit
    recs = []
    for i in range(1000):
        if i % 5 == 0:
            s = hot
        else:
            s = rng.choice(np.frombuffer(b"ACGT", np.uint8), 40).tobytes()
        recs.append(b"@r%d\n%s\n+\n%s\n" % (i, s, b"I" * len(s)))
    p = tmp_path / "a.fq"
    p.write_bytes(b"".join(recs))
    run(str(tmp_path / "qc"), str(p), None)
    rows = (tmp_path / "qc_overrepresented.tsv").read_text().splitlines()
    assert rows[0].startswith("#")
    top = rows[1].split("\t")
    assert top[0] == hot.decode()
    assert int(top[1]) == 200
    assert abs(float(top[2]) - 20.0) < 1e-6
    assert (tmp_path / "qc_adapter_mate1.tsv").exists()


def test_per_tile_quality_vs_numpy(tmp_path):
    from ngstpu.ops.fastqc import parse_tile_ids, per_tile_quality
    import jax.numpy as jnp
    from ngstpu.io.fastq import read_fastq_file

    rng = np.random.default_rng(13)
    recs = []
    L = 40
    for i in range(240):
        tile = 1100 + (i % 3)  # three tiles
        q = (rng.integers(33, 74, L, dtype=np.uint8) + (i % 3)).clip(33, 104)
        s = rng.choice(np.frombuffer(b"ACGT", np.uint8), L).tobytes()
        recs.append(b"@M01:2:FC1:1:%d:%d:%d 1:N:0:1\n%s\n+\n%s\n"
                    % (tile, i, i, s, q.tobytes()))
    p = tmp_path / "t.fq"
    p.write_bytes(b"".join(recs))
    b = read_fastq_file(str(p))
    parsed = parse_tile_ids(b, step=1)
    assert parsed is not None
    rows_idx, tile_ord, tiles = parsed
    assert tiles == [1100, 1101, 1102]
    sums, cnts = per_tile_quality(jnp.asarray(b.qual[rows_idx]),
                                  jnp.asarray(b.lens[rows_idx]),
                                  jnp.int32(len(rows_idx)),
                                  jnp.asarray(tile_ord), len(tiles))
    sums, cnts = np.asarray(sums), np.asarray(cnts)
    # numpy oracle
    want_s = np.zeros_like(sums)
    want_c = np.zeros_like(cnts)
    for j, i in enumerate(rows_idx):
        t = tile_ord[j]
        ln = int(b.lens[i])
        want_s[t, :ln] += b.qual[i, :ln].astype(np.int64) - 33
        want_c[t, :ln] += 1
    assert np.array_equal(sums, want_s)
    assert np.array_equal(cnts, want_c)


def test_parse_tile_ids_old_and_bad():
    from ngstpu.ops.fastqc import parse_tile_ids

    class FakeBatch:
        def __init__(self, names):
            self._names = names
            self.n = len(names)

        def name(self, i):
            return self._names[i]

    # CASAVA <1.8: @HWUSI-EAS100R:6:73:941:1973#0/1 -> tile field index 2
    b = FakeBatch([b"@HWUSI-EAS100R:6:73:941:1973#0/1",
                   b"@HWUSI-EAS100R:6:74:941:1973#0/1"])
    parsed = parse_tile_ids(b)
    assert parsed is not None and parsed[2] == [73, 74]
    # no coordinates -> module skipped
    assert parse_tile_ids(FakeBatch([b"@read_1", b"@read_2"])) is None


def test_kmer_counts_vs_numpy():
    from ngstpu.ops.fastqc import (kmer_id_to_str, kmer_position_counts,
                                   kmer_report)
    import jax.numpy as jnp

    rng = np.random.default_rng(14)
    B, L, k = 120, 36, 7
    seq = rng.choice(np.frombuffer(b"ACGTN", np.uint8), (B, L),
                     p=[0.24, 0.24, 0.24, 0.24, 0.04])
    lens = rng.integers(10, L + 1, B).astype(np.int32)
    motif = b"GATTACA"
    seq[::4, 5:12] = np.frombuffer(motif, np.uint8)  # enriched at pos 6
    lens[::4] = np.maximum(lens[::4], 12)
    got = np.asarray(kmer_position_counts(jnp.asarray(seq), jnp.asarray(lens),
                                          jnp.int32(B), k))
    # numpy oracle
    want = np.zeros((L, 4 ** k), np.int64)
    code = {65: 0, 67: 1, 71: 2, 84: 3}
    for i in range(B):
        s = seq[i, :lens[i]]
        for p in range(int(lens[i]) - k + 1):
            w = s[p:p + k]
            if all(int(c) in code for c in w):
                kid = 0
                for c in w:
                    kid = (kid << 2) | code[int(c)]
                want[p, kid] += 1
    assert np.array_equal(got, want)
    rows = kmer_report(got, k)
    by_kmer = {r[0]: r for r in rows}
    assert "GATTACA" in by_kmer and by_kmer["GATTACA"][3] == 6
    assert by_kmer["GATTACA"][1] == 31
    assert kmer_id_to_str(0b01001111001100, 7) == "CATTATA"


def test_fastqc_cli_new_modules(tmp_path, monkeypatch):
    rng = np.random.default_rng(15)
    recs = []
    for i in range(300):
        s = rng.choice(np.frombuffer(b"ACGT", np.uint8), 60).tobytes()
        recs.append(b"@M01:2:FC1:1:%d:%d:%d 1:N:0:1\n%s\n+\n%s\n"
                    % (1101 + i % 2, i, i, s, b"I" * 60))
    p = tmp_path / "r.fq"
    p.write_bytes(b"".join(recs))
    monkeypatch.chdir(tmp_path)
    assert cli_main(["fastqc", "qc", str(p)]) == 0
    assert (tmp_path / "qc_per_tile_mate1.tsv").stat().st_size > 0
    assert (tmp_path / "qc_kmer_mate1.tsv").exists()
    nc = (tmp_path / "qc_ncontent_mate1.tsv").read_text().splitlines()
    assert nc[0].startswith("#") and len(nc) == 61
    tile_rows = (tmp_path / "qc_per_tile_mate1.tsv").read_text().splitlines()
    assert tile_rows[1].split("\t")[0] == "1101"
    assert len(tile_rows) == 3


def test_fastqc_stats_host_matches_device():
    """The host placement (native histogram + vectorized numpy) must match
    the device kernel bit-for-bit on ragged, mixed-alphabet input."""
    import numpy as np
    import jax.numpy as jnp

    from ngstpu.ops.fastqc import fastqc_stats, fastqc_stats_host

    rng = np.random.default_rng(41)
    for trial in range(4):
        B = int(rng.integers(1, 4000))
        L = int(rng.choice([40, 128, 301]))
        seq = rng.choice(np.frombuffer(b"ACGTNacgtn.X\x00", np.uint8),
                         (B, L)).astype(np.uint8)
        qual = rng.integers(0, 256, (B, L)).astype(np.uint8)
        lens = rng.integers(0, L + 4, B).astype(np.int32)
        # zero padding past lens like the parser does (host path must not
        # depend on it though — it masks explicitly)
        dev = fastqc_stats(jnp.asarray(seq), jnp.asarray(qual),
                           jnp.asarray(lens), jnp.int32(B))
        host = fastqc_stats_host(seq, qual, lens, B)
        for k in ("quality", "ntval", "len_hist"):
            assert np.array_equal(np.asarray(dev[k]), host[k]), (trial, k)
        assert np.array_equal(np.asarray(dev["gc_count"]),
                              host["gc_count"]), trial


def test_fastqc_host_modules_match_device():
    """adapter/per-tile/kmer/dedup host placements must match the device
    kernels exactly (the full host routing a dead accelerator link takes)."""
    import numpy as np
    import jax.numpy as jnp

    from ngstpu.ops.fastqc import (ADAPTERS, adapter_content,
                                   adapter_content_host,
                                   dedup_groups_host_native,
                                   kmer_position_counts,
                                   kmer_position_counts_host,
                                   per_tile_quality, per_tile_quality_host)
    from ngstpu.ops.sortengine import dedup_groups, pack_for_dedup

    rng = np.random.default_rng(47)
    B, L = 3000, 90
    seq = rng.choice(np.frombuffer(b"ACGTN", np.uint8), (B, L)).astype(np.uint8)
    lens = rng.integers(20, L + 1, B).astype(np.int32)
    qual = rng.integers(33, 75, (B, L)).astype(np.uint8)
    # plant adapters in some reads
    ad = np.frombuffer(b"".join(a for _, a in ADAPTERS),
                       np.uint8).reshape(len(ADAPTERS), -1)
    for i in range(0, B, 7):
        a = i % len(ADAPTERS)
        p = int(rng.integers(0, 30))
        seq[i, p:p + ad.shape[1]] = ad[a]

    got = adapter_content_host(seq, lens, B, ad)
    exp = np.asarray(adapter_content(jnp.asarray(seq), jnp.asarray(lens),
                                     jnp.int32(B), jnp.asarray(ad)))
    assert np.array_equal(got, exp)

    tiles = rng.integers(0, 12, B).astype(np.int32)
    s_h, c_h = per_tile_quality_host(qual, lens, B, tiles, 12)
    s_d, c_d = per_tile_quality(jnp.asarray(qual), jnp.asarray(lens),
                                jnp.int32(B), jnp.asarray(tiles), 12)
    assert np.array_equal(s_h, np.asarray(s_d))
    assert np.array_equal(c_h, np.asarray(c_d))

    kc_h = kmer_position_counts_host(seq, lens, B)
    kc_d = np.asarray(kmer_position_counts(jnp.asarray(seq),
                                           jnp.asarray(lens), jnp.int32(B)))
    assert np.array_equal(kc_h, kc_d)

    got = dedup_groups_host_native(seq, lens)
    if got is not None:
        counts_h, rep_h = got
        words, encode_len = pack_for_dedup(seq)
        g = dedup_groups(words, jnp.asarray(lens),
                         jnp.zeros(B, jnp.uint32), B, length_first=False,
                         words_encode_len=encode_len)
        assert np.array_equal(counts_h, g["counts"])
        assert np.array_equal(rep_h, g["rep"])


def test_adapter_host_ragged_lens_past_width():
    """lens > padded width must not crash the sparse verify (device path
    matches padded zeros there and finds nothing)."""
    import numpy as np
    import jax.numpy as jnp

    from ngstpu.ops.fastqc import ADAPTERS, adapter_content, adapter_content_host

    rng = np.random.default_rng(3)
    B, L = 200, 20  # shorter than adapter+8, lens overflow the width
    seq = rng.choice(np.frombuffer(b"ACGT", np.uint8), (B, L)).astype(np.uint8)
    lens = rng.integers(0, L + 9, B).astype(np.int32)
    ad = np.frombuffer(b"".join(a for _, a in ADAPTERS),
                       np.uint8).reshape(len(ADAPTERS), -1)
    got = adapter_content_host(seq, lens, B, ad)
    exp = np.asarray(adapter_content(jnp.asarray(seq), jnp.asarray(lens),
                                     jnp.int32(B), jnp.asarray(ad)))
    assert np.array_equal(got, exp)


def test_dedup_host_native_libless_matches(monkeypatch):
    """The numpy lexsort fallback (no native library) returns the same
    counts/rep as the native engine."""
    import numpy as np

    from ngstpu.ops import fastqc as F

    rng = np.random.default_rng(5)
    B, L = 2000, 40
    key = rng.choice(np.frombuffer(b"ACGTN", np.uint8), (B, L)).astype(np.uint8)
    lens = rng.integers(10, L + 1, B).astype(np.int32)
    key *= np.arange(L)[None, :] < lens[:, None]
    native = F.dedup_groups_host_native(key, lens)
    import ngstpu.io.native as N
    monkeypatch.setattr(N, "get_lib", lambda: None)
    libless = F.dedup_groups_host_native(key, lens)
    if native is not None:
        assert np.array_equal(native[0], libless[0])
        assert np.array_equal(native[1], libless[1])
