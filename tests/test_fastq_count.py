import subprocess
import sys

import numpy as np
import pytest

from ngstpu.ops.count import QCAccumulator, qc_histograms
from ngstpu.testing.fixtures import gz, random_fastq
from ngstpu.testing.oracles import run_oracle
from ngstpu.tools import fastq_count


def test_histograms_vs_numpy():
    rng = np.random.default_rng(0)
    B, L = 257, 128
    qual = rng.integers(33, 75, (B, L), dtype=np.uint8)
    lens = rng.integers(0, L + 1, B).astype(np.int32)
    n_valid = 200
    ch, lh = qc_histograms(qual, lens, np.int32(n_valid))
    ch, lh = np.asarray(ch), np.asarray(lh)
    ref = np.zeros((L, 128), dtype=np.int64)
    ref_len = np.zeros(512, dtype=np.int64)
    for i in range(n_valid):
        ref_len[lens[i]] += 1
        for c in range(lens[i]):
            ref[c, qual[i, c]] += 1
    assert (ch == ref).all()
    assert (lh == ref_len).all()


def _run_ngstpu(args):
    from ngstpu.tools.cli import main
    import io, contextlib
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(args)
    assert rc == 0
    return buf.getvalue()


def test_parity_uncompressed(tmp_path):
    data = random_fastq(2000, read_len=100, var_len=True, seed=7)
    p = tmp_path / "x.fq"
    p.write_bytes(data)
    ours = _run_ngstpu(["fastq_count", str(p)])
    ref = run_oracle("fastq_count", [str(p)], cwd=str(tmp_path))
    if ref is None:
        pytest.skip("no C toolchain")
    assert ours == ref.stdout.decode()


def test_parity_gzip_multi_file_header_detail(tmp_path):
    p1 = tmp_path / "a.fq.gz"
    p1.write_bytes(gz(random_fastq(500, read_len=80, seed=8)))
    p2 = tmp_path / "b.fq"
    p2.write_bytes(random_fastq(300, read_len=150, var_len=True, seed=9))
    ref = run_oracle("fastq_count", ["-H", "-L", "-t", "1", str(p1), str(p2)],
                     cwd=str(tmp_path))
    if ref is None:
        pytest.skip("no C toolchain")
    ours = _run_ngstpu(["fastq_count", "-H", "-L", "-t", "1", str(p1), str(p2)])
    assert ours == ref.stdout.decode()


def test_parity_output_file(tmp_path):
    p = tmp_path / "x.fq"
    p.write_bytes(random_fastq(100, read_len=36, seed=10))
    out1 = tmp_path / "ours.tsv"
    out2 = tmp_path / "ref.tsv"
    _run_ngstpu(["fastq_count", "-o", str(out1), str(p)])
    ref = run_oracle("fastq_count", ["-o", str(out2), str(p)], cwd=str(tmp_path))
    if ref is None:
        pytest.skip("no C toolchain")
    assert out1.read_text() == out2.read_text()


def test_host_qc_placement_matches_device(monkeypatch):
    """The host-placement histogram (ngs_qc_hist) must count exactly
    like the device kernels, including >=128 quality-byte drops, length
    clipping at 512 cycles, and mixed device+host accumulation."""
    from ngstpu.io import native
    from ngstpu.ops.count import QCAccumulator

    if native.get_lib() is None:
        pytest.skip("native library unavailable")
    rng = np.random.default_rng(3)
    B, L = 4000, 128
    qual = rng.integers(33, 120, (B, L)).astype(np.uint8)
    qual[::97, 5] = 200  # dropped by both paths
    lens = rng.integers(0, L + 1, B).astype(np.int32)
    qual = np.where(np.arange(L)[None, :] < lens[:, None], qual, 0).astype(np.uint8)

    monkeypatch.delenv("NGSTPU_LINK", raising=False)
    a = QCAccumulator()
    a.add_batch(qual, lens)
    monkeypatch.setenv("NGSTPU_LINK", "host")
    b = QCAccumulator()
    b.add_batch(qual, lens)
    assert np.array_equal(a.quality, b.quality)
    assert np.array_equal(a.seq_len, b.seq_len)

    monkeypatch.delenv("NGSTPU_LINK")
    c = QCAccumulator()
    c.add_batch(qual[:2000], lens[:2000])
    c._mode = "host"
    c.add_batch(qual[2000:], lens[2000:])
    assert np.array_equal(a.quality, c.quality)
    assert np.array_equal(a.seq_len, c.seq_len)
