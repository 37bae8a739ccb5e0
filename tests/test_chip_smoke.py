"""chip_smoke.py at a tiny size: its phases on the CPU backend (and, marked
gpu, on a card), and its refusal to report a result without a GPU."""

import importlib.util
import pathlib

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
N_READS = 8_000


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def lane(smoke, tmp_path_factory):
    return smoke.make_fixture(tmp_path_factory.mktemp("smoke") / "se.fq",
                              N_READS)


def test_main_fails_without_gpu(smoke, capsys):
    assert smoke.main([]) != 0
    out = capsys.readouterr()
    assert '"ok"' not in out.out
    assert "not 'gpu'" in out.err


def test_main_path_phase_device_matches_host(smoke, lane, tmp_path):
    """pipeline (fast and chunked path) and gzfastq_sort on the device
    produce the host runs' bytes; the phase raises otherwise."""
    smoke.phase_main_path(lane, tmp_path / "work")
    assert not list((tmp_path / "work").glob("*.fq"))  # outputs cleaned up


def test_main_path_phase_fails_when_device_sort_skipped(smoke, lane,
                                                         tmp_path,
                                                         monkeypatch):
    """A fast path that quietly sorts on the host instead of the device
    gives the same bytes, so only the jit cache shows it: the phase must
    refuse it."""
    from ngstpu.tools import emitters, pipeline

    def host_instead(words, lens, sumq, bucket, const_len, W):
        return emitters._sort_host_async(words, lens, sumq, const_len)

    monkeypatch.setattr(pipeline, "_sort_device_async", host_instead)
    with pytest.raises(RuntimeError, match="sort_partition.*did not run"):
        smoke.phase_main_path(lane, tmp_path / "work")


def test_kernels_phase_cpu(smoke, lane):
    smoke.phase_kernels(lane, N_READS)


def test_multi_card_phase_on_four_cpu_devices(smoke, lane, tmp_path):
    """The --devices 4 path on four of conftest's virtual CPU devices."""
    smoke.phase_multi(lane, tmp_path / "multi", 4)


def test_multi_card_phase_fails_when_sharded_dedup_skipped(smoke, lane,
                                                           tmp_path,
                                                           monkeypatch):
    """gzfastq_uniq -m that quietly dedups on one device writes the same
    bytes; only the sharded program's jit cache shows it."""
    from ngstpu.tools import gzfastq_uniq

    one_device = gzfastq_uniq.dedup_device
    monkeypatch.setattr(gzfastq_uniq, "dedup_device",
                        lambda seq, lens, sumq, mesh_n=0:
                        one_device(seq, lens, sumq))
    with pytest.raises(RuntimeError, match="exchange_dedup.*did not run"):
        smoke.phase_multi(lane, tmp_path / "multi", 4)


@pytest.mark.gpu
def test_kernels_phase_on_gpu(gpu_device, smoke, lane):
    smoke.phase_kernels(lane, N_READS)
