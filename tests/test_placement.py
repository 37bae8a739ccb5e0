"""Device-or-host placement, the compile-cache location, the device count
behind -m, and the device dedup limit."""

import numpy as np
import pytest

from ngstpu.testing.fixtures import random_fastq
from ngstpu.tools.cli import main as cli_main


@pytest.mark.parametrize("value,expect", [(None, "device"), ("", "device"),
                                          ("device", "device"),
                                          ("host", "host"), ("tunnel", None)])
def test_placement_rule(monkeypatch, value, expect):
    """Device by default, NGSTPU_LINK=host pins the host engines, and any
    other value is an error rather than a silent choice."""
    from ngstpu.utils.placement import placement

    if value is None:
        monkeypatch.delenv("NGSTPU_LINK", raising=False)
    else:
        monkeypatch.setenv("NGSTPU_LINK", value)
    if expect is None:
        with pytest.raises(ValueError, match="NGSTPU_LINK"):
            placement()
    else:
        assert placement() == expect


@pytest.mark.parametrize("env", [None, "/x/jax-cache"])
def test_compile_cache_dir_rule(monkeypatch, env):
    """JAX_COMPILATION_CACHE_DIR wins where set; otherwise the cache is
    the fixed <checkout>/.cache/jax."""
    import pathlib

    from ngstpu.utils import jaxsetup

    if env is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        repo = pathlib.Path(__file__).resolve().parent.parent
        assert jaxsetup.compile_cache_dir() == str(repo / ".cache" / "jax")
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env)
        assert jaxsetup.compile_cache_dir() == env


@pytest.mark.parametrize("argv", [
    ["gzfastq_uniq", "-1", "{fq}", "-o", "{out}", "-m", "16"],
    ["gzfastq_sort", "-i", "{fq}", "-s", "-o", "{out}", "-m", "16"],
])
def test_mesh_larger_than_devices_is_an_error(tmp_path, capsys, argv):
    """-m N with fewer than N devices fails with a clear message instead of
    silently running on the devices present."""
    import jax

    assert len(jax.devices()) < 16
    p = tmp_path / "in.fq"
    p.write_bytes(random_fastq(200, read_len=50, seed=3))
    rc = cli_main([a.format(fq=p, out=tmp_path / "o") for a in argv])
    assert rc != 0
    err = capsys.readouterr().err
    assert "16-device mesh" in err and "devices are present" in err


def test_device_dedup_limit_from_memory_stats(monkeypatch, capsys):
    """The dedup limit follows the device's bytes_limit with the stated
    headroom; past it the sort spills to the host and says so."""
    import jax.numpy as jnp

    from ngstpu.ops import sortengine

    class _Dev:
        def memory_stats(self):
            return {"bytes_limit": 8 * 1000}

    assert sortengine.device_dedup_limit() is None  # CPU: no memory limit
    monkeypatch.setattr(sortengine.jax, "devices", lambda: [_Dev()])
    assert sortengine.device_dedup_limit() == 8000 // sortengine.DEDUP_HEADROOM
    monkeypatch.undo()

    rng = np.random.default_rng(2)
    B = 600  # 600 rows x 2 words x 4 bytes > the 1000-byte limit below
    words = rng.integers(0, 3, (B, 2)).astype(np.uint32)
    lens = np.full(B, 8, np.int32)
    sumq = rng.integers(0, 100, B).astype(np.uint32)
    dev = sortengine.dedup_groups(jnp.asarray(words), jnp.asarray(lens),
                                  jnp.asarray(sumq), B)
    assert "exceed" not in capsys.readouterr().err
    monkeypatch.setattr(sortengine, "DEVICE_DEDUP_LIMIT", 1000)
    host = sortengine.dedup_groups(jnp.asarray(words), jnp.asarray(lens),
                                   jnp.asarray(sumq), B)
    assert "exceed the device limit of 1000 bytes" in capsys.readouterr().err
    for k in ("perm", "counts", "rep"):
        assert np.array_equal(dev[k], host[k]), k
