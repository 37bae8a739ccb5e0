"""Test config: run JAX on CPU with 8 virtual devices so multi-device
sharding paths are exercised without a GPU. Tests marked `gpu` skip there
(see the gpu_device fixture).
"""

import os
import pathlib
import sys

import pytest

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()
# CPU unless the caller names a platform: on a machine with a card,
# JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu runs the gpu tests.
os.environ.setdefault("JAX_PLATFORMS", "cpu")

_repo = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(_repo))

# Keep the suite off the global /dev/shm pool: it would grow the shared
# pool files and contend with a concurrently running bench/CLI for the
# flock. The dedicated bufpool tests opt back in with their own dirs.
os.environ.setdefault("NGSTPU_SHM_POOL", "0")

# Persistent XLA compilation cache (the CLI's rule, utils/jaxsetup.py):
# JAX_COMPILATION_CACHE_DIR if set, else <checkout>/.cache/jax.
from ngstpu.utils.jaxsetup import setup_jax_cache  # noqa: E402

setup_jax_cache()

import jax  # noqa: E402

if jax.default_backend() == "cpu":
    assert len(jax.devices()) == 8, jax.devices()


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test where JAX has none."""
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs a GPU (run on the card: pytest tests/ -m gpu)")
    return devs[0]
