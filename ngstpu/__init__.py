"""ngstpu — high-performance NGS preprocessing on an accelerator with JAX.

A ground-up reimplementation of the capabilities of the reference C toolkit
(xiongxu/HighPerformanceNGS) with the compute on the device:

- ``ngstpu.io``       host I/O runtime: gzip/FASTQ/BAM chunk decoding into
                      fixed-shape padded device batches (C++ fast path via
                      ctypes, pure-numpy fallback).
- ``ngstpu.ops``      device compute: histograms/QC stats, trimming, 2-bit
                      packing, sort/dedup engine, pileup/coverage — jax.numpy
                      and lax, compiled by XLA.
- ``ngstpu.parallel`` multi-chip/multi-host scale-out: jax.sharding Mesh,
                      shard_map data parallelism, psum/all_gather merges.
- ``ngstpu.rng``      bit-exact RNG parity (GSL MT19937, glibc rand, X31).
- ``ngstpu.tools``    CLI subcommands with flag/default/output parity with
                      each reference tool.
"""

__version__ = "0.1.0"

from .utils.malloctune import tune_malloc as _tune_malloc

_tune_malloc()  # see utils/malloctune.py — huge win on slow-fault VMs
del _tune_malloc
