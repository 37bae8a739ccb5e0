"""QC counting kernels: per-cycle quality histogram + read-length histogram.

Reimplements the hot loop of the reference `fastq_count` family
(reference fastq_count.c:106-133 `count_read` / `AssignQuality`,
fastq_count_kthread.c:126-147) as a device reduction: instead of scalar
`Quality[q][cycle]++` increments, each batch computes a fused
compare-and-reduce over [B, L, NQ] (XLA fuses the one-hot compare into the
sum, so nothing is materialized) yielding the [cycle, qual] count matrix.
The length histogram is the same compare-reduce over 512 bins, with no
scatter anywhere.

Accumulation stays ON DEVICE across batches (donated buffers), so the host
sees exactly one small [128, 512] transfer per file instead of one blocking
round-trip per chunk; device dispatch overlaps the host-side parse of the
next chunk.

Parity notes (SURVEY.md §7 quirks register):
- Q20/Q30 thresholds are raw ASCII >=53 / >=63 (reference fastq_count.c:124).
- 128 quality rows x 512 cycles, 512 length bins (fastq_count.c:110-111);
  longer reads are UB in C — we clip.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.placement import placement

N_QUAL = 128
N_CYCLE = 512
Q20_ASCII = 53
Q30_ASCII = 63


@functools.partial(jax.jit, static_argnames=("n_qual", "n_len"))
def qc_histograms(qual: jax.Array, lens: jax.Array, n_valid: jax.Array,
                  n_qual: int = N_QUAL, n_len: int = N_CYCLE):
    """Per-batch QC histograms (scatter-free).

    qual: uint8 [B, L]; lens: int32 [B]; n_valid: scalar int32.
    Returns (cycle_hist int32 [L, n_qual], len_hist int32 [n_len]).
    """
    B, L = qual.shape
    col = jax.lax.broadcasted_iota(jnp.int32, (B, L), 1)
    row = jax.lax.broadcasted_iota(jnp.int32, (B, 1), 0)
    rowmask = row < n_valid
    mask = (col < lens[:, None]) & rowmask

    qvals = jax.lax.broadcasted_iota(jnp.int32, (1, 1, n_qual), 2)
    onehot = (qual.astype(jnp.int32)[:, :, None] == qvals) & mask[:, :, None]
    cycle_hist = jnp.sum(onehot, axis=0, dtype=jnp.int32)

    lvals = jax.lax.broadcasted_iota(jnp.int32, (1, n_len), 1)
    lens_clip = jnp.clip(lens, 0, n_len - 1)
    len_onehot = (lens_clip[:, None] == lvals) & rowmask
    len_hist = jnp.sum(len_onehot, axis=0, dtype=jnp.int32)
    return cycle_hist, len_hist


@functools.partial(jax.jit, donate_argnums=(0, 1),
                   static_argnames=("n_qual", "n_len"))
def _accumulate(total_q: jax.Array, total_len: jax.Array, qual: jax.Array,
                lens: jax.Array, n_valid: jax.Array,
                n_qual: int = N_QUAL, n_len: int = N_CYCLE):
    ch, lh = qc_histograms(qual, lens, n_valid, n_qual, n_len)
    L = ch.shape[0]
    ncols = min(L, n_len)
    total_q = total_q.at[:ncols, :].add(ch[:ncols, :])
    return total_q, total_len + lh


class QCAccumulator:
    """Accumulates batch histograms into the C-layout totals.

    Device accumulation (donated buffers) is the default; NGSTPU_LINK=host
    accumulates with the native threaded histogram instead. Both count
    exactly, so placement never changes results.
    """

    def __init__(self):
        self._dev_q = jnp.zeros((N_CYCLE, N_QUAL), jnp.int32)  # [cycle, qual]
        self._dev_len = jnp.zeros((N_CYCLE,), jnp.int32)
        self._host_q: np.ndarray | None = None
        self._host_len: np.ndarray | None = None
        self._acc_q: np.ndarray | None = None  # host-side partials
        self._acc_len: np.ndarray | None = None
        self._mode = placement()
        self._n_dev_batches = 0

    @classmethod
    def from_host_partials(cls, hist_q: np.ndarray,
                           hist_len: np.ndarray) -> "QCAccumulator":
        """Wrap externally-accumulated host histograms (e.g. the fused
        native pass, ngsio.cpp ngs_fastq_fused) without touching a device.

        hist_q: [N_CYCLE, N_QUAL] cycle-major; hist_len: [N_CYCLE]."""
        acc = cls.__new__(cls)
        acc._dev_q = None
        acc._dev_len = None
        acc._host_q = hist_q.astype(np.int64).T  # [qual, cycle]
        acc._host_len = hist_len.astype(np.int64)
        acc._acc_q = None
        acc._acc_len = None
        acc._mode = "host"
        acc._n_dev_batches = 0
        return acc

    def _add_host(self, qual: np.ndarray, lens: np.ndarray,
                  n_valid: int) -> bool:
        from ..io.native import get_lib

        lib = get_lib()
        if lib is None:
            return False
        if self._acc_q is None:
            self._acc_q = np.zeros((N_CYCLE, N_QUAL), np.uint64)
            self._acc_len = np.zeros(N_CYCLE, np.uint64)
        q = np.ascontiguousarray(qual[:n_valid])
        l32 = np.ascontiguousarray(lens[:n_valid], np.int32)
        if n_valid:
            lib.ngs_qc_hist(q, l32, n_valid, q.shape[1], N_QUAL, N_CYCLE,
                            self._acc_q, self._acc_len, 0)
        self._host_q = None
        return True

    def add_batch(self, qual: np.ndarray, lens: np.ndarray,
                  n_valid: int | None = None) -> None:
        """Accumulate one batch. Rows may be unpadded; the device path
        bucket-pads internally (host path slices [:n_valid] directly, so
        callers need not copy into padded buffers)."""
        if n_valid is None:
            n_valid = qual.shape[0]
        if self._mode == "host" and self._add_host(qual, lens, n_valid):
            return
        self._host_q = None
        from ..utils.padding import bucket_rows, pad_rows

        b = bucket_rows(qual.shape[0])
        if b != qual.shape[0]:
            qual = pad_rows(qual, b)
            lens = pad_rows(lens, b)
        self._dev_q, self._dev_len = _accumulate(
            self._dev_q, self._dev_len, jnp.asarray(qual), jnp.asarray(lens),
            jnp.int32(n_valid))
        self._n_dev_batches += 1

    def _materialize(self) -> None:
        if self._host_q is None:
            dq = np.asarray(self._dev_q, dtype=np.int64)
            dl = np.asarray(self._dev_len, dtype=np.int64)
            if self._acc_q is not None:
                dq = dq + self._acc_q.astype(np.int64)
                dl = dl + self._acc_len.astype(np.int64)
            self._host_q = dq.T  # [qual, cycle]
            self._host_len = dl

    @property
    def quality(self) -> np.ndarray:
        self._materialize()
        return self._host_q

    @property
    def seq_len(self) -> np.ndarray:
        self._materialize()
        return self._host_len

    def merge(self, other: "QCAccumulator") -> None:
        self._materialize()
        other._materialize()
        self._host_q = self._host_q + other._host_q
        self._host_len = self._host_len + other._host_len

    def stats(self) -> dict:
        """Reproduces statSeqLen + statQ (reference fastq_count.c:37-74)."""
        freq = self.seq_len
        nz = np.flatnonzero(freq)
        sum_freq = int(freq.sum())
        total_len = float(np.sum(freq.astype(np.float64) * np.arange(N_CYCLE)))
        # C quirk (fastq_count.c:70): minLen is only set while it is still 0,
        # so a length-0 bin can never register; min is the first nonzero index.
        min_len = int(nz[0]) if len(nz) else 0
        max_len = int(nz[-1]) if len(nz) else 0
        qsum = int(self.quality.sum())
        q20 = int(self.quality[Q20_ASCII:, :].sum())
        q30 = int(self.quality[Q30_ASCII:, :].sum())
        return dict(read_count=sum_freq, base_count=total_len,
                    mean_len=(total_len / sum_freq) if sum_freq else float("nan"),
                    min_len=min_len, max_len=max_len,
                    q20_pct=(q20 / qsum * 100.0) if qsum else float("nan"),
                    q30_pct=(q30 / qsum * 100.0) if qsum else float("nan"),
                    qual_sum=qsum)
