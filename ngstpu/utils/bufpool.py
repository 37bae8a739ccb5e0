"""Persistent hugepage-backed buffer pool.

On the VM this was tuned on, the anonymous-page fault path was slow and
*variable*, so any stage that allocates a few hundred MB per run could
eat seconds of pure fault time on a bad draw. The pool mmaps each named buffer once, `madvise(MADV_HUGEPAGE)`s
it (512x fewer faults), pre-touches it at acquisition, and hands out numpy
views for the rest of the process — repeated pipeline runs (multi-lane
mode, the warm `serve` daemon, benchmarks) never fault again.

When /dev/shm is usable the buffers are additionally backed by tmpfs
files that OUTLIVE the process (NGSTPU_SHM_POOL=0 opts out): a fresh CLI
invocation re-maps the previous run's still-resident pages instead of
re-paying the first-touch allocation wall. One process at a time owns the
on-disk pool via a flock; concurrent runs fall back to private anonymous
maps. Contents are never preserved across runs (same contract as
same-process reuse: callers treat acquired buffers as uninitialized).

Plays the role the reference's whole-file malloc'd arrays play
(e.g. reference gzfastq_sort.c:243-249 preallocation), but process-wide.
"""

from __future__ import annotations

import mmap
import os
import threading

import numpy as np

_lock = threading.Lock()
_pool: dict[str, tuple[mmap.mmap, int]] = {}

# shm state: None = undecided, "" = disabled/fallback, else the pool dir
_shm_dir: str | None = None
_shm_lock_fd: int = -1
_SHM_BUDGET = int(float(os.environ.get("NGSTPU_SHM_POOL_MAX_GB", "12"))
                  * (1 << 30))


def _shm_init() -> str:
    """Acquire process-exclusive ownership of the on-tmpfs pool directory;
    returns the directory path or "" when unavailable/contended."""
    global _shm_lock_fd
    if os.environ.get("NGSTPU_SHM_POOL", "1") == "0":
        return ""
    base = os.environ.get("NGSTPU_SHM_POOL_DIR",
                          f"/dev/shm/ngstpu-pool-{os.geteuid()}")
    try:
        import fcntl

        os.makedirs(base, mode=0o700, exist_ok=True)
        # /dev/shm is world-writable+sticky: refuse a dir another user
        # pre-created (or loosened) — pool files carry decompressed user
        # data in MAP_SHARED pages and must stay private
        st = os.stat(base)
        if st.st_uid != os.geteuid() or (st.st_mode & 0o077):
            return ""
        fd = os.open(os.path.join(base, ".lock"),
                     os.O_RDWR | os.O_CREAT | os.O_CLOEXEC
                     | getattr(os, "O_NOFOLLOW", 0), 0o600)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            os.close(fd)
            return ""  # another live process owns the pool
        _shm_lock_fd = fd
        return base
    except OSError:
        return ""


def _shm_used(d: str) -> int:
    try:
        with os.scandir(d) as it:
            return sum(e.stat().st_size for e in it if e.is_file())
    except OSError:
        return 0


def _shm_map(name: str, cap: int) -> tuple[mmap.mmap, bool] | None:
    """A MAP_SHARED mapping of the named tmpfs-backed pool file grown to
    `cap` bytes as (mapping, fresh), or None (caller falls back to
    anonymous memory). `fresh` is False when an existing >=cap file was
    re-mapped — its pages are already allocated (likely still resident
    from the previous run), so the caller skips the pre-touch: lazy
    minor faults during use beat a serial upfront walk.
    Called with `_lock` already held by get_buffer."""
    global _shm_dir
    if _shm_dir is None:
        _shm_dir = _shm_init()
    if not _shm_dir:
        return None
    safe = "".join(c if c.isalnum() or c in "._-" else "_" for c in name)
    path = os.path.join(_shm_dir, safe + ".buf")
    try:
        try:
            cur = os.stat(path).st_size
        except FileNotFoundError:
            cur = 0
        if cur < cap:
            # budget-gate growth only: remapping an existing >=cap file is
            # free, and an oversized request must not evict warm siblings
            if _shm_used(_shm_dir) - cur + cap > _SHM_BUDGET:
                return None
            # ftruncate is sparse and tmpfs pages materialize on first
            # touch — past-capacity touches SIGBUS the process, so gate
            # on actual free space (with margin) instead of crashing
            vfs = os.statvfs(_shm_dir)
            if cap - cur > vfs.f_bavail * vfs.f_frsize - (256 << 20):
                return None
            if cur:
                # grow = fresh pages under anonymous maps; unlink the old
                # inode so any stale views that survived a BufferError'd
                # close keep their own (orphaned) pages instead of
                # aliasing the regrown buffer through the shared file
                os.unlink(path)
        flags = (os.O_RDWR | os.O_CREAT | os.O_CLOEXEC
                 | getattr(os, "O_NOFOLLOW", 0))
        fd = os.open(path, flags, 0o600)
    except OSError:
        return None
    try:
        if os.fstat(fd).st_size < cap:
            os.ftruncate(fd, cap)
            return mmap.mmap(fd, cap), True
        return mmap.mmap(fd, cap), False
    except (OSError, ValueError):
        return None
    finally:
        os.close(fd)


def clear_shm_pool() -> None:
    """Delete this process's on-tmpfs pool files (reclaims the pinned
    pages; tmpfs memory is not evictable without swap). Call from
    maintenance paths — live mappings in this process keep their
    (orphaned) pages until released."""
    global _shm_dir
    with _lock:
        if _shm_dir is None:
            _shm_dir = _shm_init()
        d = _shm_dir
        if not d:
            return
        try:
            with os.scandir(d) as it:
                for e in it:
                    if e.name.endswith(".buf"):
                        try:
                            os.unlink(e.path)
                        except OSError:
                            pass
        except OSError:
            pass


def _round_cap(nbytes: int) -> int:
    """Next power-of-two-ish capacity (1.0x/1.5x steps) >= 2MB."""
    cap = 2 << 20
    while cap < nbytes:
        if cap + (cap >> 1) >= nbytes:
            return cap + (cap >> 1)
        cap <<= 1
    return cap


def get_buffer(name: str, nbytes: int, dtype=np.uint8) -> np.ndarray:
    """A flat numpy view of `nbytes` bytes (element count derived from
    dtype) over the named pooled buffer, growing it if needed.

    Views of the same name alias each other — callers use distinct names
    per concurrently-live purpose. Contents are NOT zeroed on reuse.
    """
    nbytes = max(int(nbytes), 1)
    with _lock:
        ent = _pool.get(name)
        if ent is None or ent[1] < nbytes:
            if ent is not None:
                try:
                    ent[0].close()
                except BufferError:
                    pass  # live views keep it alive; GC reclaims later
            cap = _round_cap(nbytes)
            fresh = True
            shm = _shm_map(name, cap)
            if shm is None:
                mm = mmap.mmap(-1, cap)
            else:
                mm, fresh = shm
            if hasattr(mm, "madvise") and hasattr(mmap, "MADV_HUGEPAGE"):
                try:
                    mm.madvise(mmap.MADV_HUGEPAGE)
                except OSError:
                    pass
            # pre-touch once so the fault cost is paid here, not mid-stage —
            # but only up to a bound: a multi-GB request (e.g. sized from an
            # untrusted header field) must not turn into minutes of
            # synchronous page faults; beyond the bound the consumer pays
            # faults lazily for exactly the pages it writes. A re-mapped
            # shm file's pages are already allocated — skip the walk and
            # let use-time minor faults overlap compute instead.
            if fresh:
                pretouch = int(os.environ.get("NGSTPU_PRETOUCH_MAX",
                                              1 << 30))
                np.frombuffer(mm, dtype=np.uint8)[:min(cap, pretouch):4096] = 0
            _pool[name] = (mm, cap)
            ent = _pool[name]
    itemsize = np.dtype(dtype).itemsize
    count = nbytes // itemsize
    return np.frombuffer(ent[0], dtype=dtype, count=count)


def get_matrix(name: str, rows: int, cols: int, dtype=np.uint8) -> np.ndarray:
    a = get_buffer(name, rows * cols * np.dtype(dtype).itemsize, dtype)
    return a.reshape(rows, cols)


def release(name: str) -> None:
    with _lock:
        ent = _pool.pop(name, None)
        if ent is not None:
            try:
                ent[0].close()
            except BufferError:
                pass
