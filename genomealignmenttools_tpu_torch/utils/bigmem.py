"""Large hot-path buffer allocation.

On the sandboxed kernels this framework deploys on (gVisor-style), first
touching a fresh glibc-malloc'd (MAP_PRIVATE anonymous) region costs
~60 ms/MB - a 256 MB genome buffer pays ~15 s of page faults before any
useful work happens.  MAP_SHARED anonymous memory faults ~20x faster on
the same kernels and identically on stock Linux, so every multi-megabyte
working buffer (decoded chromosomes, pair tiles, pack scratch) comes from
here instead of np.empty.

The mmap object is pinned as the array's .base, so lifetime is the usual
numpy lifetime.
"""

from __future__ import annotations

import mmap

import numpy as np

# below this, glibc serves from reused arenas and np.empty is fine
_THRESHOLD = 1 << 22


def big_empty(shape, dtype=np.uint8) -> np.ndarray:
    """np.empty drop-in backed by MAP_SHARED anonymous pages for large
    buffers (cheap first touch on sandboxed kernels)."""
    if isinstance(shape, (int, np.integer)):
        shape = (int(shape),)
    dt = np.dtype(dtype)
    count = 1
    for s in shape:
        count *= int(s)
    nbytes = count * dt.itemsize
    if nbytes < _THRESHOLD:
        return np.empty(shape, dt)
    buf = mmap.mmap(-1, max(nbytes, 1))
    return np.frombuffer(buf, dtype=dt, count=count).reshape(shape)


def big_copy(arr: np.ndarray) -> np.ndarray:
    """arr.copy() into a big_empty-backed buffer (cheap first touch)."""
    out = big_empty(arr.shape, arr.dtype)
    np.copyto(out, arr)
    return out


def big_zeros(shape, dtype=np.uint8) -> np.ndarray:
    """Zero-filled variant (anonymous mmap pages start zeroed)."""
    if isinstance(shape, (int, np.integer)):
        shape = (int(shape),)
    dt = np.dtype(dtype)
    count = 1
    for s in shape:
        count *= int(s)
    nbytes = count * dt.itemsize
    if nbytes < _THRESHOLD:
        return np.zeros(shape, dt)
    buf = mmap.mmap(-1, max(nbytes, 1))
    return np.frombuffer(buf, dtype=dt, count=count).reshape(shape)
