"""Host allocator tuning for lazily-faulted VM memory.

The pipeline's host stages stream multi-GB f64 matrices through
transient numpy buffers.  glibc serves every such allocation with a
fresh mmap and munmaps it on free, so each one re-pays first-touch page
faults for its whole extent.  On bare metal that is ~1 us/page noise;
on micro-VM hosts with lazily-faulted memory (Firecracker-style
snapshot/ballooned backing) a fault costs tens of microseconds and a
single 2.1 GB allocation pays ~20 s BEFORE any compute — measured on
the round-5 CI host: 0.09 GB/s into fresh pages vs 7-8 GB/s into
reused ones, a 70x cliff that dwarfed every kernel it wrapped.

``tune()`` raises glibc's mmap and trim thresholds via mallopt(3) so
large blocks live in the sbrk heap and freed pages are REUSED warm
across the pipeline's transient allocations.  It is:

- idempotent (one call per process does it);
- a no-op off glibc (mallopt missing -> silently skipped);
- skippable with HIC_NO_MALLOC_TUNE=1 (the trade-off is peak RSS: the
  heap retains its high-water mark instead of returning pages).

Called from the CLI/pipeline entry points and the benchmark harness;
library users embedding single parts can call it themselves.
"""

from __future__ import annotations

import os

_done = False

# mallopt(3) parameter numbers (glibc malloc.h)
_M_TRIM_THRESHOLD = -1
_M_MMAP_THRESHOLD = -3
_M_MMAP_MAX = -4


def tune() -> bool:
    """Apply the allocator tuning once; returns True if active."""
    global _done
    if _done:
        return True
    if os.environ.get("HIC_NO_MALLOC_TUNE"):
        return False
    try:
        import ctypes

        libc = ctypes.CDLL(None, use_errno=True)
        big = ctypes.c_int(2**31 - 1)
        ok = libc.mallopt(_M_TRIM_THRESHOLD, big) == 1
        ok = libc.mallopt(_M_MMAP_THRESHOLD, big) == 1 and ok
        # the threshold is an int, so a 16384^2 f64 matrix (exactly
        # 2^31 bytes) would STILL take glibc's mmap path one byte past
        # the maximum threshold — disable malloc's mmap use entirely so
        # the multi-GiB matrices also come from (and return to) the
        # reusable heap
        ok = libc.mallopt(_M_MMAP_MAX, ctypes.c_int(0)) == 1 and ok
        _done = bool(ok)
        return _done
    except Exception:
        return False
