"""Named lazy thread pools shared across the store tier.

One registry instead of per-module singleton boilerplate: pools are
created on first use and live for the process (daemon threads; the
work items are short CPU-bound tasks whose native kernels release the
GIL).
"""

from __future__ import annotations

import concurrent.futures
import threading
from typing import Dict

from .logging import get_logger
from ..analysis.lockdep import named_lock

logger = get_logger("pool")

_pools: Dict[str, concurrent.futures.ThreadPoolExecutor] = {}
_sizes: Dict[str, int] = {}
#: (name, requested) pairs already warned about — one log line per
#: distinct mismatch, not one per call on a hot path
_warned: set = set()
_lock = named_lock("utils.pool")


def get_pool(name: str,
             max_workers: int) -> concurrent.futures.ThreadPoolExecutor:
    """The process-wide pool registered under `name` (created with
    `max_workers` on first call; later calls reuse it as-is). A later
    call asking for a DIFFERENT size gets the existing pool — but the
    mismatch is logged once, so a mis-sized pool is diagnosable
    instead of silently throttling its second caller."""
    with _lock:
        pool = _pools.get(name)
        if pool is None:
            pool = _pools[name] = concurrent.futures.ThreadPoolExecutor(
                max_workers=max_workers, thread_name_prefix=name)
            _sizes[name] = max_workers
        elif _sizes.get(name) != max_workers and \
                (name, max_workers) not in _warned:
            _warned.add((name, max_workers))
            logger.warning(
                "pool %r already created with max_workers=%d; "
                "ignoring requested max_workers=%d (first caller "
                "wins for the process lifetime)",
                name, _sizes.get(name, 0), max_workers)
        return pool
