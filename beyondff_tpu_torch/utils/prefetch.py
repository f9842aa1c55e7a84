"""Background prefetching: overlap host IO with device compute.

The reference reads every depth/pose file inline in its GPU loop
(reference: tools/projection_2d_to_3d.py:422-436); here a worker thread keeps
``depth`` chunks ready while the device lifts the previous chunk — the
software-pipeline answer to SURVEY.md §2.4's "pipeline parallel" row. The
port's copy of beyondff_tpu/utils/prefetch.py.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, TypeVar

T = TypeVar("T")
U = TypeVar("U")

_SENTINEL = object()


def prefetch(iterable: Iterable[T], depth: int = 2) -> Iterator[T]:
    """Iterate ``iterable`` with up to ``depth`` items materialized ahead by a
    background thread. Exceptions propagate at the consuming site."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)

    def worker():
        try:
            for item in iterable:
                q.put(item)
        except BaseException as e:  # noqa: BLE001 - forwarded to consumer
            q.put(("__error__", e))
        finally:
            q.put(_SENTINEL)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _SENTINEL:
            break
        if isinstance(item, tuple) and len(item) == 2 and item[0] == "__error__":
            raise item[1]
        yield item


def prefetch_map(fn: Callable[[T], U], items: Iterable[T], depth: int = 2) -> Iterator[U]:
    """``map`` with background prefetching of results, order-preserving."""
    return prefetch((fn(x) for x in items), depth=depth)
