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
    background thread. Exceptions propagate at the consuming site. Closing
    the iterator early (``close()``, or dropping it) stops the thread after
    the item it is making."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in iterable:
                if not put(item):
                    return
        except BaseException as e:  # noqa: BLE001 - forwarded to consumer
            put(("__error__", e))
        finally:
            put(_SENTINEL)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                break
            if isinstance(item, tuple) and len(item) == 2 and item[0] == "__error__":
                raise item[1]
            yield item
    finally:
        stop.set()


def prefetch_map(fn: Callable[[T], U], items: Iterable[T], depth: int = 2,
                 workers: int = 1) -> Iterator[U]:
    """``map`` with background prefetching of results, order-preserving.

    ``workers > 1`` maps through a thread pool with at most
    ``max(depth, workers)`` items in flight: stages whose work releases the
    interpreter lock (JPEG decode, wire packing, device copies) then
    overlap each other, which one loader thread serializes. An exception
    raised by ``fn`` is raised at the consumer, in order."""
    if workers <= 1:
        return prefetch((fn(x) for x in items), depth=depth)

    def gen() -> Iterator[U]:
        import collections
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=workers) as ex:
            pending: "collections.deque" = collections.deque()
            try:
                for x in items:
                    pending.append(ex.submit(fn, x))
                    if len(pending) >= max(depth, workers):
                        yield pending.popleft().result()
                while pending:
                    yield pending.popleft().result()
            finally:
                for f in pending:
                    f.cancel()

    return gen()
