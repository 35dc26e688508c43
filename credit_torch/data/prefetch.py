"""Background-thread batch prefetch: the port's copy of
credit_tpu/data/prefetch.py.

ONE producer thread runs the host-side batch assembly (zarr chunk gather
and inflate, channel stacking, pinning) while the main thread launches the
device steps; the reference hides input latency with torch DataLoader
worker processes instead (reference: credit/datasets/
load_dataset_and_dataloader.py num_workers). zlib's inflate and numpy's
copies release the GIL, so the producer overlaps the step's launches.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, TypeVar

T = TypeVar("T")
_DONE = object()


class Prefetcher(Iterator[T]):
    """Iterate `fn(item)` for item in `items`, computed `depth` ahead on a
    background thread. Exceptions re-raise at the consuming site; breaking
    out early (or close()) stops the producer promptly."""

    def __init__(self, items: Iterable, fn: Callable[..., T], depth: int = 2):
        assert depth >= 1, depth
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._err = None

        def produce():
            try:
                for it in items:
                    if self._stop.is_set():
                        return
                    out = fn(it)
                    while not self._stop.is_set():
                        try:
                            self._q.put(out, timeout=0.1)
                            break
                        except queue.Full:
                            continue
            except BaseException as e:  # surfaced on the consumer side
                self._err = e
            finally:
                while not self._stop.is_set():
                    try:
                        self._q.put(_DONE, timeout=0.1)
                        break
                    except queue.Full:
                        continue

        self._thread = threading.Thread(target=produce, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self) -> T:
        out = self._q.get()
        if out is _DONE:
            self._thread.join()
            if self._err is not None:
                raise self._err
            raise StopIteration
        return out

    def close(self):
        self._stop.set()
        # drain so a blocked producer put() can observe the stop flag
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
