"""Background batch prefetcher: overlap host batch assembly and the
host-to-device copy with the device step.

Twin of music_generation_tpu/runtime/prefetch.py. ``transfer`` (for the
trainer, train.data.to_device: pinned memory, then a non-blocking copy)
runs on the producer thread.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Optional


class Prefetcher:
    """Iterator over ``make_batch(step)`` results for steps [0, n_steps),
    produced ``depth`` ahead on a daemon thread. Producer exceptions
    re-raise in the consumer at the failed step."""

    def __init__(self, make_batch: Callable[[int], dict], n_steps: int,
                 depth: int = 2,
                 transfer: Optional[Callable[[dict], dict]] = None):
        self._q: queue.Queue = queue.Queue(maxsize=max(depth, 1))
        self._n = n_steps
        self._stop = threading.Event()

        def _produce():
            for step in range(n_steps):
                if self._stop.is_set():
                    return
                try:
                    batch = make_batch(step)
                    if transfer is not None:
                        batch = transfer(batch)
                except BaseException as e:  # surfaced by the consumer
                    self._put((step, None, e))
                    return
                self._put((step, batch, None))

        self._thread = threading.Thread(target=_produce, daemon=True)
        self._thread.start()

    def _put(self, item) -> None:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def __iter__(self):
        for _ in range(self._n):
            step, batch, err = self._q.get()
            if err is not None:
                raise err
            yield step, batch

    def close(self) -> None:
        self._stop.set()
        try:  # drain so a blocked producer can observe the stop flag
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
