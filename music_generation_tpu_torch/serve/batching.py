"""Cross-request SVS micro-batching for the serving tier.

The reference runs threaded Flask over global CUDA models with no locking —
concurrent requests race (SURVEY.md §5, controllers threaded=True).
Serializing whole requests behind one lock is safe but leaves the device
idle while requests queue.

This module replaces request-level serialization with stage-level batching:
the (fast, stateful) melody stage stays serialized, while the SVS stage —
already a single batched device program per request — is routed through a
coalescing worker that merges sentences from ALL in-flight requests into one
`synthesize_batch` call per synthesizer. Under load, N concurrent requests
cost one device round trip instead of N; the batch rides the same shape
buckets.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional


class _Pending:
    __slots__ = ("svs", "scores", "event", "result", "error")

    def __init__(self, svs, scores):
        self.svs = svs
        self.scores = scores
        self.event = threading.Event()
        self.result: Optional[list] = None
        self.error: Optional[BaseException] = None


class SVSBatcher:
    """Coalesces concurrent `synthesize_batch` calls.

    ``submit(svs, scores)`` blocks the calling request thread until its
    waveforms are ready. A single worker thread drains the queue: it waits
    ``window_ms`` after the first pending arrival to let concurrent requests
    coalesce, groups by synthesizer instance (different singer_ids use
    different parameter sets and cannot share a call), then issues one
    batched device program per group of up to ``max_sentences``.
    """

    def __init__(self, window_ms: float = 0.0, max_sentences: int = 16):
        self.window_s = window_ms / 1000.0
        self.max_sentences = max_sentences
        self._pending: List[_Pending] = []
        self._cv = threading.Condition()
        self._closed = False
        # observability counters (surfaced via the service /healthz)
        self.stats = {"device_calls": 0, "sentences": 0, "requests": 0,
                      "max_batch": 0}
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def submit(self, svs, scores: list) -> list:
        """Blocking: returns per-score int16 waveforms (synthesize_batch
        contract)."""
        if not scores:
            return []
        item = _Pending(svs, scores)
        with self._cv:
            if self._closed:
                raise RuntimeError("batcher closed")
            self._pending.append(item)
            self._cv.notify()
        item.event.wait()
        if item.error is not None:
            raise item.error
        return item.result

    def fn_for(self, svs) -> Callable[[list], list]:
        """An `svs_batch_fn(scores) -> wavs` bound to one synthesizer."""
        return lambda scores: self.submit(svs, scores)

    def _run(self):
        while True:
            with self._cv:
                while not self._pending and not self._closed:
                    self._cv.wait()
                if self._closed and not self._pending:
                    return
            # collection window: let concurrently-arriving requests coalesce
            if self.window_s > 0:
                ev = threading.Event()
                ev.wait(self.window_s)
            with self._cv:
                batch, self._pending = self._pending, []
            groups: Dict[int, List[_Pending]] = {}
            for item in batch:
                groups.setdefault(id(item.svs), []).append(item)
            for items in groups.values():
                self._execute(items)

    def _execute(self, items: List[_Pending]) -> None:
        """Flatten all pending scores, run device calls of at most
        max_sentences (splitting WITHIN a request too — a single 500-char
        request can carry ~30 sentences, and the cap bounds the vocoder's
        activation memory), then reassemble per-request results."""
        svs = items[0].svs
        flat = [s for item in items for s in item.scores]
        wavs: List = []
        err: Optional[BaseException] = None
        self.stats["requests"] += len(items)
        for k in range(0, len(flat), self.max_sentences):
            chunk = flat[k: k + self.max_sentences]
            self.stats["device_calls"] += 1
            self.stats["sentences"] += len(chunk)
            self.stats["max_batch"] = max(self.stats["max_batch"], len(chunk))
            try:
                wavs.extend(svs.synthesize_batch(chunk))
            except BaseException as e:
                err = e
                break
        off = 0
        for item in items:
            n = len(item.scores)
            # a request whose sentences all completed in earlier successful
            # chunks still gets its result even if a LATER chunk errored —
            # one bad request must not fail already-computed peers
            if off + n <= len(wavs):
                item.result = wavs[off: off + n]
            else:
                item.error = err or RuntimeError("batch underrun")
            off += n
            item.event.set()

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify()
        self._worker.join(timeout=5.0)
