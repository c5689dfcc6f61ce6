"""Observability: device memory polling, profiler traces, stage timing.

Twin of music_generation_tpu/utils/observability.py, on the CUDA
allocator's statistics and torch.profiler where the JAX one reads jax
device memory_stats() and writes jax.profiler traces.
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

import torch


def device_memory_stats() -> list[dict]:
    """One dict per CUDA device: bytes_in_use and peak_bytes_in_use (the
    caching allocator's allocated bytes, torch.cuda.memory_stats),
    bytes_reserved, and bytes_limit (the card's total memory,
    torch.cuda.mem_get_info). Without a GPU, one entry holding only
    device="cpu"."""
    if not torch.cuda.is_available():
        return [{"device": "cpu"}]
    out = []
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        _, total = torch.cuda.mem_get_info(i)
        out.append({"device": f"cuda:{i}",
                    "bytes_in_use": stats.get("allocated_bytes.all.current",
                                              0),
                    "peak_bytes_in_use": stats.get(
                        "allocated_bytes.all.peak", 0),
                    "bytes_reserved": stats.get("reserved_bytes.all.current",
                                                0),
                    "bytes_limit": total})
    return out


class DeviceStatsPoller:
    """A background thread that logs each device's memory in use every
    ``interval_s`` seconds until stop()."""

    def __init__(self, interval_s: float = 60.0,
                 logger: Optional[logging.Logger] = None):
        self.interval_s = interval_s
        self.logger = logger or logging.getLogger("device_stats")
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def poll(self) -> None:
        for s in device_memory_stats():
            used, limit = s.get("bytes_in_use"), s.get("bytes_limit")
            if used is not None:
                pct = f" ({100 * used / limit:.1f}%)" if limit else ""
                self.logger.info("%s: %.1f MiB in use%s", s["device"],
                                 used / 2 ** 20, pct)

    def start(self) -> "DeviceStatsPoller":
        def loop():
            while not self._stop.wait(self.interval_s):
                self.poll()
        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """torch.profiler over the block, on every thread of the process (a
    server's requests run on its handler threads) and on the device when a
    GPU is present; a Chrome trace is written into ``log_dir`` on exit.
    Yields the trace file's path."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    path = os.path.join(log_dir, time.strftime("trace_%Y%m%d_%H%M%S.json"))
    with profile(activities=activities, experimental_config=
                 _ExperimentalConfig(profile_all_threads=True)) as prof:
        yield path
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(path)


@dataclass
class StageTimer:
    """Per-stage wall-clock accounting for the serving pipeline."""
    stages: dict = field(default_factory=dict)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.time()
        try:
            yield
        finally:
            self.stages.setdefault(name, []).append(time.time() - t0)

    def summary(self) -> dict:
        return {k: {"count": len(v), "total_s": round(sum(v), 4),
                    "mean_s": round(sum(v) / len(v), 4)}
                for k, v in self.stages.items() if v}
