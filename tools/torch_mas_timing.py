#!/usr/bin/env python3
"""Time the port's MAS kernel (music_generation_tpu_torch maximum_path) on
one GPU and show what bounds it.

    python3 tools/torch_mas_timing.py

Prints the card's name and power limit, then one JSON object:
  - wrapper_ms: maximum_path() at the training shape [8, 480, 64];
  - kernel_ms: the bare ctypes launch on the same inputs (no Python checks
    or allocation), 10 back-to-back launches per timing;
  - profiler_kernel_us: the kernel's device time from torch.profiler;
  - ty_sweep / batch_sweep: wrapper_ms as the row chain (Ty) and the batch
    grow, and us_per_row, the slope over the Ty sweep: the cost of one link
    of the dependent row chain.
CUDA-event times are medians of 20 warm runs. Exits non-zero without a GPU.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402

TY_SWEEP = (120, 480, 960, 1920)
BATCH_SWEEP = (2, 8, 64)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_mas_timing: no CUDA device", file=sys.stderr)
        return 1
    from music_generation_tpu_torch.ops import build, maximum_path
    from music_generation_tpu_torch.ops import monotonic_align as mas
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    build.build_all()
    dev = torch.device("cuda", 0)
    shape = chip_smoke.MAS_SHAPE
    neg_cent, mask, _ = chip_smoke.mas_case(dev)
    path = torch.empty_like(neg_cent)
    fn = mas._Kernel.get()
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launches():
        for _ in range(10):
            fn(neg_cent.data_ptr(), mask.data_ptr(), path.data_ptr(),
               *shape, stream)

    out = {"shape": list(shape),
           "wrapper_ms": chip_smoke.cuda_ms(
               lambda: maximum_path(neg_cent, mask)),
           "kernel_ms": chip_smoke.cuda_ms(launches) / 10}
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        launches()
        torch.cuda.synchronize()
    device_us = [getattr(e, "device_time", getattr(e, "cuda_time", None))
                 for e in prof.key_averages()
                 if "mas_kernel" in e.key]
    out["profiler_kernel_us"] = device_us[0] if device_us else None

    def sweep(shapes):
        rows = []
        for s in shapes:
            nc, m, _ = chip_smoke.mas_case(dev, s, chip_smoke.SEED + 1)
            rows.append({"shape": list(s), "wrapper_ms": chip_smoke.cuda_ms(
                lambda: maximum_path(nc, m))})
        return rows

    out["ty_sweep"] = sweep([(shape[0], ty, shape[2]) for ty in TY_SWEEP])
    out["batch_sweep"] = sweep([(b, shape[1], shape[2])
                                for b in BATCH_SWEEP])
    ms = [r["wrapper_ms"] for r in out["ty_sweep"]]
    out["us_per_row"] = float(np.polyfit(TY_SWEEP, ms, 1)[0] * 1e3)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
