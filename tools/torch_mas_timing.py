#!/usr/bin/env python3
"""Time the port's MAS kernel (music_generation_tpu_torch maximum_path) on
one GPU and show what bounds it.

    python3 tools/torch_mas_timing.py [--shape B,TY,TX ...]

With --shape (repeatable), for each shape, on chip_smoke.py's ragged
inputs (long_case): the variant maximum_path picks (mas_plan) and
wrapper_ms, maximum_path() itself; then each variant alone (the warp
variant where its shared memory takes the shape, the wide variant always,
and with --k-sweep the wide variant at every K from 1 to 32, each with the
warps its row needs, up to 8): bare_ms, its ctypes launch on buffers
allocated once, 10 back-to-back launches per timing; and whether every
variant's path is the same.

Without --shape, prints the card's name and power limit, then one JSON
object:
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

import argparse
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


def shape_arg(text: str) -> tuple:
    shape = tuple(int(v) for v in text.split(","))
    if len(shape) != 3 or min(shape) < 1:
        raise argparse.ArgumentTypeError(f"B,TY,TX expected, got {text!r}")
    return shape


def time_shapes(dev, shapes, k_sweep: bool = False) -> list:
    """Each shape's wrapper time and each variant's bare launch time."""
    from music_generation_tpu_torch.ops import mas_plan, maximum_path
    from music_generation_tpu_torch.ops import monotonic_align as mas
    stream = torch.cuda.current_stream(dev).cuda_stream
    rows = []
    for shape in shapes:
        b, t_y, t_x = shape
        neg_cent, mask, lengths = chip_smoke.long_case(dev, shape,
                                                       chip_smoke.SEED + 5)
        plan = mas_plan(t_y, t_x)
        row = {"shape": list(shape), "lengths": lengths[:4],
               "variant": plan.variant, "wrapper_ms": chip_smoke.cuda_ms(
                   lambda: maximum_path(neg_cent, mask), reps=10),
               "variants": {}}
        plans = {p.variant: p for p in (mas_plan(t_y, t_x),
                                        mas.wide_plan(t_y, t_x))}
        if k_sweep:
            plans.update({f"wide_k{k}": mas.wide_plan(t_y, t_x, k)
                          for k in (1, 2, 4, 8, 16, 32)
                          if 32 * k * mas.MAX_WARPS >= min(t_x, 8192)})
        paths = {}
        for name, vplan in plans.items():
            path = torch.empty_like(neg_cent)
            args = [neg_cent.data_ptr(), mask.data_ptr(), path.data_ptr(), b,
                    t_y, t_x]
            if vplan.variant == "wide":
                scratch = torch.empty(b * vplan.scratch_bytes // 4,
                                      dtype=torch.int32, device=dev)
                fn = mas._Kernel.wide()
                args += [vplan.k, vplan.warps, scratch.data_ptr()]
            else:
                fn = mas._Kernel.get()

            def launches(fn=fn, args=args):
                for _ in range(10):
                    if fn(*args, stream):
                        raise RuntimeError(f"launch failed at {shape}")
            row["variants"][name] = {
                "k": vplan.k, "warps": vplan.warps, "strips": vplan.strips,
                "smem_bytes": vplan.smem_bytes,
                "scratch_bytes": b * vplan.scratch_bytes,
                "bare_ms": chip_smoke.cuda_ms(launches, reps=5) / 10}
            paths[name] = path
        first = next(iter(paths.values()))
        row["variants_equal"] = all(torch.equal(first, other)
                                    for other in paths.values())
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--shape", type=shape_arg, action="append",
                   metavar="B,TY,TX", help="time each variant at this shape "
                   "(repeatable)")
    p.add_argument("--k-sweep", action="store_true",
                   help="with --shape: also the wide variant at K = 1..32")
    args = p.parse_args(argv)
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
    if args.shape:
        time_shapes(dev, args.shape, args.k_sweep)
        return 0
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
