#!/usr/bin/env python3
"""Time the port's full-width GAN training step on one GPU under host-side
variants, and run controls of chip_smoke.py's card-vs-CPU gradient check.

    python3 tools/torch_train_step_timing.py [--earlier-phases]
        [--sync-points] [--grad-controls] [--out FILE]

The step is chip_smoke.py's train phase: SVSConfig(), the full
MultiPeriodDiscriminator, B=8, 64 phones, 480 frames, --durations mas,
TF32 off. After one cold step, five warm steps are timed (host clock
between two torch.cuda.synchronize()) under each variant in turn:
  default     as chip_smoke.py runs it;
  gc_frozen   gc.collect(), gc.freeze(), gc.disable() around the steps;
  one_thread  torch.set_num_threads(1) around the steps;
then one step under torch.profiler (chip_smoke.profiled), then the three
variants again. Each step records its wall ms, the process's CPU ms (all
threads) and the main thread's CPU ms.

--earlier-phases first runs chip_smoke.py's phases 2-6 (kernel, align,
serve, card vs CPU, lyrics) in the same process, as chip_smoke.py does
before its train phase.

--sync-points runs one more step with torch.cuda.set_sync_debug_mode
("warn") and counts the calls that made the host wait for the card, by
the line of the port that made them.

--grad-controls runs chip_smoke.train_loss_and_grads with two controls
beside the float32 card: TF32 on for matmuls and cuDNN (whole step), and
the generator forward under bf16 autocast (outputs cast back to float32).
Each is judged by chip_smoke.judge_train_step: which loss terms and
gradient tensors fail chip_smoke.py's limits.

Prints the card's name and power limit, then one JSON object (also
written to --out). Exits non-zero without a GPU.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import gc
import json
import os
import subprocess
import sys
import threading
import time
import warnings
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402

STEPS = 5
VARIANTS = ("default", "gc_frozen", "one_thread")


@contextlib.contextmanager
def variant(name: str):
    if name == "gc_frozen":
        gc.collect()
        gc.freeze()
        gc.disable()
        try:
            yield
        finally:
            gc.enable()
            gc.unfreeze()
    elif name == "one_thread":
        n = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            yield
        finally:
            torch.set_num_threads(n)
    else:
        yield


def host_state() -> dict:
    with open("/proc/self/status") as fh:
        os_threads = next(int(line.split()[1]) for line in fh
                          if line.startswith("Threads:"))
    return {"python_threads": threading.active_count(),
            "os_threads": os_threads, "gc_objects": len(gc.get_objects()),
            "torch_threads": torch.get_num_threads()}


def timed_steps(step, states, batches, generator) -> dict:
    rows = []
    for i in range(STEPS):
        torch.cuda.synchronize()
        t0, c0, m0 = time.perf_counter(), time.process_time(), \
            time.thread_time()
        metrics = step(*states, batches[i % len(batches)], generator)
        torch.cuda.synchronize()
        rows.append({"ms": (time.perf_counter() - t0) * 1e3,
                     "process_cpu_ms": (time.process_time() - c0) * 1e3,
                     "main_thread_cpu_ms": (time.thread_time() - m0) * 1e3})
        if not all(np.isfinite(float(v)) for v in metrics.values()):
            raise AssertionError(f"non-finite metrics: {metrics}")
    return {k: float(np.median([r[k] for r in rows])) for k in rows[0]} | {
        "ms_all": [r["ms"] for r in rows]}


def sync_points(step, states, batch, generator) -> dict:
    """Host waits for the card in one step, by the caller's file:line."""
    torch.cuda.synchronize()
    root = Path(__file__).resolve().parents[1]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            step(*states, batch, generator)
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    where = collections.Counter(
        f"{os.path.relpath(w.filename, root)}:{w.lineno}" for w in caught
        if "synchroniz" in str(w.message))
    return {"n": sum(where.values()), "by_line": dict(where.most_common())}


def time_variants(device, count_syncs: bool = False) -> dict:
    from music_generation_tpu_torch.models.svs import SVSConfig
    from music_generation_tpu_torch.train import (TrainConfig, create_states,
                                                  make_train_step,
                                                  synthetic_batch, to_device,
                                                  tool_shapes)
    cfg = SVSConfig()
    tc = TrainConfig(use_mas=True, warmup_steps=0)
    phones, frames = tool_shapes(False)
    states = create_states(cfg, tc, device)
    step = make_train_step(cfg, tc)
    generator = torch.Generator(device).manual_seed(chip_smoke.SEED)
    batches = [to_device(synthetic_batch(cfg, batch=chip_smoke.TRAIN_BATCH,
                                         t_phones=phones, t_frames=frames,
                                         seed=i), device)
               for i in range(3)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(*states, batches[0], generator)
    torch.cuda.synchronize()
    out = {"cold_ms": (time.perf_counter() - t0) * 1e3,
           "host_before": host_state(), "runs": []}
    for when in ("before_profiler", "after_profiler"):
        if when == "after_profiler":
            prof = chip_smoke.profiled(
                lambda: step(*states, batches[0], generator))
            out["profile"] = {k: prof[k] for k in (
                "profiled_s", "device_busy_s", "device_busy_share",
                "kernel_launches")}
        for name in VARIANTS:
            with variant(name):
                row = timed_steps(step, states, batches, generator)
            out["runs"].append({"when": when, "variant": name} | row)
            chip_smoke.log(f"{when} {name}: {row['ms']:.1f} ms per step, "
                           f"process CPU {row['process_cpu_ms']:.1f} ms, "
                           f"main thread CPU "
                           f"{row['main_thread_cpu_ms']:.1f} ms")
    out["host_after"] = host_state()
    if count_syncs:
        out["sync_points"] = sync_points(step, states, batches[0], generator)
        chip_smoke.log(f"sync points per step: {out['sync_points']}")
    del states, batches
    torch.cuda.empty_cache()
    return out


class WholeTF32:
    """TF32 on for matmuls and cuDNN convolutions, around the whole
    forward, loss and backward."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved


def grad_controls(device) -> dict:
    results = chip_smoke.train_loss_and_grads(device, controls={
        "tf32": (WholeTF32, True),
        "bf16_forward": (lambda: torch.autocast("cuda", torch.bfloat16),
                         False)})
    out = {}
    for tag in ("card", "card_tf32", "card_bf16_forward"):
        rep = chip_smoke.judge_train_step(results, tag)
        worst_loss = max(rep["loss_rel"], key=rep["loss_rel"].get)
        out[tag] = {
            "worst_loss_term": worst_loss,
            "worst_loss_rel": rep["loss_rel"][worst_loss],
            "losses_failed": rep["losses_failed"],
            "grad_worst_rel_l2": rep["grad_worst_rel_l2"],
            "n_grad_tensors": rep["n_grad_tensors"],
            "n_grads_failed": len(rep["grads_failed"]),
            "grads_failed_first": [name for name, _ in
                                   rep["grads_failed"][:8]]}
        chip_smoke.log(f"{tag}: worst loss term {worst_loss} "
                       f"{rep['loss_rel'][worst_loss]:.3e}, "
                       f"{len(rep['losses_failed'])} loss terms and "
                       f"{len(rep['grads_failed'])} of "
                       f"{rep['n_grad_tensors']} gradients fail")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--earlier-phases", action="store_true")
    ap.add_argument("--sync-points", action="store_true")
    ap.add_argument("--grad-controls", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_train_step_timing: no CUDA device", file=sys.stderr)
        return 1
    from music_generation_tpu_torch.ops import build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    chip_smoke.log(card)
    build.build_all()
    result = {"card": card, "torch": torch.__version__,
              "cpu_count": os.cpu_count(),
              "earlier_phases": args.earlier_phases}
    if args.earlier_phases:
        t0 = time.time()
        chip_smoke.phases_before_train(device)
        result["earlier_phases_s"] = time.time() - t0
    result["timing"] = time_variants(device, args.sync_points)
    if args.grad_controls:
        result["grad_controls"] = grad_controls(device)
    line = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
