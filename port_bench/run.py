"""Run one cell of ``BENCHMARK.json`` once and print one JSON line.

    python -m port_bench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell's driver builds the program (``music_generation_tpu_torch``),
hands it weights made on the card from the seed, warms up the cell's own
shapes, measures for ``--seconds``, then compares what the timed path
produced with the plain reference (``port_bench/reference``). With
``--trace 0`` the line carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read from a profiled window. It exits
non-zero and prints no result without a CUDA device (or with fewer than
the cell asks for), without the program, or when the process holds a
module of JAX or of the JAX package once the window has closed.
"""

from __future__ import annotations

import time

T_IMPORT = time.time()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parents[1]


def process_start() -> float:
    """The wall-clock time this process was started (from /proc), else the
    time this module was imported."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return min(time.time() - uptime + started, T_IMPORT)
    except (OSError, ValueError, IndexError):
        return T_IMPORT


def set_cache_dirs() -> None:
    """Kernel and extension caches at fixed paths inside the checkout, so
    that only a checkout's first run builds them; keep libraries the
    program may import from loading JAX."""
    cache = CHECKOUT / "build" / "port_bench"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")


def main(argv=None) -> int:
    t0 = process_start()
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    set_cache_dirs()

    from port_bench.harness import result, spec
    cell = spec.load_cell(args.workload)
    import torch
    # one process, few threads: the host work is the program's launches
    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA devices, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    out = spec.driver(cell.traffic["driver"]).run(
        cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
        t_start=t0)
    bad = result.forbidden_modules()
    if bad:
        print(f"the process holds forbidden modules: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    return report(cell, out, bool(args.trace))


def report(cell, out: dict, trace: bool) -> int:
    from port_bench.harness import result, spec
    correct, checks = result.judge(out["values"],
                                   result.load_limits(cell.name))
    metrics = {}
    if trace:
        ctx = out["ctx"]
        for m in cell.per_layer:
            v = spec.metric_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": float(out["end_to_end"][m["name"]]),
                                  "unit": m["unit"]}
    tr = out.get("trace")
    result.emit(correct=correct, attempted=out["attempted"],
                failed=out["failed"], metrics=metrics,
                device=result.device_info(out["memory_peak_bytes"],
                                          tr if trace else None),
                checks=checks,
                breakdown=tr.breakdown() if (trace and tr) else None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
