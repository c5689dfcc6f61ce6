"""Readings that set a cell's limits: the program and its controls.

    python -m port_bench.control --workload <cell> --seeds 1 2 3 \
        [--seconds 8] [--program-only] [--out chiprun_out/control.jsonl]

In one process, for each seed: a short window of the cell at its own
load, then the numbers the cell compares, for the program (the lower
readings) and, unless ``--program-only``, for its controls (the upper
readings): the plain reference computed with TF32 in the program's place
and, for a training cell, the reference with half of each batch left
out. One JSON line per seed. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--program-only", action="store_true")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    from port_bench.run import set_cache_dirs
    set_cache_dirs()
    from port_bench.harness import spec
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    driver = spec.driver(cell.traffic["driver"])
    for seed in args.seeds:
        t0 = time.time()
        out = driver.run(cell, seed=seed, seconds=args.seconds, trace=False,
                         t_start=t0, control=not args.program_only)
        line = json.dumps({"cell": cell.name, "seed": seed,
                           "program": out["values"],
                           "controls": out["controls"],
                           "seconds": time.time() - t0})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a", encoding="utf-8") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
