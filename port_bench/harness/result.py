"""The run's last line, the checks beside their limits, the import check."""

from __future__ import annotations

import json
import math
import sys
from pathlib import Path

# top-level module names no process of the benchmark may hold: JAX, its
# libraries and the JAX package the port was made from
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "optax", "orbax",
                       "music_generation_tpu"})
LIMITS = Path(__file__).resolve().parents[1] / "limits"


def forbidden_modules(modules=None) -> list:
    """Top-level names in ``sys.modules`` (whole, before the first dot)
    that are forbidden."""
    names = {m.split(".", 1)[0] for m in (modules or sys.modules)}
    return sorted(names & FORBIDDEN)


def load_limits(cell: str) -> dict:
    """``limits/<cell>.json``: {number: {"limit": x, ...}}."""
    with open(LIMITS / f"{cell}.json", encoding="utf-8") as f:
        return json.load(f)["limits"]


def judge(values: dict, limits: dict) -> tuple:
    """(correct, checks): every number at or under its limit; a missing or
    non-finite number fails. ``checks`` is {name: {"value", "limit"}} in
    the limits' order."""
    checks, ok = {}, True
    for name, spec in limits.items():
        v = values.get(name)
        limit = spec["limit"]
        good = v is not None and v == v and v <= limit
        ok = ok and good
        checks[name] = {"value": (float(v) if good or (
                            v is not None and math.isfinite(v)) else None),
                        "limit": limit}
    return ok, checks


def device_info(memory_peak_bytes: int, trace=None) -> dict:
    """The card's name, the count used, the window's peak (read by the
    driver when the window closed) and, traced, the device's busy seconds
    and the traced window's length."""
    import torch
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1, "memory_peak_bytes": int(memory_peak_bytes)}
    if trace is not None:
        info["busy_s"] = trace.busy_s
        info["window_s"] = trace.window_s
    return info


def emit(*, correct: bool, attempted: int, failed: int, metrics: dict,
         device: dict, checks: dict, breakdown=None) -> None:
    """Print the checks as the last lines of standard error, then the
    result as the last line of standard output (its ``checks`` key last)."""
    line = {"correct": bool(correct), "attempted": int(attempted),
            "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = checks
    sys.stdout.flush()
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
