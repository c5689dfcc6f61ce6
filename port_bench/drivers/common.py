"""What the drivers share: precision, configurations, the metrics' context."""

from __future__ import annotations

import dataclasses
import gc
from typing import Optional

import torch


def float32_only() -> None:
    """The port's parity precision: float32 with TF32 off, in cuBLAS and
    cuDNN alike."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def tf32_on() -> None:
    """The control's precision: float32 storage, TF32 matrix products and
    convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("high")


def sizes(config: dict, tiny: bool) -> dict:
    """The configuration's model sizes: the file's, or its ``tiny`` block
    (CPU tests of the harness only)."""
    return config["tiny"] if tiny else config


def weights_seed(cell, seed: int) -> int:
    """The seed the weights are made from: the configuration's
    ``weights_seed`` where it states one (its model's work depends on the
    weights, as the length of every sung note does), else the run's."""
    return cell.config.get("weights_seed", seed)


def as_config(cls, values: dict):
    """A config dataclass from a JSON dict (lists become tuples)."""
    def tup(v):
        return tuple(tup(x) for x in v) if isinstance(v, list) else v
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: tup(v) for k, v in values.items() if k in names})


def same_config(program_cfg, values: dict, what: str) -> None:
    """Refuse to run when the program built other sizes than the file
    states."""
    got = dataclasses.asdict(program_cfg)
    for k, v in values.items():
        g = got.get(k)
        if isinstance(g, tuple):
            g = _listify(g)
        if g != v:
            raise RuntimeError(f"{what}.{k}: the program built {g!r}, the "
                               f"configuration states {v!r}")


def _listify(v):
    return [_listify(x) for x in v] if isinstance(v, (list, tuple)) else v


@dataclasses.dataclass
class Ctx:
    """What a per-layer metric's reader may read: the trace of the
    window (None where the run was not traced), the harness's spans and
    counters, the window's length and the cell's counts."""
    trace: Optional[object]
    window_s: float
    spans: dict
    counters: dict
    counts: dict


def free_device() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def rel_gap(observed: torch.Tensor, reference: torch.Tensor) -> float:
    """max |observed - reference| / max |reference| (0 over 0 is 0)."""
    o, r = observed.double(), reference.double()
    if o.shape != r.shape:
        return float("inf")
    den = r.abs().max().item() if r.numel() else 0.0
    num = (o - r).abs().max().item() if r.numel() else 0.0
    if den == 0.0:
        return 0.0 if num == 0.0 else float("inf")
    return num / den
