"""Random draws of the training step, at the global batch's shape.

The JAX trainer draws its noise (dropout masks, the posterior and
reverse-KL noise, the slice starts, the discriminator's instance noise) at
the shape of the global batch array and lets XLA shard it. A data-parallel
rank of the port holds only its own rows, so inside ``global_rows(n, r)``
every draw here is taken at n times its leading (batch) axis from the
shared generator and rank r keeps its own block of rows: the values the
one-process step on the concatenated batch draws for those rows. Outside
it (one device) a draw is the plain torch call.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch

_ROWS = threading.local()


@contextlib.contextmanager
def global_rows(n_ranks: int, rank: int):
    """Draw at ``n_ranks`` x the leading axis and keep block ``rank``
    (this thread only)."""
    prev = getattr(_ROWS, "split", None)
    _ROWS.split = (n_ranks, rank)
    try:
        yield
    finally:
        _ROWS.split = prev


def _draw(fn, shape, generator, device, dtype):
    split = getattr(_ROWS, "split", None)
    if split is None or split[0] == 1:
        return fn(shape, generator=generator, device=device, dtype=dtype)
    n, r = split
    b = shape[0]
    full = fn((n * b, *shape[1:]), generator=generator, device=device,
              dtype=dtype)
    # a copy, so that what autograd saves of a draw is this rank's rows
    return full[r * b: (r + 1) * b].clone()


def randn(shape, generator: Optional[torch.Generator] = None, device=None,
          dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """torch.randn(shape), or this rank's rows of the global draw."""
    return _draw(torch.randn, tuple(shape), generator, device, dtype)


def rand(shape, generator: Optional[torch.Generator] = None, device=None,
         dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """torch.rand(shape), or this rank's rows of the global draw."""
    return _draw(torch.rand, tuple(shape), generator, device, dtype)
