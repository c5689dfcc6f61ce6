"""Bytes one monotonic-alignment search needs, the bound of its roofline.

The kernel computes a one-hot path over a [frames, phones] score per item.
What the inputs need: each item's score over its own frames x phones
(float32), the mask's first column and row that give its lengths, and the
whole padded path written once. The search is a chain of dependent rows,
not a volume of operations, so the bound is by bytes.
"""

from __future__ import annotations

from .peaks import HBM_BYTES_PER_S


def bytes_needed(items, pad_frames: int, pad_phones: int) -> int:
    """``items``: each item's (phones, frames)."""
    score = sum(f * n for n, f in items)
    lengths = len(items) * (pad_frames + pad_phones)
    path = len(items) * pad_frames * pad_phones
    return 4 * (score + lengths + path)


def bound_s(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S
