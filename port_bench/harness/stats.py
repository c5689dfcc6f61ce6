"""Statistics the end-to-end metrics are made of."""

from __future__ import annotations


def rate(work: float, seconds: float) -> float:
    """All the work of a window over all of its wall seconds."""
    if seconds <= 0:
        raise ValueError("a window of no length")
    return work / seconds
