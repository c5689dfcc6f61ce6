"""The window's share of the card's float32 peak: the operations its
scores need at their own lengths (``counts/svs.py`` on the reference) over
the traced window's wall seconds, against 67 TFLOP/s."""

from port_bench.counts.peaks import FLOAT32_FLOPS


def read(ctx):
    flops = ctx.counts.get("flops")
    if ctx.trace is None or not flops or ctx.window_s <= 0:
        return None
    return 100.0 * flops / ctx.window_s / FLOAT32_FLOPS
