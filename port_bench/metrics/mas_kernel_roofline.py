"""The MAS kernel's share of its roofline: the least time the bytes the
window's steps need take at the card's bandwidth (``counts/mas.py``: one
alignment of each item a step) over the device time of every MAS kernel
in the traced window, however many launches the program makes."""

from port_bench.counts.mas import bound_s


def read(ctx):
    t = ctx.trace
    nbytes = ctx.counts.get("mas_bytes")
    if t is None or not nbytes:
        return None
    # "(anonymous namespace)::mas_kernel<2>(...)", "...mas_wide_kernel..."
    busy = sum(o.dur_ns for o in t.ops if "mas_kernel" in o.name
               or "mas_wide_kernel" in o.name) / 1e9
    return 100.0 * bound_s(nbytes) / busy if busy > 0 else None
