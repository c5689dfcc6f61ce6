"""Share of the device's busy time spent in the vocoder: the device time
of the work launched inside the harness's ``port_bench.decode_hidden``
range (around ``VISinger.decode_hidden``) over all device time."""


def read(ctx):
    t = ctx.trace
    if t is None or t.busy_s <= 0:
        return None
    dec = t.device_s_in("port_bench.decode_hidden")
    if not dec:
        return None
    total = sum(o.dur_ns for o in t.ops) / 1e9
    return 100.0 * dec / total
