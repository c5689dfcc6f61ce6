"""Device kernels launched per GAN step in the traced window (copies and
sets left out)."""


def read(ctx):
    t, steps = ctx.trace, ctx.counters.get("steps", 0)
    if t is None or not steps:
        return None
    kernels = [o for o in t.ops
               if not o.name.startswith(("Memcpy", "Memset"))]
    return len(kernels) / steps if kernels else None
