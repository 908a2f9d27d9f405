"""Device ms a step of work outside kernels A and B, launched by the
window's forcing swaps and steps (``newwind``, ``advance``: the wrap
refresh, the forcing and stress rows, the CFL retry's masks), from the
profiler; not measured where its kernel counts disagree with the
port's launch counters."""

LAYER_SPANS = ("newwind", "advance")


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not ctx["complete"] or not ctx["window"]["steps"]:
        return None
    kernels = ctx["kernel_match"]
    us = sum(o.dur for o in tr.ops if o.span in LAYER_SPANS
             and not kernels(o.name))
    return us / ctx["window"]["steps"] * 1e-3
