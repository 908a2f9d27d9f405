"""Kernel B's share of its roofline in minimal mode: the least time of
the window's minimal physics steps by their counted operations
(``work.implsch_ops`` at 67 TFLOP/s float32) over kernel B's minimal
device time; not measured where the profiler's count, the port's launch
counter and the counted steps disagree."""

from wavebench import work


def read(ctx):
    if ctx["trace"] is None or not ctx["complete"]:
        return None
    us, n = ctx["kernels"]["implsch"]
    if n != work.expected_launches(ctx)["implsch"] or us <= 0:
        return None
    return 100.0 * work.bound_total(work.window_work(ctx)["implsch"]) / (
        us * 1e-6)
