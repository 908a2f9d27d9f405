"""Kernel A's share of its roofline: the least time of the window's CTU
passes by their counted bytes (``work.advect_bytes`` at 3.35 TB/s) over
kernel A's profiled device time; not measured where the profiler's
count of kernel A, the port's launch counter and the counted passes
disagree."""

from wavebench import work


def read(ctx):
    if ctx["trace"] is None or not ctx["complete"]:
        return None
    us, n = ctx["kernels"]["advect"]
    if n != work.expected_launches(ctx)["advect"] or us <= 0:
        return None
    return 100.0 * work.bound_total(work.window_work(ctx)["advect"]) / (
        us * 1e-6)
