"""The device's idle share of the traced window: 1 − the union of its
operations' intervals over the window's length; not measured where the
profiler dropped kernel launches."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not ctx["complete"]:
        return None
    w = tr.window[1] - tr.window[0]
    return 100.0 * (1.0 - tr.busy_us() / w)
