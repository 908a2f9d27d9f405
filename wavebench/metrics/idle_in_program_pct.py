"""The device's idle time inside the port's spans, as a share of the
traced window: the idle stretches of the device (the window less the
union of its operations) that lie inside the union of the port's
top-level span intervals (``ecwam_tpu_torch.tracing.report()``, host
time on the profiler's clock), over the window's length.  None where the
port records no spans (a tree without ``ecwam_tpu_torch.tracing``) or
the profiler dropped kernel launches."""


def _union(iv):
    out = []
    for s, e in sorted(iv):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _overlap(a, b) -> float:
    """The length of the intersection of two sorted disjoint lists."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def read(ctx):
    try:
        tr = ctx["trace"]
        if tr is None or not ctx["complete"]:
            return None
        from ecwam_tpu_torch import tracing
        w0, w1 = tr.window
        top = _union((max(s * 1e-3, w0), min(e * 1e-3, w1))
                     for _, parent, s, e in tracing.report()["intervals"]
                     if parent is None)
        if not top or w1 <= w0:
            return None
        edges = [w0] + [x for iv in tr.busy_intervals() for x in iv] + [w1]
        idle = [[edges[i], edges[i + 1]] for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        return 100.0 * _overlap(idle, top) / (w1 - w0)
    except Exception:
        return None
