"""The whole window's share of the card's peak: the least time of all
its counted work (each piece at the larger of its operations over 67
TFLOP/s and its bytes over 3.35 TB/s, summed) over the window's wall
time.  It stays a bound on the step once a kernel is gone."""

from wavebench import work


def read(ctx):
    w = ctx["window"]
    pieces = work.window_work(ctx)
    least = sum(work.bound_total(p) for p in pieces.values())
    return 100.0 * least / w["wall_s"] if w["wall_s"] > 0 else None
