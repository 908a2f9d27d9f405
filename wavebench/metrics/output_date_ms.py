"""Host ms of an output date (its physics step, second order, products
and the copy to the host), around work that ends in a synchronise, the
mean over the window's dates."""


def read(ctx):
    d = ctx["window"]["date_s"]
    return sum(d) / len(d) * 1e3 if d else None
