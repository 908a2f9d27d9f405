"""GiB an output date allocates above the state held before it: the
largest over the window's dates of the peak during the date less what
was allocated when it began."""


def read(ctx):
    x = ctx["window"]["out_extra"]
    return max(x) / float(1 << 30) if x else None
