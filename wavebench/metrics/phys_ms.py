"""Host ms of a minimal physics step in the window: ``StepTimers.phys``
less ``phys_full`` (the output dates' physics) over the minimal steps."""


def read(ctx):
    w = ctx["window"]
    n = w["phys_min_steps"]
    t = w["timers"]
    return (t["phys"] - t["phys_full"]) / n * 1e3 if n else None
