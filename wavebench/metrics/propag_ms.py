"""Host ms of an advection step in the window: ``StepTimers.propag``
(``FastWaveModel.advance``, host clock around synchronised work) over the
window's steps."""


def read(ctx):
    w = ctx["window"]
    return w["timers"]["propag"] / w["steps"] * 1e3 if w["steps"] else None
