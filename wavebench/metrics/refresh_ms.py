"""Device ms of one hourly current refresh: the port's ``refresh`` span
(``FastWaveModel.newwind`` → ``FusedPropagation.refresh``: GRADI's
current gradients, the tables and the CFL retry's pass of kernel A),
its device seconds between CUDA events over its count, from
``ecwam_tpu_torch.tracing.report()``'s process totals (the warm-up hour,
the window and the check's hour).  None where the span records no device
time (a tree whose refresh span is host-only) or the port records no
spans."""


def read(ctx):
    try:
        from ecwam_tpu_torch import tracing
        t = tracing.report()["totals"].get("refresh")
        if not t or not t["count"] or t["device_s"] is None:
            return None
        return float(t["device_s"]) / t["count"] * 1e3
    except Exception:
        return None
