"""Host ms of one hourly current refresh: the port's ``refresh`` span
(``FastWaveModel.newwind`` → ``FusedPropagation.refresh``), its host
seconds over its count, from ``ecwam_tpu_torch.tracing.report()``'s
process totals (the warm-up hour, the window and the check's hour): the
time the host spends launching the refresh, or computing it where GRADI
runs on the host.  None where the port records no spans."""


def read(ctx):
    try:
        from ecwam_tpu_torch import tracing
        t = tracing.report()["totals"].get("refresh")
        if not t or not t["count"]:
            return None
        return float(t["host_s"]) / t["count"] * 1e3
    except Exception:
        return None
