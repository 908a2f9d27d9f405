"""Host seconds of the port's ``setup.upload`` and ``model.init`` spans:
the env and host tables moved to the device (``setup.build_model``), and
``FastWaveModel``'s device tables, cold start and physics rows.  None
where the port does not record both spans."""


def read(ctx):
    try:
        from ecwam_tpu_torch import tracing
        totals = tracing.report()["totals"]
        if "setup.upload" not in totals or "model.init" not in totals:
            return None
        return float(totals["setup.upload"]["host_s"]
                     + totals["model.init"]["host_s"])
    except Exception:
        return None
