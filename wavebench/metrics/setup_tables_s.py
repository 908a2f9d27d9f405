"""Host seconds of the port's ``setup.tables`` span: the host tables'
cache key and their read from the cache (or their build and save), in
``setup.build_model``.  None where the port records no spans."""


def read(ctx):
    try:
        from ecwam_tpu_torch import tracing
        t = tracing.report()["totals"].get("setup.tables")
        return None if t is None else float(t["host_s"])
    except Exception:
        return None
