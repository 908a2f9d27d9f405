"""waminfo restart-metadata file (WRITSTA / READSTA).

Copied unchanged from ``ecwam_tpu/io/waminfo.py`` (numpy only, no
JAX), with its imports pointed at ``ecwam_tpu_torch``: the port
imports nothing of the JAX package.

Card-formatted text file recording the run window, analysis/forecast
split, wind timestep and restart dates, written alongside each binary
restart (src/ecwam/writsta.F90:88-152; read back by
readsta.F90).  The card layout is kept so a reader of the reference's
waminfo recognises ours.
"""

from __future__ import annotations

import re


def write_waminfo(fn: str, *, begin14: str, end14: str,
                  analysis_begin14: str | None = None,
                  analysis_end14: str | None = None,
                  wind_step_s: int = 3600,
                  restart_date14: str | None = None,
                  last_spectra_date14: str | None = None,
                  nproc: int = 1) -> str:
    ab = analysis_begin14 or begin14
    ae = analysis_end14 or begin14
    analpd = _seconds(ab, ae)
    forepd = _seconds(ae, end14)
    cards = [
        f"RUN MODEL FROM {begin14} TO {end14}",
        "",
        "",
        f"ANALYSIS PERIOD = {analpd:7d}",
        f"FORECAST PERIOD = {forepd:10d}",
        f"WIND TIME STEP IN SECONDS = {wind_step_s:7d}",
        f"ANALYSIS FROM {ab} TO {ae}",
        "",
        "",
        "STATUS STORM1= FINISHED",
        "STATUS STORM2= FINISHED",
        "STATUS STORM3= FINISHED",
        f"DATE FOR OUTPUT OF BOTH RESTART FILES = "
        f"{restart_date14 or end14}",
        f"LAST DATE FOR SPECTRA FILE OUTPUT = "
        f"{last_spectra_date14 or end14}",
        "BEGIN DATE FOR USING SURFACE CURRENT = 00000000000000",
        "",
        f"NUMBER OF MPI TASKS USED = {nproc:10d}",
    ]
    with open(fn, "w") as f:
        for c in cards:
            f.write(f"{c:<72s}\n")
    return fn


def read_waminfo(fn: str) -> dict:
    out: dict = {}
    with open(fn) as f:
        for line in f:
            line = line.rstrip()
            m = re.match(r"RUN MODEL FROM (\d{14}) TO (\d{14})", line)
            if m:
                out["begin14"], out["end14"] = m.group(1), m.group(2)
            m = re.match(r"ANALYSIS PERIOD *= *(\d+)", line)
            if m:
                out["analysis_period_s"] = int(m.group(1))
            m = re.match(r"FORECAST PERIOD *= *(\d+)", line)
            if m:
                out["forecast_period_s"] = int(m.group(1))
            m = re.match(r"WIND TIME STEP IN SECONDS *= *(\d+)", line)
            if m:
                out["wind_step_s"] = int(m.group(1))
            m = re.match(r"ANALYSIS FROM (\d{14}) TO (\d{14})", line)
            if m:
                out["analysis_begin14"] = m.group(1)
                out["analysis_end14"] = m.group(2)
            m = re.match(
                r"DATE FOR OUTPUT OF BOTH RESTART FILES *= *(\d{14})", line)
            if m:
                out["restart_date14"] = m.group(1)
            m = re.match(r"NUMBER OF MPI TASKS USED *= *(\d+)", line)
            if m:
                out["nproc"] = int(m.group(1))
    return out


def _seconds(d14a: str, d14b: str) -> int:
    import datetime as _dt
    fmt = "%Y%m%d%H%M%S"
    return max(0, int((_dt.datetime.strptime(d14b, fmt)
                       - _dt.datetime.strptime(d14a, fmt)).total_seconds()))
