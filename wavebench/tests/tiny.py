"""A tiny cell for the CPU tests: the kinds of cell the harness runs at
O24 with 12 directions, through :func:`wavebench.run.run_cell` on the CPU
(the port's plain versions stand in for its kernels there)."""

import json
import os

from wavebench import spec

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = spec.load_json(os.path.join(os.path.dirname(HERE), "BENCHMARK.json"))
FIELDS = spec.load_json(os.path.join(HERE, "traffic",
                                     "hourly_out.json"))["fields"]
# the benchmark's cell whose end-to-end metrics and limits a tiny cell
# takes
CELL = BENCH["workloads"][0]["name"]
# the forcing of a cell with surface currents and sea ice (the keys
# wavebench/forcing.py reads): an O320 jet with wave-3 eddies, varied by
# up to 10 % each forecast hour, and polar ice
CURRENTS = {"wind_speed": [8.0, 12.0],
            "currents": {"jet": 0.9, "eddy": 0.3, "jet_width": 8.0,
                         "wave": 3, "vary": 0.1},
            "ice": {"lat0": 60.0, "width": 15.0, "thick": 2.0}}
# the output stages' limits of a cell with output dates: no such cell is
# in the benchmark yet, so these are the tests' own, far above what the
# plain path reads on the CPU (< 1e-5) and below the control and faults
OUTPUT_LIMITS = {"out_spectrum": 2e-4, "out_state": 3e-4, "out_fields": 1e-2}


def cell(currents: bool, output: bool, limits: dict | None = None,
         per_layer=()):
    """A tiny cell with currents, cy49 switches and ice, or with fast-wave
    substeps, with or without output dates; ``limits`` default to the
    benchmark's cell's own (``limits/*.json``), with
    :data:`OUTPUT_LIMITS` where there are output dates."""
    bk = dict(grid_name="O24", nang=12, nfre=14, nfre_red=12,
              idelpro=900.0, idelt=1800.0, pad_to=64)
    fc = {"wind_speed": [8.0, 12.0], "currents": None, "ice": None}
    if currents:
        bk.update(irefra=2, llgcbz0=True, llnormagam=True)
        fc = json.loads(json.dumps(CURRENTS))
    else:
        bk.update(ifrelfmax=2, delpro_lf=450.0)
    traffic = dict(forcing_every_s=3600.0, output_every_period=output,
                   fields=FIELDS)
    lim = limits or spec.load_json(os.path.join(HERE, "limits",
                                                CELL + ".json"))
    if output and limits is None:
        lim = {**lim, **OUTPUT_LIMITS}
    e2e = [m for m in BENCH["end_to_end"]
           if CELL in m.get("workloads", [CELL])]
    return spec.Cell(name=CELL, chips=1,
                     config=dict(build_model=bk, forcing=fc),
                     traffic=traffic, limits=lim, end_to_end=e2e,
                     per_layer=list(per_layer))


def run(c, root, seed=2**33 + 5, **kw):
    from wavebench import run as run_mod
    return run_mod.run_cell(c, seed=seed, seconds=kw.pop("seconds", 0.2),
                            trace=kw.pop("trace", False), device="cpu",
                            root=str(root), log=lambda *a: None, **kw)


def dumps(res) -> str:
    return json.dumps(res)
