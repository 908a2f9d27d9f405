"""Find what a cell needs by the names in ``BENCHMARK.json``.

A configuration is ``configs/<name>.json``, a traffic mix
``traffic/<name>.json``, the limits of a cell's check
``limits/<cell>.json`` and a per-layer metric's reader
``metrics/<name>.py`` (a module with ``read(ctx) -> float | None``).  A
later cell, mix or metric is added by adding its files and its entry in
``BENCHMARK.json``; nothing here names one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads`` with everything it names."""
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list      # the BENCHMARK.json metric entries it reports
    per_layer: list


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(bench: dict, name: str, root: str = HERE) -> Cell:
    """The cell ``name`` of the benchmark ``bench`` (the parsed
    ``BENCHMARK.json``), its configuration, traffic, limits and metrics
    read from the files under ``root``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if _applies(m, name) and m["moves"] in reported]
    return Cell(
        name=name, chips=int(w["chips"]),
        config=load_json(os.path.join(root, "configs",
                                      w["config"] + ".json")),
        traffic=load_json(os.path.join(root, "traffic",
                                       w["traffic"] + ".json")),
        limits=load_json(os.path.join(root, "limits", name + ".json")),
        end_to_end=e2e, per_layer=layer)


def metric_reader(name: str, root: str = HERE):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = os.path.join(root, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"wavebench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
