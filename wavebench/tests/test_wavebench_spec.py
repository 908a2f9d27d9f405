"""Every configuration, traffic mix, limit file and per-layer metric of
``BENCHMARK.json`` is found by its name, and a new cell, mix and metric
are added by adding files alone."""

import json
import os
import shutil

import pytest

from wavebench import spec

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH = spec.load_json(os.path.join(ROOT, "BENCHMARK.json"))


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_finds_its_files(name):
    c = spec.find_cell(BENCH, name)
    w = next(w for w in BENCH["workloads"] if w["name"] == name)
    assert c.config["name"] == w["config"]
    assert "forcing_every_s" in c.traffic
    assert set(c.limits) >= {"start_spectrum", "step_spectrum",
                             "step_stress", "points_over_1e-3"}
    names = {m["name"] for m in c.end_to_end}
    assert names >= {"peak_mem_gib", "setup_s"}
    assert len({n for n in names if n.split(".")[0] == "sim_speedup"}) == 1
    for m in c.per_layer:
        assert callable(spec.metric_reader(m["name"]))


def test_config_files_match_the_benchmark():
    for c in BENCH["configs"]:
        cfg = spec.load_json(os.path.join(ROOT, c["file"]))
        assert cfg["name"] == c["name"]
        assert cfg["reduced"] == c["reduced"]
        assert set(cfg["reduced"]) <= set(cfg["reduced_why"])


def test_a_new_cell_mix_and_metric_are_files_only(tmp_path):
    root = tmp_path / "wavebench"
    shutil.copytree(os.path.join(ROOT, "wavebench"), root,
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    cfg = spec.load_json(str(root / "configs" / "o640_oper.json"))
    cfg["name"] = "o160_new"
    cfg["build_model"]["grid_name"] = "O160"
    (root / "configs" / "o160_new.json").write_text(json.dumps(cfg))
    (root / "traffic" / "six_hourly.json").write_text(json.dumps(dict(
        forcing_every_s=21600.0, output_every_period=True, fields=["swh"])))
    (root / "limits" / "o160_new.six_hourly.json").write_text(json.dumps(
        dict(start_spectrum=1e-3, step_spectrum=1e-3, step_stress=1e-3,
             out_spectrum=1e-3, out_state=1e-3, out_fields=1e-3,
             **{"points_over_1e-3": 200})))
    (root / "metrics" / "units_per_s.py").write_text(
        "def read(ctx):\n"
        "    return ctx['window']['units'] / ctx['window']['wall_s']\n")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append(dict(name="o160_new", source="x",
                                 file="wavebench/configs/o160_new.json",
                                 reduced=[], why="x"))
    bench["workloads"].append(dict(name="o160_new.six_hourly",
                                   config="o160_new", traffic="six_hourly",
                                   chips=1, why="x"))
    rate = next(m for m in bench["end_to_end"]
                if m["name"] == "sim_speedup")
    rate["workloads"].append("o160_new.six_hourly")
    bench["per_layer"].append(dict(
        name="units_per_s", unit="1/s", better="higher", source="host_clock",
        layer="whole step", moves="sim_speedup",
        workloads=["o160_new.six_hourly"]))
    c = spec.find_cell(bench, "o160_new.six_hourly", str(root))
    assert c.config["build_model"]["grid_name"] == "O160"
    assert c.traffic["forcing_every_s"] == 21600.0
    assert "units_per_s" in [m["name"] for m in c.per_layer]
    read = spec.metric_reader("units_per_s", str(root))
    assert read(dict(window=dict(units=6, wall_s=3.0))) == 2.0
    # the cells already there do not see the new metric
    old = spec.find_cell(bench, "o640_oper.forecast", str(root))
    assert "units_per_s" not in [m["name"] for m in old.per_layer]


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        spec.find_cell(BENCH, "o1280_oper.forecast")
