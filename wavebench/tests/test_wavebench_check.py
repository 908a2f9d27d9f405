"""The check that decides ``correct``, driven through a whole run on the
CPU at O24 (the harness's look for a card skipped): the reference
against the port's plain path, the control and the faults the timed
path can have, each of which must come out not correct under the
cells' own limits; and the result line's format."""

import json

import pytest
import torch

from wavebench.tests import tiny

KINDS = [(False, False), (True, False), (True, True)]


@pytest.mark.parametrize("currents,output", KINDS)
def test_reference_follows_the_port(tmp_path, currents, output):
    # on the CPU the port runs its plain versions, of which the reference
    # is a frozen copy: every stage agrees to rounding
    res = tiny.run(tiny.cell(currents, output), tmp_path)
    assert res["correct"], res["checks"]
    for name, c in res["checks"].items():
        assert c["value"] < 1e-5, (name, c)


@pytest.mark.parametrize("currents,output", KINDS)
def test_control_is_not_correct(tmp_path, currents, output):
    res = tiny.run(tiny.cell(currents, output), tmp_path, control="bf16")
    assert not res["correct"], res["checks"]


def _fault(monkeypatch, kind):
    from ecwam_tpu_torch.io import products
    from ecwam_tpu_torch.model import fusedstep
    if kind == "state_unchanged":
        monkeypatch.setattr(fusedstep.FusedPropagation, "advect_srl",
                            lambda self, f: f)
        orig = fusedstep.FusedPropagation.phys_srl

        def phys(self, f, stress6, *a, **k):
            out = orig(self, f.clone(), stress6, *a, **k)
            return (f, stress6) + tuple(out[2:])
        monkeypatch.setattr(fusedstep.FusedPropagation, "phys_srl", phys)
    elif kind == "half_the_rows":
        orig = fusedstep.FusedPropagation.phys_srl

        def phys(self, f, stress6, frc6, denv, env2d, tail=None):
            n = f.shape[0] // 2
            keep = f[n:].clone()
            keep_t = None if tail is None else tail[n:].clone()
            out = list(orig(self, f, stress6, frc6, denv, env2d, tail))
            out[0] = torch.cat([out[0][:n], keep])
            if tail is not None:
                out[2] = torch.cat([out[2][:n], keep_t])
            return tuple(out)
        monkeypatch.setattr(fusedstep.FusedPropagation, "phys_srl", phys)
    elif kind == "field_altered":
        orig = products.compute

        def compute(names, *a, **k):
            out = orig(names, *a, **k)
            out[names[0]] = out[names[0]] * 1.01
            return out
        monkeypatch.setattr(products, "compute", compute)


@pytest.mark.parametrize("kind,output", [
    ("state_unchanged", False), ("half_the_rows", False),
    ("state_unchanged", True), ("half_the_rows", True),
    ("field_altered", True)])
def test_fault_is_not_correct(tmp_path, monkeypatch, kind, output):
    _fault(monkeypatch, kind)
    res = tiny.run(tiny.cell(True, output), tmp_path)
    assert not res["correct"], (kind, res["checks"])


# the output date's per-layer metrics, for a cell with output dates
OUTPUT_LAYER = [dict(name=n, unit=u, better="lower", source="host_clock",
                     layer="output date", moves=moves)
                for n, u, moves in (("output_date_ms", "ms", "sim_speedup"),
                                    ("output_extra_gib", "GiB",
                                     "peak_mem_gib"))]


@pytest.mark.parametrize("trace", [False, True])
def test_result_line(tmp_path, trace):
    layer = tiny.BENCH["per_layer"] + OUTPUT_LAYER
    res = tiny.run(tiny.cell(True, True, per_layer=layer), tmp_path,
                   trace=trace)
    line = json.loads(tiny.dumps(res))
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(line)
    assert line["attempted"] >= 1 and line["failed"] == 0
    dev = line["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    assert "points_over_1e-3" in line["checks"]
    setup = line["setup"]
    assert setup["builds_s"] == 0 and setup["tables_built"]
    assert setup["first_in_checkout"]
    assert 0 < setup["warmup_s"] < line["metrics"].get(
        "setup_s", {"value": 1e9})["value"]
    if trace:
        assert dev["window_s"] > 0 and "busy_s" in dev
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        # the CPU has no device trace: only the host metrics are read
        assert {"propag_ms", "phys_ms", "output_date_ms",
                "step_mfu_pct"} <= set(line["metrics"])
    else:
        assert set(line["metrics"]) == {"sim_speedup", "peak_mem_gib",
                                        "setup_s"}


def test_a_second_run_finds_the_tables(tmp_path):
    tiny.run(tiny.cell(False, False), tmp_path)
    res = tiny.run(tiny.cell(False, False), tmp_path)
    assert not res["setup"]["tables_built"]
    assert not res["setup"]["first_in_checkout"]


def test_a_fault_on_few_points_is_not_correct(tmp_path, monkeypatch):
    # a fault confined to fewer points than the quantile leaves out (a
    # polar row's worth) passes every quantile and fails the count
    from ecwam_tpu_torch.model import fusedstep
    orig = fusedstep.FusedPropagation.phys_srl

    def phys(self, f, *a, **k):
        out = list(orig(self, f, *a, **k))
        out[0] = out[0].clone()
        out[0][100:102] *= 1.5
        return tuple(out)
    monkeypatch.setattr(fusedstep.FusedPropagation, "phys_srl", phys)
    # the cell's count limit as the same share of O24's 3,168 points
    # rounds to 0
    lim = dict(spec_limits(), **{"points_over_1e-3": 0})
    res = tiny.run(tiny.cell(False, False, limits=lim), tmp_path)
    quantiles = {k: c for k, c in res["checks"].items()
                 if k != "points_over_1e-3"}
    assert all(c["value"] <= c["limit"] for c in quantiles.values())
    assert not res["correct"], res["checks"]


def spec_limits():
    return tiny.spec.load_json(tiny.os.path.join(
        tiny.HERE, "limits", tiny.CELL + ".json"))
