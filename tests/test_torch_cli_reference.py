"""The port's CLI against the reference's fast path, and a reference
restart resumed in the port.

The reference CLI runs its dense ``WaveModel`` on the CPU; here it is
forced onto its fast path (its ``default_backend`` patched to
``"pallas"`` and its ``FastWaveModel`` built with ``backend="xla"``),
the path the port always takes.  Both run the 12° YAML of
``test_config_cli.py`` for 3 h with the 2 h restart and every output
field that ``outcontrol`` knows and ``CATALOG`` computes but the swell
trains, hourly from 1 h (before the first physics step the state holds
no fluxes, in both), with the second-order correction (the default):

  * every statistics.log average, minimum and maximum agrees within
    STATS_RTOL of the entry's largest magnitude (a near-zero average of
    a signed field, such as a stress component, is held to its field's
    scale), and the GRIB files carry the same messages;
  * the port resumed from the reference's 2 h restart ends at 3 h with
    the same statistics within STATS_RTOL (its output from 3 h: a
    resumed run's step-0 output, like the first run's, comes before any
    physics step).

The winds come from a forcing file (``test_torch_cli.forcing_file``), so
that both legs of a resumed run read those of the uninterrupted one.
"""

import os

import numpy as np
import pytest

from ecwam_tpu.cli import main as j_cli
from ecwam_tpu.io import grib as j_grib
from ecwam_tpu.model import driver as j_driver
from ecwam_tpu.model import fusedstep as j_fusedstep
from ecwam_tpu_torch.io import grib as t_grib
from ecwam_tpu_torch.io import outcontrol as t_outcontrol
from ecwam_tpu_torch.io import products as t_products

from test_torch_cli import forcing_file, leg2, port_run, three_h

STATS_RTOL = 1e-5

WIDE_FIELDS = [p.name for p in t_outcontrol.PARAMS
               if p.name in t_products.CATALOG
               and p.name not in t_products.TRAIN_FIELDS]


def wide(text, first="01:00"):
    """``text`` with WIDE_FIELDS, output hourly from ``first``."""
    return text.replace("name: [swh, mwd, mwp, wind]",
                        f"name: [{', '.join(WIDE_FIELDS)}]").replace(
        "          - timestep: 01:00",
        f"          - begin: 2023-01-01 {first}:00\n"
        "            timestep: 01:00")


@pytest.fixture
def reference_fast_path(monkeypatch):
    """The reference CLI on its fast path (FastWaveModel over XLA)."""
    class XlaFast(j_driver.FastWaveModel):
        def __init__(self, *a, **kw):
            super().__init__(*a, backend="xla", **kw)
    monkeypatch.setattr(j_fusedstep, "default_backend",
                        lambda dtype: "pallas")
    monkeypatch.setattr(j_driver, "FastWaveModel", XlaFast)
    return XlaFast


def ref_run(text, rundir):
    return j_cli.run_model(j_cli.RunConfig.from_yaml(text), str(rundir),
                           quiet=True)


def same_stats(got, want, rtol, dates=None):
    """Each entry's average/minimum/maximum within ``rtol`` of the
    reference entry's largest magnitude."""
    eg = {(e["time"], e["name"]): e for e in got.entries
          if dates is None or e["time"] in dates}
    ew = {(e["time"], e["name"]): e for e in want.entries
          if dates is None or e["time"] in dates}
    assert set(eg) == set(ew)
    for k, w in ew.items():
        g = eg[k]
        scale = max(abs(w[q]) for q in ("average", "minimum", "maximum"))
        for q in ("average", "minimum", "maximum"):
            assert abs(g[q] - w[q]) <= rtol * scale, (k, q, g[q], w[q])
        assert g["non_missing_points"] == w["non_missing_points"], k


def test_port_matches_reference_fast_path(tmp_path, reference_fast_path):
    frc = forcing_file(tmp_path)
    model, want = ref_run(wide(three_h(frc)), tmp_path / "ref")
    assert isinstance(model, reference_fast_path)
    _, got = port_run(wide(three_h(frc)), tmp_path / "port")
    assert len(got.entries) == 3 * len(WIDE_FIELDS)
    same_stats(got, want, STATS_RTOL)
    for d in ("20230101010000", "20230101030000"):
        a = t_grib.read_messages(str(tmp_path / "port" / f"MPP{d}.grib"))
        b = j_grib.read_messages(str(tmp_path / "ref" / f"MPP{d}.grib"))
        assert [m.meta["param"] for m in a] == [m.meta["param"] for m in b]
        for x, y in zip(a, b):
            ok = y.values != t_grib.MISSING
            np.testing.assert_array_equal(x.values != t_grib.MISSING, ok)
            scale = max(np.abs(y.values[ok]).max(), 1e-30)
            # 16-bit packing: one quantum of the field's range
            assert np.abs(x.values[ok] - y.values[ok]).max() <= \
                2.0 * (np.ptp(y.values[ok]) / 65535 + STATS_RTOL * scale)

    # the reference's 2 h restart, resumed in the port to 3 h
    rst = "restart_20230101020000.npz"
    os.makedirs(tmp_path / "port_from_ref")
    os.link(tmp_path / "ref" / rst, tmp_path / "port_from_ref" / rst)
    resumed, leg = port_run(wide(leg2(frc), first="03:00"),
                            tmp_path / "port_from_ref")
    assert resumed.timers.steps == 4
    same_stats(leg, want, STATS_RTOL, dates={"20230101030000"})
