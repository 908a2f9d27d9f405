"""The readers of the port's spans on a synthetic trace and report: the
device's idle time split into the part inside the port's top-level
spans and the part outside them, the set-up's parts, and nothing read
(``None``) from a tree whose port has no ``tracing`` module."""

import sys

import pytest

from wavebench import spec, trace

READERS = ("idle_in_program_pct", "setup_tables_s", "setup_device_s")


def _trace():
    """A 1000 µs window; the device busy over [100, 300] and [500, 900]
    µs, so idle over [0, 100], [300, 500] and [900, 1000]."""
    ev = [(False, "wb.window", 0.0, 1000.0, 1, 0),
          (False, "aten::op", 99.0, 1.0, 2, 0),
          (True, "void advect_kernel<true>(Args)", 100.0, 200.0, 3, 2),
          (False, "aten::op", 480.0, 1.0, 4, 0),
          (True, "void implsch_kernel<false, false, true>(...)", 500.0,
           400.0, 5, 4)]
    return trace.build(ev)


def _report(intervals):
    """``tracing.report()``'s form; intervals as (name, parent, start µs,
    end µs), given in ns as the port records them."""
    return dict(
        intervals=[(n, p, int(s * 1000), int(e * 1000))
                   for n, p, s, e in intervals],
        totals={"setup.tables": dict(count=1, host_s=12.5, device_s=None),
                "setup.upload": dict(count=1, host_s=2.25, device_s=None),
                "model.init": dict(count=1, host_s=4.0, device_s=None)},
        counters={})


@pytest.fixture
def port(monkeypatch):
    from ecwam_tpu_torch import tracing

    def use(intervals):
        monkeypatch.setattr(tracing, "report", lambda: _report(intervals))
    return use


def _ctx(tr):
    return dict(trace=tr, complete=True)


def test_idle_inside_and_outside_the_port(port):
    tr = _trace()
    # newwind over [50, 350] µs holds idle [50, 100] and [300, 350]; its
    # child adds nothing; phys from 950 µs runs past the window's end
    port([("newwind.upload", "newwind", 60.0, 340.0),
          ("newwind", None, 50.0, 350.0),
          ("advect", None, 400.0, 420.0),
          ("phys", None, 950.0, 1200.0)])
    ctx = _ctx(tr)
    inside = spec.metric_reader("idle_in_program_pct")(ctx)
    idle = spec.metric_reader("device_idle_pct")(ctx)
    assert idle == pytest.approx(40.0)
    # [50, 100] + [300, 350] + [400, 420] + [950, 1000]
    assert inside == pytest.approx(17.0)
    # outside the port: [0, 50], [350, 400], [420, 500], [900, 950]
    assert idle - inside == pytest.approx(23.0)


def test_idle_with_no_spans_in_the_window(port):
    port([])
    assert spec.metric_reader("idle_in_program_pct")(_ctx(_trace())) is None


def test_setup_parts(port):
    port([])
    ctx = _ctx(_trace())
    assert spec.metric_reader("setup_tables_s")(ctx) == 12.5
    assert spec.metric_reader("setup_device_s")(ctx) == 6.25


def test_a_port_without_tracing_reads_nothing(monkeypatch):
    import ecwam_tpu_torch
    monkeypatch.delattr(ecwam_tpu_torch, "tracing", raising=False)
    monkeypatch.setitem(sys.modules, "ecwam_tpu_torch.tracing", None)
    for name in READERS:
        assert spec.metric_reader(name)(_ctx(_trace())) is None


def test_untraced_or_incomplete_windows_read_no_idle(port):
    port([("advect", None, 0.0, 1000.0)])
    read = spec.metric_reader("idle_in_program_pct")
    assert read(dict(trace=None, complete=False)) is None
    assert read(dict(trace=_trace(), complete=False)) is None
