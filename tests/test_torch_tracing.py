"""The port's spans (``ecwam_tpu_torch.tracing``) on the CPU.

  * with tracing off a span adds to the totals and records no interval;
  * under ``torch.profiler`` the intervals nest, each names its parent,
    and an operator's profiler start lies inside the span that ran it
    (the two share the clock, to 100 µs);
  * ``FastWaveModel.advance`` and ``WaveModel.advance`` never synchronise,
    and their ``StepTimers`` still count steps and positive seconds;
  * the set-up's spans split ``build_model`` and the model's start;
  * the Chrome trace holds the intervals and the totals.

The card's side (no device event of a span's own, the timers against
the profiler's kernel times) is ``test_torch_gpu.py``'s.
"""

import inspect
import json

import pytest
import torch

from ecwam_tpu_torch import device as tdevice
from ecwam_tpu_torch import tracing
from ecwam_tpu_torch.model import driver, setup

SLACK_NS = 100_000


@pytest.fixture(scope="module")
def fast_setup():
    return setup.build_model(grid_name="12.0", nang=12, nfre=18,
                             nfre_red=15, idelpro=900.0, idelt=1800.0,
                             pad_to=64, device="cpu")


def _fast(ms):
    return driver.FastWaveModel(ms, driver.constant_wind_forcing(ms.n_real),
                                "20230101000000")


def test_tracing_off_records_no_intervals():
    tracing.stop()
    assert not tracing.tracing()
    n = len(tracing.report()["intervals"])
    before = tracing.report()["totals"].get("test.off", dict(count=0))
    with tracing.span("test.off"):
        with tracing.span("test.off"):
            torch.ones(4).add_(1)
    rep = tracing.report()
    assert len(rep["intervals"]) == n
    assert rep["totals"]["test.off"]["count"] == before["count"] + 2
    assert rep["totals"]["test.off"]["host_s"] > 0.0
    assert rep["totals"]["test.off"]["device_s"] is None
    assert set(rep["counters"]) == {"advect.launches",
                                    "implsch_srl.launches",
                                    "implsch_srl.full_launches"}


def test_intervals_nest_on_the_profilers_clock():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert tracing.tracing()
        n = len(tracing.report()["intervals"])
        with tracing.span("test.outer"):
            with tracing.span("test.inner"):
                x = torch.ones(1000)
                x.mul_(3.0)
            with tracing.span("test.inner2"):
                pass
    got = tracing.report()["intervals"][n:]
    assert [(i[0], i[1]) for i in got] == [
        ("test.inner", "test.outer"), ("test.inner2", "test.outer"),
        ("test.outer", None)]
    by = {i[0]: i for i in got}
    outer = by["test.outer"]
    for name in ("test.inner", "test.inner2"):
        s, e = by[name][2:]
        assert outer[2] <= s <= e <= outer[3]
    assert by["test.inner"][3] <= by["test.inner2"][2]
    mul = [e for e in prof.profiler.kineto_results.events()
           if e.name() == "aten::mul_"]
    assert len(mul) == 1
    s, e = by["test.inner"][2:]
    t0, t1 = mul[0].start_ns(), mul[0].start_ns() + mul[0].duration_ns()
    assert s - SLACK_NS <= t0 <= t1 <= e + SLACK_NS


def test_start_and_stop_trace_without_a_profiler():
    tracing.start()
    try:
        assert tracing.report()["intervals"] == []
        with tracing.span("test.forced"):
            pass
    finally:
        tracing.stop()
    with tracing.span("test.forced"):
        pass
    got = tracing.report()["intervals"]
    assert [i[:2] for i in got] == [("test.forced", None)]


def _count_synchronise(monkeypatch):
    calls = []

    def count(*a, **k):
        calls.append(a)
    monkeypatch.setattr(torch.cuda, "synchronize", count)
    monkeypatch.setattr(tdevice, "synchronize", count)
    monkeypatch.setattr(torch.cuda.Event, "synchronize", count)
    return calls


@pytest.mark.parametrize("cls", ["FastWaveModel", "WaveModel"])
def test_advance_never_synchronises(monkeypatch, fast_setup, cls):
    src = inspect.getsource(getattr(driver, cls).advance)
    assert "synchronize" not in src and "cuda" not in src
    if cls == "FastWaveModel":
        m = _fast(fast_setup)
    else:
        ms = setup.build_model(grid_name="12.0", nang=12, nfre=15,
                               pad_to=64, weights_mode="cached",
                               device="cpu")
        m = driver.WaveModel(ms, driver.constant_wind_forcing(ms.n_real),
                             "20230101000000")
    calls = _count_synchronise(monkeypatch)
    m.advance(3, wind_every=2)
    assert calls == []


def test_step_timers_count_steps_and_seconds(fast_setup):
    m = _fast(fast_setup)
    t = m.timers
    assert (t.propag, t.phys, t.phys_full, t.steps) == (0.0, 0.0, 0.0, 0)
    m.advance(2)
    assert t.steps == 2 and t.propag > 0.0 and t.phys > 0.0
    assert t.phys_full == 0.0
    phys = t.phys
    m.advance(2, full_phys=True)
    assert t.steps == 4 and t.phys > phys
    assert t.phys_full == pytest.approx(t.phys - phys)
    assert "steps=4" in repr(t)


def test_setup_spans_split_the_build():
    before = {k: v["count"] for k, v in tracing.report()["totals"].items()}
    ms = setup.build_model(grid_name="12.0", nang=12, nfre=15, pad_to=64,
                           device="cpu")
    _fast(ms)
    tot = tracing.report()["totals"]
    for name in ("setup.tables", "setup.upload", "model.init"):
        assert tot[name]["count"] == before.get(name, 0) + 1
        assert tot[name]["host_s"] > 0.0


def test_newwind_spans_nest_under_newwind(fast_setup):
    m = _fast(fast_setup)
    tracing.start()
    try:
        m.newwind(m.date)
        m.advance(2)
    finally:
        tracing.stop()
    got = [i[:2] for i in tracing.report()["intervals"]]
    assert got == [("newwind.forcing", "newwind"),
                   ("newwind.upload", "newwind"),
                   ("newwind.rows", "newwind"), ("newwind", None),
                   ("advect", None), ("advect", None), ("phys", None)]


def test_chrome_trace_holds_intervals_and_totals(tmp_path):
    tracing.start()
    try:
        with tracing.span("test.chrome"):
            with tracing.span("test.chrome.inner"):
                pass
    finally:
        tracing.stop()
    path = tmp_path / "trace.json"
    tracing.write_chrome(str(path))
    doc = json.loads(path.read_text())
    ev = {e["name"]: e for e in doc["traceEvents"]}
    assert set(ev) == {"test.chrome", "test.chrome.inner"}
    assert all(e["ph"] == "X" and e["dur"] >= 0 for e in ev.values())
    assert ev["test.chrome.inner"]["args"] == {"parent": "test.chrome"}
    assert ev["test.chrome"]["ts"] <= ev["test.chrome.inner"]["ts"]
    assert doc["otherData"]["totals"]["test.chrome"]["count"] >= 1
    assert "advect.launches" in doc["otherData"]["counters"]
