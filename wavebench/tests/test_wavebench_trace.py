"""The per-layer metrics' arithmetic on a synthetic profiler trace: the
busy union, idle gaps named by the host span, device operations
attributed to the span that launched them, the kernel counts against the
launch counters, and the roofline shares from the counted work."""

import pytest

from wavebench import spec, trace, work


def _trace(tmp_path):
    ev = []

    def span(name, ts, dur):
        ev.append((False, "wb." + name, ts, dur, 1000 + len(ev), 0))

    def launch(corr, ts):
        # the host event (an operator) the device operation links to
        ev.append((False, "aten::op", ts, 1, corr, 0))

    def kern(name, corr, ts, dur):
        ev.append((True, name, ts, dur, 5000 + len(ev), corr))
    span("window", 0, 1000)
    span("newwind", 0, 100)
    span("advance", 100, 900)
    launch(1, 10)
    kern("Memcpy HtoD (Pageable -> Device)", 1, 20, 30)      # newwind
    launch(2, 110)
    kern("void advect_kernel<true>(Args)", 2, 120, 200)      # kernel A
    launch(3, 300)
    kern("void implsch_kernel<false, false, true>(...)", 3, 330, 400)
    launch(4, 735)
    kern("void refresh_wraps", 4, 740, 5)
    kern("outside the window", 9, 2000, 50)
    ev.append((True, "wb.advance", 100, 900, 9000, 0))   # a device span
    return trace.build(ev)


def test_busy_idle_and_spans(tmp_path):
    tr = _trace(tmp_path)
    assert tr.window == (0.0, 1000.0)
    assert len(tr.ops) == 4
    assert tr.busy_us() == pytest.approx(30 + 200 + 400 + 5)
    assert [o.span for o in tr.ops] == ["newwind", "advance", "advance",
                                        "advance"]
    gaps = dict()
    for name, us in tr.idle_gaps():
        gaps[name] = gaps.get(name, 0.0) + us
    assert sum(gaps.values()) == pytest.approx(1000 - 635)
    assert gaps["newwind"] == pytest.approx(20 + 70)
    assert tr.kernels(lambda s: "advect_kernel" in s) == (200.0, 1)


def _ctx(tr, launches):
    from wavebench import run
    bk = dict(grid_name="O24", nang=12, nfre=14, nfre_red=12,
              idelpro=900.0, idelt=900.0, pad_to=64)
    win = dict(units=1, wall_s=1e-3, steps=1, phys_min_steps=1,
               launches=launches, timers=dict(propag=4e-4, phys=5e-4,
                                              phys_full=0.0, steps=1),
               date_s=[], out_extra=[])
    from wavebench.reference.ecw.model import setup
    phys = setup.build_model(device="cpu", **bk).phys
    kernels = {k: tr.kernels(m) for k, m in run.KERNELS.items()}
    return dict(window=win, trace=tr, config=bk, n_real=1000,
                passes=run._passes(bk), currents=False, output=False,
                fields=(), phys=phys, kernels=kernels,
                kernel_match=lambda s: any(m(s) for m in
                                           run.KERNELS.values()),
                complete=all(kernels[k][1] == launches[k] for k in kernels),
                data=dict(above_cut=3.0, shallow=0.0, windsea=0.5, ice=0.0,
                          gc_terms=0.0))


def test_readers(tmp_path):
    tr = _trace(tmp_path)
    ctx = _ctx(tr, dict(advect=1, implsch=1, implsch_full=0))
    r = {n: spec.metric_reader(n)(ctx) for n in (
        "device_idle_pct", "outside_kernels_ms", "advect_roofline_pct",
        "implsch_roofline_pct", "propag_ms", "phys_ms", "step_mfu_pct")}
    assert r["device_idle_pct"] == pytest.approx(100 * (1 - 635 / 1000))
    # the forcing copy and the wraps
    assert r["outside_kernels_ms"] == pytest.approx(35e-3)
    assert r["propag_ms"] == pytest.approx(0.4)
    assert r["phys_ms"] == pytest.approx(0.5)
    adv = work.advect_bytes(1000, 12, 12, 12, 0) / work.HBM_BYTES_PER_S
    assert r["advect_roofline_pct"] == pytest.approx(100 * adv / 200e-6)
    ops = 1000 * work.implsch_ops(ctx["phys"], 12, False, **ctx["data"])
    phys = max(ops / work.FP32_OPS_PER_S,
               work.physics_bytes(1000, 12, 14, False)
               / work.HBM_BYTES_PER_S)
    assert r["implsch_roofline_pct"] == pytest.approx(100 * phys / 400e-6)
    assert r["step_mfu_pct"] == pytest.approx(100 * (adv + phys) / 1e-3)


def test_dropped_launches_are_not_measured(tmp_path):
    tr = _trace(tmp_path)
    ctx = _ctx(tr, dict(advect=2, implsch=1, implsch_full=0))
    for n in ("device_idle_pct", "outside_kernels_ms",
              "advect_roofline_pct", "implsch_roofline_pct"):
        assert spec.metric_reader(n)(ctx) is None
