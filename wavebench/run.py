"""Run one cell of the benchmark and print its result line.

    python3 -m wavebench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for.  Set-up (process start to the first timed step) builds the kernel
libraries the cell launches and the host tables (both cached inside the
checkout), makes the forcing from the seed, cold-starts the model with
JONSWAP on the card and runs one forcing period, the window's own unit,
as warm-up.  The window then runs whole forcing periods until one ends
after ``--seconds``.  With ``--trace 1`` the window runs under
``torch.profiler`` and the line carries the per-layer metrics; else the
end-to-end ones.  After the window the check of :mod:`wavebench.check`
decides ``correct``; the numbers it compared, each beside its limit, are
the last lines on standard error and the last key of the line.  The
line's ``setup`` key splits set-up into its parts, and tells the first
run in a checkout, which builds the kernel libraries or the host tables,
from the others.

``--control bf16`` puts the reference, its state held in bfloat16, in
the program's place for the check (the control of the limits; the
benchmark's own runs never use it).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from wavebench import check as check_mod  # noqa: E402
from wavebench import forcing as forcing_mod  # noqa: E402
from wavebench import guard, spec, work  # noqa: E402
from wavebench import trace as trace_mod  # noqa: E402

GIB = float(1 << 30)
# profiler kernel names of kernels A and B (csrc/advect.cu, csrc/implsch.cu)
KERNELS = dict(advect=lambda s: "advect_kernel" in s,
               implsch=lambda s: "implsch_kernel<false" in s,
               implsch_full=lambda s: "implsch_kernel<true" in s)


class Clock:
    """The harness's spans around each call into a layer: under a
    profiler a ``record_function`` named ``wb.<name>``, else nothing."""

    def __init__(self, profile: bool):
        self.profile = profile

    def __call__(self, name: str):
        if self.profile:
            return torch.profiler.record_function(trace_mod.SPAN_PREFIX
                                                  + name)
        return contextlib.nullcontext()


class Memory:
    """The device's peak allocation over the run, and the peak of each
    output date above what was allocated before it."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.peak = 0
        self.extra = []
        if self.cuda:
            torch.cuda.reset_peak_memory_stats(device)

    def read(self) -> int:
        if self.cuda:
            self.peak = max(self.peak, torch.cuda.max_memory_allocated())
        return self.peak

    @contextlib.contextmanager
    def around(self):
        if not self.cuda:
            yield
            return
        self.read()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        yield
        self.extra.append(torch.cuda.max_memory_allocated() - before)
        self.read()


def _periods(cell) -> tuple[int, int, int, bool]:
    bk = cell.config["build_model"]
    period = float(cell.traffic["forcing_every_s"])
    steps = int(round(period / bk["idelpro"]))
    k_phys = int(round(bk["idelt"] / bk["idelpro"]))
    output = bool(cell.traffic.get("output_every_period", False))
    if steps % k_phys or steps * bk["idelpro"] != period:
        raise ValueError("a forcing period must hold whole physics steps")
    return period, steps, k_phys, output


def _passes(ms_kw: dict) -> list:
    """(nf, nw) of each CTU pass of an advection step: the all-band pass
    and the fast-wave sub-band passes (a sub-band pass computes one more
    frequency than it writes under current refraction)."""
    nfre_red = ms_kw.get("nfre_red") or ms_kw["nfre"]
    out = [(nfre_red, nfre_red)]
    mlf = ms_kw.get("ifrelfmax", 0)
    if mlf:
        nsub = max(1, round(ms_kw["idelpro"] / ms_kw["delpro_lf"]))
        nw = mlf + (1 if ms_kw.get("irefra", 0) in (2, 3) else 0)
        out += [(nw, mlf)] * (nsub - 1)
    return out


def run_cell(cell, *, seed: int, seconds: float, trace: bool, device,
             root: str, control: str | None = None, t_start: float = None,
             log=None) -> dict:
    """Run ``cell`` (a :class:`spec.Cell`) and return the result object
    (without the ``metrics`` of the other kind)."""
    from wavebench.program import Program, launch_counts, timers
    from wavebench.reference.model import Reference
    t_start = T_START if t_start is None else t_start
    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    device = torch.device(device)
    cache = os.path.join(root, "wavebench", ".cache")
    bk = dict(cell.config["build_model"])
    period, steps, k_phys, output = _periods(cell)
    fields = tuple(cell.traffic.get("fields", ())) if output else ()
    mem = Memory(device)

    # -- set-up ----------------------------------------------------------
    marks = [time.perf_counter()]
    lat, lon = forcing_mod.point_latlon(bk)
    frc = forcing_mod.Forcing(cell.config["forcing"], lat, lon, seed, period)
    n_real = lat.shape[0]
    marks.append(time.perf_counter())
    prog = Program(bk, frc, device, cache_dir=os.path.join(cache, "program"),
                   fields=fields,
                   second_order=cell.traffic.get("second_order", True))
    marks.append(time.perf_counter())
    for name, (sec, _) in prog.builds.items():
        log(f"built {name} in {sec:.1f} s")
    # the cold start at the sample points, for the check (not set-up)
    t0 = time.perf_counter()
    idx = check_mod.start_points(n_real, seed)
    start_got = prog.take(idx)
    excluded = time.perf_counter() - t0
    clock = Clock(profile=False)
    t0 = time.perf_counter()
    prog.unit(steps, output, clock)
    prog.sync()
    t_window = time.perf_counter()
    setup_s = t_window - t_start - excluded
    # set-up's parts; a run that built the kernel libraries or the host
    # tables (the first in a checkout) is told apart by them
    # (the libraries build side by side: their wall time is the longest)
    builds_s = max((b[0] for b in prog.builds.values()), default=0.0)
    setup = dict(
        imports_s=marks[0] - t_start, forcing_s=marks[1] - marks[0],
        model_s=prog.model_s, builds_s=builds_s,
        tables_built=prog.tables_built,
        rest_s=marks[2] - marks[1] - prog.model_s - builds_s,
        warmup_s=t_window - t0,
        first_in_checkout=bool(prog.builds) or prog.tables_built)
    log(f"set-up {setup_s:.2f} s: " + ", ".join(
        f"{k} {v:.2f}" if isinstance(v, float) else f"{k} {v}"
        for k, v in setup.items()))

    # -- the window --------------------------------------------------------
    clock = Clock(profile=trace)
    n0, tm0 = launch_counts(), timers(prog.model)
    date_s = []
    prof = None
    if trace:
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        prof.__enter__()
        # one small launch first, so that the tracer runs before the window
        torch.ones(1, device=device).add_(1)
        prog.sync()
    @contextlib.contextmanager
    def date():
        prog.sync()
        td = time.perf_counter()
        with mem.around():
            yield
            prog.sync()
        date_s.append(time.perf_counter() - td)

    units, unit_s = 0, []
    gc.collect()
    gc.disable()
    with clock("window"):
        t0 = time.perf_counter()
        while True:
            tu = time.perf_counter()
            prog.unit(steps, output, clock, date)
            units += 1
            unit_s.append(time.perf_counter() - tu)
            if time.perf_counter() - t0 >= seconds:
                break
        prog.sync()
        wall = time.perf_counter() - t0
    gc.enable()
    tr = None
    if trace:
        prof.__exit__(None, None, None)
        tr = trace_mod.from_profiler(prof)
        del prof
    n1, tm1 = launch_counts(), timers(prog.model)
    peak = mem.read()
    bad = guard.forbidden_modules()
    if bad:
        raise RuntimeError(f"modules of the JAX package loaded: {bad}")

    win = dict(units=units, wall_s=wall, steps=units * steps,
               sim_s=units * period, date_s=date_s,
               out_extra=mem.extra if output else [],
               launches={k: n1[k] - n0[k] for k in n1},
               timers={k: tm1[k] - tm0[k] for k in tm1},
               phys_min_steps=units * steps // k_phys - (units if output
                                                         else 0))

    log(f"window {units} units in {wall:.3f} s, peak {peak / GIB:.3f} GiB; "
        "unit s min/median/max " + " ".join(
            f"{v:.4f}" for v in np.quantile(unit_s, [0, 0.5, 1])))
    log("unit s in turn: " + " ".join(f"{v:.4f}" for v in unit_s))
    # -- the subject's outputs after the window ------------------------------
    t_check = time.perf_counter()
    s0 = prog.snapshot()
    subj = dict(s0=s0)
    if control is None:
        prog.model.newwind(prog.model.date)
        prog.model.advance(k_phys)
        subj["s1"] = prog.snapshot()
        if output:
            prog.model.advance(k_phys - 1)
            subj["s2"] = prog.snapshot()
            subj["fields"] = prog.output_date(Clock(profile=False))
            subj["s3"] = prog.snapshot()
            subj["state"] = prog.state_host()
    del prog
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    log(f"subject's outputs {time.perf_counter() - t_check:.1f} s")
    w0 = frc.fields(0)
    if control is not None:
        store = dict(bf16=torch.bfloat16)[control]
        subj = _control_subject(bk, device, cache, frc, s0, store, k_phys,
                                output, fields)
    ref = Reference(bk, device, cache_dir=os.path.join(cache, "reference"),
                    currents=frc.currents0())
    tb = ref.ms.tb
    log(f"reference built {time.perf_counter() - t_check:.1f} s")
    if control is not None:
        ws, wd = check_mod.held_winds(w0, ref.ms.dtype)
        start_got = torch.as_tensor(check_mod.ref_mod.cold_start(
            tb, ws[idx], wd[idx])).to(store).double()
    readings = dict(start_spectrum=check_mod.cold_start_gap(
        start_got, tb, w0["wswave"], w0["wdwave"], idx, ref.ms.dtype))
    stages, detail = check_mod.follow(
        ref, subj, forcing=frc, k_phys=k_phys, idelpro=bk["idelpro"],
        fields=fields, n_real=n_real)
    readings.update(stages)
    for name, d in detail.items():
        top = sorted(d.items(), key=lambda kv: -kv[1][0])[:6]
        log(f"{name} by field (quantile, L2, points over 1e-3): " + ", ".join(
            f"{k} {q:.3e} {l2:.3e} {n}" for k, (q, l2, n) in top))
    data = _data_shares(ref, n_real, seed)
    log(f"check {time.perf_counter() - t_check:.1f} s: {readings}")
    phys = ref.ms.phys
    del ref, subj
    gc.collect()
    checks = {k: dict(value=v, limit=cell.limits[k])
              for k, v in readings.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    result = dict(correct=correct, attempted=units, failed=0)
    e2e = dict(sim_speedup=(win["sim_s"] / wall, "s/s"),
               peak_mem_gib=(peak / GIB, "GiB"), setup_s=(setup_s, "s"))
    ctx = dict(cell=cell, window=win, trace=None, data=data, phys=phys,
               n_real=n_real, config=bk, k_phys=k_phys, output=output,
               fields=fields, passes=_passes(bk),
               currents=bool(cell.config["forcing"].get("currents")))
    if trace:
        ctx["trace"] = tr
        ctx["kernels"] = {k: tr.kernels(m) for k, m in KERNELS.items()}
        ctx["kernel_match"] = lambda s: any(m(s) for m in KERNELS.values())
        ctx["complete"] = all(ctx["kernels"][k][1] == win["launches"][k]
                              for k in KERNELS)
        if not ctx["complete"]:
            log(f"profiler kernel counts { {k: v[1] for k, v in ctx['kernels'].items()} } "
                f"against launches {win['launches']}: kernel metrics not "
                "measured")
        result["metrics"] = _per_layer(cell, ctx)
    else:
        # a metric named <quantity>.<kind> reports <quantity> in the
        # cells its kind lists
        result["metrics"] = {m["name"]: dict(
            value=e2e[m["name"].split(".")[0]][0], unit=m["unit"])
            for m in cell.end_to_end}
    dev = dict(platform="gpu" if device.type == "cuda" else device.type,
               kind=(torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu"),
               count=cell.chips, memory_peak_bytes=int(peak))
    if trace:
        dev["busy_s"] = ctx["trace"].busy_us() * 1e-6
        dev["window_s"] = (ctx["trace"].window[1]
                           - ctx["trace"].window[0]) * 1e-6
        result["breakdown"] = _breakdown(ctx["trace"])
    result["device"] = dev
    result["setup"] = setup
    result["checks"] = checks
    return result


def _control_subject(bk, device, cache, frc, s0, store, k_phys, output,
                     fields) -> dict:
    """The subject's stages computed by the reference with its state held
    in ``store`` (the control)."""
    from wavebench.reference.model import Reference
    ctrl = Reference(bk, device, cache_dir=os.path.join(cache, "reference"),
                     currents=frc.currents0(), store=store)
    h = frc.period(s0["date"].strftime("%Y%m%d%H%M%S"))
    ctrl.put_state(s0["fl1"], s0["stress"])
    ctrl.newwind(frc.fields(h))
    ctrl.advance(k_phys)

    def snap():
        return dict(fl1=ctrl.fl1().cpu(),
                    stress={k: v.cpu() for k, v in ctrl.stress().items()})
    subj = dict(s0=s0, s1=snap())
    if output:
        ctrl.advance(k_phys - 1)
        subj["s2"] = snap()
        state = ctrl.advance(1, full_phys=True)
        subj["s3"] = snap()
        flat = {}
        for k, v in state.items():
            if isinstance(v, dict):
                flat.update({f"sep.{kk}": vv.cpu() for kk, vv in v.items()})
            else:
                flat[k] = v.cpu()
        subj["state"] = flat
        prods = ctrl.products(list(fields), state)
        subj["fields"] = torch.stack([prods[n].cpu() for n in fields])
    del ctrl
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return subj


def _data_shares(ref, n_real: int, seed: int) -> dict:
    """What the physics' work depends on, read by the reference on a
    sample of rows of its last state: the mean frequencies above the cut
    (from MIJ), the windsea share of the bins, the gc wavenumbers summed
    (from u*), the shares of iced and shallow rows."""
    from wavebench.reference.ecw.core.dispersion import BATHYMAX
    from wavebench.reference.ecw.ops.physics import gc as gc_mod
    from wavebench.reference.ecw.ops.physics import implsch_rows as ipk
    fp = ref.fp
    pts = check_mod.start_points(n_real, seed + 1)
    rows = fp.from_srl_pad[torch.as_tensor(pts, device=fp.device)]
    scal = torch.cat([ref.frc6, ref.denv, ref.stress6])[:, rows]
    f, so, t, xllws = ipk.implsch_srl_plain(
        ref.ms.phys, ref.f_srl[rows], ref.env2d[:, rows].contiguous(),
        scal.contiguous(), None if ref.tail is None else ref.tail[rows],
        nang=fp.nang, nfre_red=fp.nfre_red, full=True)
    st = ipk.unpack_scal_out(so, full=True)
    tb = ref.ms.tb
    return dict(
        above_cut=tb.nfre - 1 - float(st["mij"].double().mean()),
        windsea=float(xllws.double().mean()),
        gc_terms=work.gc_terms(st["ufric"].cpu(), gc_mod),
        ice=float((scal[5] > 0).double().mean()),
        shallow=float((ref.denv[0][rows] < BATHYMAX).double().mean()))


def _per_layer(cell, ctx: dict) -> dict:
    out = {}
    for m in cell.per_layer:
        v = spec.metric_reader(m["name"])(ctx)
        if v is not None:
            out[m["name"]] = dict(value=v, unit=m["unit"])
    return out


def _breakdown(tr) -> dict:
    ops, gaps = {}, {}
    for o in tr.ops:
        ops[o.name] = ops.get(o.name, 0.0) + o.dur * 1e-6
    for name, us in tr.idle_gaps():
        key = name or "outside spans"
        gaps[key] = gaps.get(key, 0.0) + us * 1e-6

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                [:10]]
    return dict(device_ops=top(ops), idle_gaps=top(gaps))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m wavebench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", choices=("bf16",), default=None)
    a = p.parse_args(argv)
    root = os.getcwd()
    # every build and kernel cache at a fixed path inside the checkout (the
    # port's own libraries build into build/ecwam_tpu_torch/ there)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(root, "wavebench", ".cache", sub)
    path = os.path.join(root, "BENCHMARK.json")
    if not os.path.exists(path):
        print(f"no BENCHMARK.json in {root}", file=sys.stderr)
        return 2
    bench = spec.load_json(path)
    cell = spec.find_cell(bench, a.workload,
                          os.path.join(root, "wavebench"))
    if not torch.cuda.is_available() or (torch.cuda.device_count()
                                         < cell.chips):
        print(f"{a.workload} needs {cell.chips} CUDA device(s); "
              f"available: {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 3
    bad = guard.forbidden_modules()
    if bad:
        print(f"modules of the JAX package loaded: {bad}", file=sys.stderr)
        return 4
    torch.set_num_threads(4)
    res = run_cell(cell, seed=a.seed, seconds=a.seconds, trace=bool(a.trace),
                   device="cuda", root=root, control=a.control)
    bad = guard.forbidden_modules()
    if bad:
        print(f"modules of the JAX package loaded: {bad}", file=sys.stderr)
        return 4
    for name, c in res["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
