"""Command-line programs: the ecwam-preproc / ecwam-preset / ecwam-chief
(run) / validation surface of the reference (src/programs/*.F90 +
share/ecwam/scripts/ecwam_run_{preproc,preset,model}.sh), driven by the
same YAML run-config schema.

Port of ``ecwam_tpu/cli/main.py``.  The run loop takes the SRL-resident
``FastWaveModel`` for ``weights_mode: fused`` (the default; kernels A and
B on the card), on the card and on the CPU alike, where the reference
takes it only on a Pallas backend; and the dense ``WaveModel`` for
``weights_mode: cached`` or ``otf`` (its physics through kernel C on the
card), as the reference does.  On the CPU the wrappers run the kernels'
plain versions.

Usage:
  python -m ecwam_tpu_torch preproc --config cfg.yml --rundir RUN
  python -m ecwam_tpu_torch preset  --config cfg.yml --rundir RUN [--swell]
  python -m ecwam_tpu_torch run     --config cfg.yml --rundir RUN [--validate]
                                    [--trace FILE]
  python -m ecwam_tpu_torch validate --config cfg.yml --rundir RUN
  python -m ecwam_tpu_torch info

``--device cpu`` runs on the CPU; the default is the card, and a run
that asked for it fails where CUDA is absent.  Boundary nesting: a
``nesting: coarse: rect: [S, N, W, E]`` block writes the coarse run's
boundary spectra to ``wam_boundary.npz`` at the output dates, ``nesting:
fine: file: F`` (F relative to the run directory) overwrites the fine
run's rim after every advection step, and ``bouint --input F --output G
--timestep S`` interpolates a boundary file in time.  The swell-train
fields (``p042``-``p050``) need the dense ``WaveModel``'s per-bin windsea
mask: the fused route refuses them, as the reference's chunked output
path does.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import datetime as _dt
import json
import os
import re
import signal
import subprocess
import sys
import time

import numpy as np

from ecwam_tpu_torch.config.schema import RunConfig, DATE_FMT

def _fmt14(d: _dt.datetime) -> str:
    return d.strftime(DATE_FMT)


class BathymetryUnavailable(RuntimeError):
    """Raised when a config requests real bathymetry that cannot be built.

    The reference preproc aborts when wam_topo is missing (preproc.F90
    TOPOAR read); a silent aqua fallback would make every downstream
    validation meaningless, so this is a hard error.
    """


def _resolve_bathymetry(cfg: RunConfig, rundir: str | None = None):
    """Resolve the config's bathymetry request to (bathy, obstructions).

    Accepted values of ``cfg.bathymetry``:
      'aqua'            — aqua planet (land polar rows only)
      <path>.npz        — either preprocessed grid tables (fields bathy /
                          kobslat / kobslon / kobscor) or raw topo data
                          (fields invres / elev) that is preprocessed here
      'ETOPO1'          — looks for ETOPO1.npz / wam_topo.npz in rundir
    Raises BathymetryUnavailable instead of falling back.
    """
    if cfg.bathymetry == "aqua":
        return None, None
    candidates = [cfg.bathymetry]
    if rundir:
        candidates.append(os.path.join(rundir, cfg.bathymetry))
        candidates.append(os.path.join(rundir, "wam_topo.npz"))
    if cfg.bathymetry.upper().startswith("ETOPO"):
        for d in filter(None, (rundir, ".")):
            candidates += [os.path.join(d, "ETOPO1.npz"),
                           os.path.join(d, "wam_topo.npz")]
    path = next((p for p in candidates
                 if p.endswith(".npz") and os.path.exists(p)), None)
    if path is None:
        raise BathymetryUnavailable(
            f"bathymetry {cfg.bathymetry!r} requested but no input data "
            f"found (searched {candidates}); provide a topo .npz "
            "(fields invres/elev) or preprocessed tables "
            "(bathy/kobslat/kobslon/kobscor), or set 'bathymetry: aqua'")
    with np.load(path) as z:
        if "bathy" in z:
            obs = None
            if "kobslat" in z:
                obs = dict(kobslat=z["kobslat"], kobslon=z["kobslon"],
                           kobscor=z["kobscor"])
            return np.asarray(z["bathy"]), obs
    # raw topo: run the full preprocessor
    from ecwam_tpu_torch.core import bathy as bathy_mod
    from ecwam_tpu_torch.core.spectral import build_spectral_tables
    grid = _grid_from_cfg(cfg)
    tb = build_spectral_tables(nang=cfg.directions, nfre=cfg.frequencies)
    topo = bathy_mod.load_topo(path)
    b, obs = bathy_mod.make_bathymetry(
        topo, grid, tb.fr, cfg.build_kwargs().get("nfre_red")
        or cfg.frequencies)
    return b, obs


def _grid_from_cfg(cfg: RunConfig):
    from ecwam_tpu_torch.core.grid import octahedral_grid, regular_grid
    if cfg.grid.startswith("O"):
        return octahedral_grid(int(cfg.grid[1:]))
    return regular_grid(float(cfg.grid))


def _build_model(cfg: RunConfig, dtype=None, rundir: str | None = None,
                 device=None):
    import torch
    from ecwam_tpu_torch.core import bathy as bathy_mod
    from ecwam_tpu_torch.model import setup as setup_mod
    kw = cfg.build_kwargs()
    b, obs = _resolve_bathymetry(cfg, rundir)
    if b is not None:
        kw["bathy"] = b
    if obs is not None:
        grid = _grid_from_cfg(cfg)
        from ecwam_tpu_torch.core.grid import build_sea_point_block
        blk = build_sea_point_block(grid, b)
        kw["obstructions"] = bathy_mod.obstructions_to_block(obs, blk)
    return setup_mod.build_model(dtype=dtype or torch.float32,
                                 device=device, **kw)


def _forcing_provider(cfg: RunConfig, ms, rundir: str):
    from ecwam_tpu_torch.io import forcing as forcing_mod
    lat = np.asarray(ms.grid.lats)[ms.blk.kxlt]
    lon = ms.grid.amowep + ms.blk.ixlg * ms.grid.zdello[ms.blk.kxlt]
    path = cfg.forcings_file
    if path and not os.path.isabs(path) and rundir:
        cand = os.path.join(rundir, path)
        if os.path.exists(cand):
            path = cand
    if path and os.path.exists(path):
        ff = forcing_mod.ForcingFile.load(path)
    else:
        if path:
            print(f"[ecwave] forcing file {path!r} not found "
                  "— using synthetic analytic winds", file=sys.stderr)
        dates = cfg.forcing_dates() or [cfg.begin]
        times14 = [int(_fmt14(d)) for d in dates]
        ff = forcing_mod.synthetic_forcing_file(times14)
    return ff.provider(lat, lon)


def load_config(path: str) -> RunConfig:
    """Load a run config from YAML or a Fortran namelist (MPUSERIN
    surface): a file containing an &NALINE group is parsed by
    config.namelist; anything else by the YAML schema."""
    try:
        with open(path) as f:
            text = f.read()
    except OSError:
        text = path
    if re.search(r"&NALINE\b", text, re.IGNORECASE):
        from ecwam_tpu_torch.config import namelist as _nml
        return _nml.namelist_to_config(text).run
    return RunConfig.from_yaml(path)


def _host(v) -> np.ndarray:
    """A tensor on any device (or an array) as a numpy array."""
    if hasattr(v, "detach"):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def cmd_preproc(args):
    """Grid/bathymetry preprocessing → wam_grid_tables.npz equivalent.

    Builds the sea-point block AND, for real bathymetry, the per-direction
    sub-grid obstruction tables (preproc.F90 TOPOAR/MGRID/MUBUF chain).
    Hard-fails when the requested bathymetry input is missing.
    """
    cfg = load_config(args.config)
    b, obs = _resolve_bathymetry(cfg, args.rundir)
    ms = _build_model(cfg, rundir=args.rundir, device=args.device)
    os.makedirs(args.rundir, exist_ok=True)
    fn = os.path.join(args.rundir, "wam_grid_tables.npz")
    extra = {}
    if b is not None:
        extra["bathy"] = b
    if obs is not None:
        extra.update(obs)
    np.savez_compressed(
        fn, grid=cfg.grid, nang=cfg.directions, nfre=cfg.frequencies,
        nsea=ms.blk.nsea, ixlg=ms.blk.ixlg, kxlt=ms.blk.kxlt,
        depth=ms.blk.depth, nlonrgg=ms.grid.nlonrgg,
        xdella=ms.grid.xdella, zdello=ms.grid.zdello,
        amowep=ms.grid.amowep, amosop=ms.grid.amosop, **extra)
    print(f"wrote {fn} ({ms.blk.nsea} sea points)")
    return 0


def cmd_preset(args):
    """Cold start: JONSWAP spectra from the first wind field → restart."""
    import torch
    from ecwam_tpu_torch.io import restart as restart_mod
    from ecwam_tpu_torch.model import preset as preset_mod
    from ecwam_tpu_torch.model import stepper as stepper_mod
    from ecwam_tpu_torch.model.setup import pad_point_field

    cfg = load_config(args.config)
    ms = _build_model(cfg, rundir=args.rundir, device=args.device)
    provider = _forcing_provider(cfg, ms, args.rundir)
    date14 = _fmt14(cfg.begin)
    raw = provider(date14)
    # the forcing as the model holds it (its dtype), like the reference
    frc = {k: _host(torch.as_tensor(
        pad_point_field(ms, np.asarray(v, np.float64)), dtype=ms.dtype))
        for k, v in raw.items()}
    if getattr(args, "swell", False):
        # MSWELL path (preset.F90:657): swell-only cold start
        lat = np.asarray(ms.grid.lats)[ms.blk.kxlt]
        lon = ms.grid.amowep + ms.blk.ixlg * ms.grid.zdello[ms.blk.kxlt]
        fl1 = preset_mod.mswell(
            ms.tb, np.concatenate([lat, lat[:1].repeat(ms.n_pad - len(lat))]),
            np.concatenate([lon, lon[:1].repeat(ms.n_pad - len(lon))]))
    else:
        fl1 = preset_mod.mstart(ms.tb, frc["wswave"], frc["wdwave"])
    stress = {k: _host(v)
              for k, v in stepper_mod.initial_stress(ms, frc).items()}
    os.makedirs(args.rundir, exist_ok=True)
    fn = restart_mod.save_restart(args.rundir, date14, fl1, stress, frc)
    print(f"wrote {fn}")
    return 0


def _seconds(key: str):
    return property(lambda self: self.tallies[key].seconds,
                    doc=f"seconds of the {key} spans")


class OutputTimers:
    """Where an output date's time goes (outside the full-mode physics
    step, which the model's StepTimers count), the seconds of the run
    loop's spans: device time between CUDA events on the card (never
    waited on while running), host time on the CPU and for the host's
    own work.  The catalog (``output.products``, less the second-order
    correction inside it), the second-order correction
    (``output.secondorder``), the device-to-host copy of the fields
    (``output.d2h``), and the statistics/GRIB/FDB write (``output.write``,
    host); the restarts written (``restart``, host); with nesting, the
    fine rim's writes (``rim``, one an advection step) and the coarse
    boundary records (``boundary``, one an output date)."""

    secondorder = _seconds("secondorder")
    d2h = _seconds("d2h")
    write = _seconds("write")
    restart = _seconds("restart")
    rim = _seconds("rim")
    boundary = _seconds("boundary")

    def __init__(self):
        from ecwam_tpu_torch.tracing import Tally
        self.tallies = {k: Tally() for k in (
            "products", "secondorder", "d2h", "write", "restart", "rim",
            "boundary")}
        self.dates = self.restarts = self.rims = 0

    @property
    def products(self) -> float:
        return self.tallies["products"].seconds - self.secondorder


def _refuse_unported(cfg: RunConfig, names) -> None:
    from ecwam_tpu_torch.io import products as products_mod
    trains = sorted(set(names) & products_mod.TRAIN_FIELDS)
    if trains and cfg.build_kwargs()["weights_mode"] == "fused":
        raise NotImplementedError(
            f"swell-train output fields {trains} need the per-bin windsea "
            "mask, which the fused route's chunked full-mode step does not "
            "keep: run weights_mode cached or otf")


@contextlib.contextmanager
def _stop_on_signals():
    """Signal-triggered graceful stop (wamodel.F90:317-329 LDSTOP/LDWRRE,
    runwam.F90:357): while open, SIGTERM/SIGINT set the yielded flag
    instead of ending the process; the run loop then finishes its
    advection step, writes a restart and waminfo, and returns.  Installed
    before the model is built, so that a signal during set-up is not
    lost either."""
    stop = {"flag": False}

    def _request_stop(signum, frame):
        stop["flag"] = True
    old = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            old[sig] = signal.signal(sig, _request_stop)
        except ValueError:            # non-main thread
            pass
    try:
        yield stop
    finally:
        for sig, h in old.items():
            signal.signal(sig, h)


def run_model(cfg: RunConfig, rundir: str, *, dtype=None, quiet=False,
              device=None, plain: bool = False,
              timers: OutputTimers | None = None):
    """The WAMODEL/WAMINTGR date loop with output & restart scheduling.

    ``device``: ``None`` (the card) or ``"cpu"``; ``plain=True`` runs the
    plain PyTorch versions of the kernels; ``timers`` collects the output
    dates' split.  Returns (model, statistics log)."""
    with _stop_on_signals() as stop:
        return _run_model(cfg, rundir, stop, dtype=dtype, quiet=quiet,
                          device=device, plain=plain, timers=timers)


def _run_model(cfg, rundir, stop_requested, *, dtype, quiet, device, plain,
               timers):
    import torch
    from ecwam_tpu_torch.io import norms as norms_mod
    from ecwam_tpu_torch.io import outcontrol
    from ecwam_tpu_torch.io import products as products_mod
    from ecwam_tpu_torch.io import restart as restart_mod
    from ecwam_tpu_torch.model import driver as driver_mod
    from ecwam_tpu_torch.model import nesting as nesting_mod
    from ecwam_tpu_torch.model.setup import pad_point_field
    from ecwam_tpu_torch.tracing import span

    names = cfg.output_fields.names if cfg.output_fields else ("swh",)
    _refuse_unported(cfg, names)
    os.makedirs(rundir, exist_ok=True)
    ms = _build_model(cfg, dtype=dtype, rundir=rundir, device=device)
    dev = ms.device
    provider = _forcing_provider(cfg, ms, rundir)
    timers = timers if timers is not None else OutputTimers()

    # resume from a restart at `begin` if present (GETSPEC role)
    fl1 = stress = None
    rst = os.path.join(rundir, restart_mod.restart_name(_fmt14(cfg.begin)))
    if os.path.exists(rst):
        data = restart_mod.load_restart(rst, nang=ms.tb.nang, nfre=ms.tb.nfre)

        def adapt(v):
            """Restart files may hold n_real or any padded width
            (layout-independent restore, getspec.F90 redistribution role)."""
            v = np.asarray(v, np.float64)
            if v.shape[-1] == ms.n_pad:
                return v
            return pad_point_field(ms, v[..., : ms.n_real])

        fl1 = adapt(data["fl1"])
        if data["stress"]:
            stress = {k: adapt(v) for k, v in data["stress"].items()}
        if not quiet:
            print(f"[ecwave] resumed from {rst}")

    # the SRL-resident fast driver for the fused weights (wamodel.F90
    # output-date split: minimal physics between output dates, full
    # diagnostics on output dates); the dense WaveModel for cached/otf
    # (full physics on every physics step)
    fast = ms.weights_mode == "fused"
    model_cls = driver_mod.FastWaveModel if fast else driver_mod.WaveModel
    model = model_cls(ms, provider, cfg.begin, fl1=fl1, stress=stress,
                      plain=plain)
    if not quiet:
        kernels = "kernels A and B" if fast else "kernel C"
        print(("[ecwave] SRL-resident fast driver" if fast else
               f"[ecwave] dense WaveModel ({ms.weights_mode} weights)")
              + f" on {dev} (" + ("plain PyTorch versions" if plain
                                   or dev.type == "cpu" else kernels) + ")")

    # CHECKCFL role (checkcfl.F90:74-210, called from the propagation
    # setup): validate the Courant numbers once per weight refresh and
    # abort with the reference's remedy when violated
    cfl = model.fp.cfl_diagnostics if fast else model.steps.cfl_diagnostics
    if cfl is not None:
        diag = cfl()
        if not quiet:
            print(f"[ecwave] CFL: x={diag['cfl_east_west']:.3f} "
                  f"y={diag['cfl_north_south']:.3f} "
                  f"outflow={diag['max_outflow']:.3f} "
                  f"violations={diag['n_violations']}")
        if diag["n_violations"]:
            raise RuntimeError(
                "CFL-CRITERION NOT FULFILLED FOR PROPAGATION "
                f"({diag['n_violations']} points, max outflow "
                f"{diag['max_outflow']:.3f}) - REDUCE IDELPRO "
                "ACCORDINGLY (checkcfl.F90)")

    # boundary nesting (IBOUNC/IBOUNF roles): the coarse side collects the
    # boundary points' spectra at output dates (OUTBC), the fine side
    # overwrites its rim in place after each advection step (BOUINPT)
    nest = (cfg.raw.get("nesting") or {}) if isinstance(cfg.raw, dict) \
        else {}
    bc_writer = bc_file = fine_tab = None
    if nest.get("coarse"):
        rect = [float(x) for x in nest["coarse"]["rect"]]
        cb = nesting_mod.coarse_boundary(ms.grid, ms.blk, *rect)
        bc_writer = nesting_mod.BoundaryWriter(cb, ms.tb)
        if not quiet:
            print(f"[ecwave] coarse nesting: {cb.idx.size} boundary "
                  "points (MBOUNC)")
    if nest.get("fine"):
        path = nest["fine"]["file"]
        if not os.path.isabs(path):
            path = os.path.join(rundir, path)
        bc_file = nesting_mod.BoundaryFile(path, ms.tb, device=dev)
        fine_tab = nesting_mod.fine_boundary(ms.grid, ms.blk,
                                             bc_file.coarse_boundary())
        if not quiet:
            print(f"[ecwave] fine nesting: {fine_tab.idx.size} rim "
                  f"points from {path} (MBOUNF)")

    tal = timers.tallies

    def write_rim(date):
        with span("rim", dev, (tal["rim"],)):
            model.put_points(fine_tab.idx, nesting_mod.boundary_spectra(
                bc_file, fine_tab, _fmt14(date)))
        timers.rims += 1

    def add_boundary(date):
        with span("boundary", dev, (tal["boundary"],)):
            bc_writer.add(_fmt14(date), model.take_points(bc_writer.cb.idx))

    out_dates = set(cfg.output_dates())
    frc_dates = set(cfg.forcing_dates())
    rst_dates = set(cfg.restart_times)

    # FFLAG/GFLAG/NFLAG output control (mpcrtbl.F90/userin.F90 roles)
    oc = outcontrol.OutputControl.from_names(
        [n for n in names if n in outcontrol.BY_NAME
         or n in outcontrol._ALIASES],
        fmt=(cfg.output_fields.format if cfg.output_fields else "grib"),
        grib_restart=(cfg.restart_format == "grib"))
    if cfg.output_fields and cfg.output_fields.windows:
        oc.check_output_interval(cfg.output_fields.windows[0].timestep,
                                 cfg.adv_timestep, cfg.phys_timestep)
    known = [n for n in oc.output_names() if n in products_mod.CATALOG]
    norm_set = set(oc.norm_names())
    grib_set = set(oc.grib_names()) | set(oc.file_names())
    licerun = cfg.forcings_file is not None

    log = norms_mod.StatisticsLog()
    saved = []

    grib_out = (cfg.output_fields is not None
                and cfg.output_fields.format == "grib")
    encoders = concurrent.futures.ThreadPoolExecutor(
        max_workers=min(8, os.cpu_count() or 1))
    # LFDB path (wam_multio_mod.F90 role): GRIB messages to the keyed
    # FDB-lite sink instead of per-date MPP files
    fdb_sink = None
    if (cfg.output_fields is not None
            and cfg.output_fields.format == "fdb"):
        from ecwam_tpu_torch.io import multio as multio_mod
        fdb_sink = multio_mod.MultioSink(os.path.join(rundir, "fdb"))

    # second-order correction of the output spectrum (outblock.F90:173;
    # LSECONDORDER defaults true, mpuserin.F90:594).  Output-side only —
    # the prognostic state is never modified.
    so_correct = None
    if cfg.lsecondorder and known:
        from ecwam_tpu_torch.ops import secondorder as so_mod
        so_tables = so_mod.build_second_order_tables(ms.tb)
        so_dev = so_mod.device_tables(so_tables, ms.env["depth"])

        def so_correct(fl, wavnum, depth):
            with span("output.secondorder", dev, (tal["secondorder"],)):
                return so_mod.cal_second_order_spec(
                    fl, wavnum, depth, ms.tb, so_tables, sig=1.0,
                    tabs=so_dev)

    # output-path point blocking: above this size the compact spectrum
    # is pulled per chunk (outblock.F90's NPROMA role) — the whole
    # field would not fit next to the resident SRL state at O512+
    chunk_threshold = int(os.environ.get("ECWAVE_OUTPUT_CHUNK_ABOVE",
                                         str(1 << 18)))

    def do_output(date):
        d14 = _fmt14(date)
        state = {**model.state, **model.stress}
        # the second-order correction runs inside the products' span
        with span("output.products", dev, (tal["products"],)):
            if fast and ms.n_pad > chunk_threshold:
                so_fn = None
                if so_correct is not None:
                    def so_fn(fl, env_c):
                        return so_correct(fl, env_c["wavnum"],
                                          env_c["depth"])
                fields = products_mod.compute_chunked(
                    known, model.fl1_chunk, ms.n_pad, ms.tb, state,
                    model.frc, ms.phys.params, env=ms.env,
                    llgcbz0=ms.phys.params.llgcbz0, so_correct=so_fn)
            else:
                fl_out = model.fl1
                if so_correct is not None:
                    fl_out = so_correct(fl_out, ms.env["wavnum"],
                                        ms.env["depth"])
                fields = products_mod.compute(
                    known, fl_out, ms.tb, state, model.frc, ms.phys.params,
                    env=ms.env, llgcbz0=ms.phys.params.llgcbz0)
        with span("output.d2h", dev, (tal["d2h"],)):
            stacked = torch.stack([fields[n][: ms.n_real].to(ms.dtype)
                                   for n in known]) if known else None
            host_all = _host(stacked) if known else None
            host = {n: host_all[i] for i, n in enumerate(known)}
            cicover = _host(model.frc["cicover"])[: ms.n_real]
        with span("output.write", into=(tal["write"],)):
            write_date(d14, host, cicover)
        timers.dates += 1

    def write_date(d14, host, cicover):
        # OUTSETWMASK: ice/shallow masking of flagged output params
        host = outcontrol.apply_output_masks(host, cicover=cicover,
                                             licerun=licerun)
        for n in known:
            if n in norm_set:
                log.add(n, d14, host[n],
                        missing_mask=(host[n] == outcontrol.c.ZMISS))
        if grib_out:
            # gribout.write_fields' messages, encoded in threads (the
            # codec releases the interpreter lock), appended in order
            from ecwam_tpu_torch.io import gribout
            items = [(n, v) for n, v in host.items() if n in grib_set]
            msgs = encoders.map(lambda nv: gribout.encode_field(
                nv[0], nv[1], ms.blk, ms.grid, d14), items)
            with open(os.path.join(rundir, f"MPP{d14}.grib"), "ab") as f:
                for m in msgs:
                    f.write(m)
        if fdb_sink is not None:
            from ecwam_tpu_torch.io import multio as multio_mod
            multio_mod.write_fields_to_sink(
                fdb_sink, {n: v for n, v in host.items()
                           if n in grib_set},
                ms.blk, ms.grid, d14)

    def save(date):
        with span("restart", into=(tal["restart"],)):
            fn = restart_mod.save_restart(
                rundir, _fmt14(date), _host(model.fl1),
                {k: _host(v) for k, v in model.stress.items()},
                {k: _host(v) for k, v in model.frc.items()})
        timers.restarts += 1
        return fn

    t_wall = time.perf_counter()
    step = _dt.timedelta(seconds=cfg.adv_timestep)
    date = cfg.begin
    try:
        # step 0 output (OUTSTEP0, initmdl.F90:1101)
        if cfg.begin in out_dates or not out_dates:
            do_output(cfg.begin)
        while date < cfg.end:
            nxt = date + step
            model.advance(1, full_phys=(nxt in out_dates))
            if bc_file is not None:
                write_rim(nxt)
            if nxt in frc_dates:
                model.newwind(nxt)        # NEWWIND swap incl. the TAUW cap
            if nxt in out_dates:
                do_output(nxt)
                if bc_writer is not None:
                    add_boundary(nxt)
            if nxt in rst_dates:
                saved.append(save(nxt))
            date = nxt
            if stop_requested["flag"]:
                saved.append(save(date))
                from ecwam_tpu_torch.io import waminfo as waminfo_mod
                waminfo_mod.write_waminfo(
                    os.path.join(rundir, "waminfo"),
                    begin14=_fmt14(cfg.begin), end14=_fmt14(cfg.end),
                    restart_date14=_fmt14(date),
                    last_spectra_date14=_fmt14(date))
                if not quiet:
                    print(f"[ecwave] signal received: wrote restart at "
                          f"{_fmt14(date)} and stopping")
                break
    finally:
        encoders.shutdown()
        if fdb_sink is not None:
            fdb_sink.close()

    if bc_writer is not None and bc_writer.dates:
        bc_path = os.path.join(rundir, "wam_boundary.npz")
        bc_writer.save(bc_path)
        if not quiet:
            print(f"[ecwave] wrote boundary file {bc_path} "
                  f"({len(bc_writer.dates)} dates)")

    wall = time.perf_counter() - t_wall
    log_path = os.path.join(rundir, "statistics.log")
    log.write(log_path)
    if not quiet:
        tm = model.timers
        print(f"[ecwave] {tm.steps} steps in {wall:.2f}s wall "
              f"(propag {tm.propag:.2f}s, phys {tm.phys:.2f}s; output "
              f"products {timers.products:.2f}s, second order "
              f"{timers.secondorder:.2f}s, copies {timers.d2h:.2f}s, "
              f"write {timers.write:.2f}s); wrote {log_path}" +
              (f"; restarts: {', '.join(saved)}" if saved else ""))
    return model, log


def cmd_run(args):
    cfg = load_config(args.config)
    if args.trace:
        from ecwam_tpu_torch import tracing
        tracing.start()
        try:
            _, log = run_model(cfg, args.rundir, device=args.device)
        finally:
            tracing.stop()
            tracing.write_chrome(args.trace)
        print(f"[ecwave] wrote trace {args.trace}")
    else:
        _, log = run_model(cfg, args.rundir, device=args.device)
    if args.validate:
        return _validate(cfg, log.entries)
    return 0


def _validate(cfg: RunConfig, entries) -> int:
    from ecwam_tpu_torch.io import norms as norms_mod
    block = cfg.validation.get("single_precision") or \
        cfg.validation.get("double_precision") or []
    rep = norms_mod.validate_report(entries, block)
    if rep["failures"]:
        for f in rep["failures"]:
            print("VALIDATION FAIL:", json.dumps(f, default=str))
        return 1
    print(f"validation OK ({rep['passed']} checks, "
          f"{rep['bit_identical']}/{rep['passed']} bit identical with "
          "recorded results)")
    return 0


def cmd_validate(args):
    cfg = load_config(args.config)
    entries = []
    with open(os.path.join(args.rundir, "statistics.log")) as f:
        for line in f:
            if line.startswith("#"):
                continue
            p = line.split()
            entries.append(dict(
                time=p[0], index=int(p[1]), name=p[2],
                average=float(p[3]), minimum=float(p[5]),
                maximum=float(p[7]), non_missing_points=int(p[9])))
    return _validate(cfg, entries)


def cmd_bouint(args):
    """bouint program role (bouint.F90:19-23): time-interpolate a
    coarse boundary file to a finer cadence (INTSPEC on ``--device``,
    the card by default)."""
    from ecwam_tpu_torch.core import spectral
    from ecwam_tpu_torch.model import nesting as nesting_mod
    from ecwam_tpu_torch.model.driver import parse_date, format_date
    z = np.load(args.input)
    nfre = int(z["fr"].shape[0])
    nang = int(z["th"].shape[0])
    tb = spectral.build_spectral_tables(nang, nfre)
    bf = nesting_mod.BoundaryFile(args.input, tb, device=args.device)
    cb = bf.coarse_boundary()
    wr = nesting_mod.BoundaryWriter(cb, tb)
    t = parse_date(str(bf.dates[0]))
    end = parse_date(str(bf.dates[-1]))
    step = _dt.timedelta(seconds=float(args.timestep))
    while t <= end:
        d14 = format_date(t)
        spec_t, _ = bf.at(d14)
        wr.add(d14, spec_t.permute(1, 2, 0))
        t += step
    wr.save(args.output)
    print(f"[ecwave] bouint: {len(wr.dates)} records -> {args.output}")
    return 0


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    return (out.stdout.strip().splitlines() or ["no card listed"])[0]


def cmd_info(args):
    import torch
    print("ecwave (ecwam_tpu_torch) — spectral wave model, PyTorch/CUDA port")
    print("capabilities: CTU propagation (IPROPAGS=2; fused kernel A or the")
    print("  cached/on-the-fly dense weights), IPHYS∈{0,1} IMPLSCH physics")
    print("  (kernels B and C), U10 and u* forcing, DIA nonlinear transfer,")
    print("  depth/current refraction (IREFRA≤3), fast-wave substepping,")
    print("  output catalog with the second-order correction and the swell")
    print("  trains, statistics.log norms, GRIB/FDB output, npz restart/forcing")
    cuda = torch.cuda.is_available()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"available: {cuda}, devices: "
          f"{torch.cuda.device_count() if cuda else 0}")
    if cuda:
        print(f"card: {card_line()}")
    return 0


def main(argv=None):
    p = argparse.ArgumentParser(prog="ecwave")
    sub = p.add_subparsers(dest="cmd", required=True)
    for name, fn, needs_cfg in (
            ("preproc", cmd_preproc, True), ("preset", cmd_preset, True),
            ("run", cmd_run, True), ("validate", cmd_validate, True),
            ("bouint", cmd_bouint, False),
            ("info", cmd_info, False)):
        sp = sub.add_parser(name)
        sp.set_defaults(fn=fn)
        if needs_cfg:
            sp.add_argument("--config", required=True)
            sp.add_argument("--rundir", default="run")
        if name in ("preproc", "preset", "run", "bouint"):
            sp.add_argument("--device", default=None,
                            help="'cpu' or 'cuda' (default: the card)")
        if name == "run":
            sp.add_argument("--validate", action="store_true")
            sp.add_argument("--trace", default=None, metavar="FILE",
                            help="write the run's spans to FILE as a "
                                 "Chrome trace (Perfetto loads it)")
        if name == "bouint":
            sp.add_argument("--input", required=True)
            sp.add_argument("--output", required=True)
            sp.add_argument("--timestep", required=True,
                            help="output cadence in seconds")
        if name == "preset":
            sp.add_argument("--swell", action="store_true",
                            help="MSWELL swell-only cold start "
                                 "(preset.F90:657)")
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
