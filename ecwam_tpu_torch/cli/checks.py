"""The command line's run path, checked: configurations and comparisons
shared by ``chip_smoke.py`` (on the card) and the tests (on the CPU).

  * :func:`run_yaml` writes a run config: hourly winds from a forcing
    file (:func:`write_forcing`, the reference's synthetic analytic field,
    so that a run resumed from a restart reads the winds of the
    uninterrupted run), every output field of :data:`FIELDS` hourly from
    1 h (before the first physics step the state holds no fluxes, in the
    reference too), GRIB output, the second-order correction and
    restart dates;
  * :func:`expected_launches` counts the kernel launches the date loop
    implies;
  * :func:`stats_error` compares two statistics logs, and
    :func:`restarts_equal` two restart files bit for bit;
  * :func:`products_vs_f64` evaluates the catalog on a chunk of points
    of a model's state on its device, and again in float64 on the CPU,
    holding out the points on a float32 decision edge.
"""

from __future__ import annotations

import datetime as _dt
import math

import numpy as np
import torch

from ecwam_tpu_torch.config.schema import RunConfig
from ecwam_tpu_torch.io import extremes
from ecwam_tpu_torch.io import forcing as forcing_mod
from ecwam_tpu_torch.io import outcontrol
from ecwam_tpu_torch.io import products as products_mod
from ecwam_tpu_torch.ops import secondorder as so_mod

# every output field that outcontrol knows and the catalog computes,
# swell trains aside (the fused route does not take them)
FIELDS = tuple(p.name for p in outcontrol.PARAMS
               if p.name in products_mod.CATALOG
               and p.name not in products_mod.TRAIN_FIELDS)
TRAINS = tuple(sorted(products_mod.TRAIN_FIELDS))
# output directions, in degrees: compared on the circle
DIRECTIONS = frozenset(("mwd", "mdww", "mdts", "dwi", "p063"))
# fields of the kurtosis chain, held out at its decision edges
KURTOSIS_FIELDS = frozenset(("wsk", "bfi", "wsp", "hmax", "tmax", "p057",
                             "p070", "p071", "p072"))
BEGIN = _dt.datetime(2023, 1, 1)


def write_forcing(path: str, hours: int) -> str:
    """The reference's synthetic analytic winds, hourly for 0..hours, as a
    forcing file."""
    forcing_mod.synthetic_forcing_file(
        [int((BEGIN + _dt.timedelta(hours=h)).strftime("%Y%m%d%H%M%S"))
         for h in range(hours + 1)]).save(path)
    return path


def _t(hours: float) -> str:
    return (BEGIN + _dt.timedelta(hours=hours)).strftime("%Y-%m-%d %H:%M:%S")


def run_yaml(*, grid: str, directions: int, frequencies: int,
             physics_frequencies: int | None = None, adv: float, phys: float,
             hours: int, forcing: str, restarts=(), begin: float = 0.0,
             fields=FIELDS, lsecondorder: bool = True,
             weights_mode: str | None = None) -> str:
    """A run config from ``begin`` to ``hours`` (hours after 2023-01-01).

    ``frequencies`` is the advected count when ``physics_frequencies``
    gives the physics count (the reference run script's split);
    ``weights_mode`` (``cached``/``otf``) selects the dense model."""
    pf = (f"physics_frequencies: {physics_frequencies}\n"
          if physics_frequencies else "")
    if weights_mode:
        pf += f"weights_mode: {weights_mode}\n"
    rst = "".join(f"          - time: {_t(h)}\n" for h in restarts)
    return (f"grid: {grid}\ndirections: {directions}\n"
            f"frequencies: {frequencies}\n{pf}bathymetry: aqua\n"
            f"advection:\n    timestep: {adv}\n"
            f"physics:\n    timestep: {phys}\n"
            f"begin: {_t(begin)}\nend: {_t(hours)}\n"
            f"lsecondorder: {'T' if lsecondorder else 'F'}\n"
            f"forcings:\n    file: {forcing}\n    at:\n"
            f"      - begin: {_t(0)}\n        end: {_t(hours)}\n"
            f"        timestep: 01:00\n"
            f"output:\n    fields:\n"
            f"        name: [{', '.join(fields)}]\n"
            f"        format: grib\n        at:\n"
            f"          - begin: {_t(max(begin, 0.0) + 1.0)}\n"
            f"            timestep: 01:00\n"
            + (f"    restart:\n        at:\n{rst}" if rst else ""))


def expected_launches(cfg: RunConfig, ms, nsub: int,
                      chunk: int = 65536) -> dict:
    """Kernel launches of ``run_model``.

    On the fused route (``FastWaveModel``): one advection pass for
    CHECKCFL (``FusedPropagation.cfl_diagnostics``, on a zero spectrum),
    then ``nsub`` a step (the all-band pass and the fast-wave sub-band
    passes); a physics step whenever ``idelt`` has accumulated, in full
    mode in ceil(nsrl / chunk) launches where it falls on an output date,
    minimal otherwise.  An output date that is no physics step launches no
    full-mode kernel.  On the dense route (``WaveModel``, cached or otf
    weights): no advection kernel, and every physics step one launch of
    kernel C, or n_pad / phys_chunk where the chunks divide the points."""
    out = set(cfg.output_dates())
    if ms.weights_mode != "fused":
        steps = _physics_steps(cfg, ms)
        c = ms.phys_chunk
        per = (ms.n_pad // c if c and ms.n_pad % c == 0 and ms.n_pad != c
               else 1)
        return dict(advect=0, implsch=0, implsch_full=0,
                    implsch_compact=len(steps) * per)
    n_adv, n_min, n_full = 1, 0, 0
    elapsed = 0.0
    date = cfg.begin
    step = _dt.timedelta(seconds=cfg.adv_timestep)
    while date < cfg.end:
        date += step
        n_adv += nsub
        elapsed += ms.idelpro
        if elapsed >= ms.idelt - 1e-6:
            elapsed = 0.0
            if date in out:
                n_full += math.ceil(ms.fused.nsrl / chunk)
            else:
                n_min += 1
    return dict(advect=n_adv, implsch=n_min, implsch_full=n_full,
                implsch_compact=0)


def _physics_steps(cfg: RunConfig, ms) -> list:
    """The dates of the run's physics steps (``idelt`` accumulated)."""
    steps, elapsed = [], 0.0
    date = cfg.begin
    while date < cfg.end:
        date += _dt.timedelta(seconds=cfg.adv_timestep)
        elapsed += ms.idelpro
        if elapsed >= ms.idelt - 1e-6:
            elapsed = 0.0
            steps.append(date)
    return steps


def stats_error(got: list[dict], want: list[dict]) -> tuple[float, tuple]:
    """Largest |got − want| of an entry's average, minimum or maximum over
    the entry's largest magnitude in ``want``, and where; the two logs
    must hold the same entries with the same point counts."""
    eg = {(e["time"], e["name"]): e for e in got}
    ew = {(e["time"], e["name"]): e for e in want}
    if set(eg) != set(ew):
        raise AssertionError(f"statistics entries differ: "
                             f"{sorted(set(eg) ^ set(ew))[:6]}")
    worst, where = 0.0, None
    for k, w in ew.items():
        g = eg[k]
        if g["non_missing_points"] != w["non_missing_points"]:
            raise AssertionError(f"{k}: point counts differ")
        scale = max(abs(w[q]) for q in ("average", "minimum", "maximum"))
        for q in ("average", "minimum", "maximum"):
            e = abs(g[q] - w[q]) / scale if scale else abs(g[q] - w[q])
            if e > worst or where is None:
                worst, where = e, (k, q)
    return worst, where


def restarts_equal(path_a: str, path_b: str) -> bool:
    """Two restart files hold the same spectrum and stress, bit for bit."""
    with np.load(path_a) as a, np.load(path_b) as b:
        keys = [k for k in a.files if k == "fl1" or k.startswith("stress_")]
        return (set(keys) <= set(b.files)
                and all(np.array_equal(a[k], b[k]) for k in keys))


def _cols(tree: dict, s: int, n: int, f64: bool = False) -> dict:
    """Columns [s, s + n) of every tensor (nested dicts too); with
    ``f64``, as float64 on the CPU."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _cols(v, s, n, f64)
            continue
        v = v[..., s:s + n]
        if f64:
            v = v.to(device="cpu", dtype=(torch.float64
                                          if v.is_floating_point()
                                          else v.dtype))
        out[k] = v
    return out


def products_vs_f64(model, start: int, count: int, *, tol: float,
                    width: float, names=FIELDS, so=None) -> dict:
    """The catalog (after the second-order correction ``so``, a
    SecondOrderTables, if given) on points [start, start + count) of
    ``model``'s state: once on the model's device in its dtype, once in
    float64 on the CPU from the same values.

    A point's error is relative to the field's largest magnitude on the
    chunk (directions: the circular distance over 360°).  A point over
    ``tol`` is held out where it lies on a float32 decision edge, within
    ``width`` of it in float64: of the kurtosis chain's edges
    (``extremes.kurtosis_margins``) for its fields, of PP1D's crop
    (``products.pp1d_margin``) for ``pp1d``.  Returns {"fields": {name:
    (max error, points held, points over ``tol`` off every edge)},
    "edge": {edge: points within ``width``}, "count": count}.
    """
    ms = model.setup
    tb, params = ms.tb, ms.phys.params
    env = {k: v for k, v in ms.env.items() if not k.endswith("_ext")}
    state = {**model.state, **model.stress}

    def run(fl, env_c, state_c, frc_c):
        if so is not None:
            fl = so_mod.cal_second_order_spec(fl, env_c["wavnum"],
                                              env_c["depth"], tb, so)
        return fl, products_mod.compute(
            list(names), fl, tb, state_c, frc_c, params, env=env_c,
            llgcbz0=params.llgcbz0)

    fl = model.fl1_chunk(start, count)
    _, got = run(fl, _cols(env, start, count), _cols(state, start, count),
                 _cols(model.frc, start, count))
    env64 = _cols(env, start, count, f64=True)
    fl64, want = run(fl.to(device="cpu", dtype=torch.float64), env64,
                     _cols(state, start, count, f64=True),
                     _cols(model.frc, start, count, f64=True))
    margins = extremes.kurtosis_margins(fl64, env64["depth"], tb)
    margins["pp1d"] = products_mod.pp1d_margin(fl64, tb)
    near = {k: m < width for k, m in margins.items()}
    kurt_edge = torch.zeros(count, dtype=torch.bool)
    for k in margins:
        if k != "pp1d":
            kurt_edge |= near[k]
    none = torch.zeros(count, dtype=torch.bool)
    out = {}
    for n in names:
        g = got[n].to(device="cpu", dtype=torch.float64)
        w = want[n]
        d = (g - w).abs()
        if n in DIRECTIONS:
            d = torch.minimum(d, 360.0 - d)
            scale = 360.0
        else:
            scale = float(w.abs().max())
        rel = d / scale if scale > 0.0 else d
        edge = (kurt_edge if n in KURTOSIS_FIELDS
                else near["pp1d"] if n == "pp1d" else none)
        over = rel > tol
        out[n] = (float(rel.max()), int((over & edge).sum()),
                  int((over & ~edge).sum()))
    return dict(fields=out, edge={k: int(v.sum()) for k, v in near.items()},
                count=count)
