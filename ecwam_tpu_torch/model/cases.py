"""Shared check configurations and the kernel-against-plain comparisons.

The golden-trajectory configuration of ``tests/test_golden_trajectory.py``
(the 12° ``t12`` grid with synthetic land, a shoal and obstructions,
12×18 with 15 advected, irefra=1, ifrelfmax=3), its decaying-wind
forcing (``tests/test_trajectory_oracle.py:_forcing``), its
statistics.log trajectory (``tests/test_golden_trajectory.py``) and a
shallow grid on which every shallow-water term is active, built from
numpy so that ``chip_smoke.py`` and the port's tests use one definition.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ecwam_tpu_torch.core import bathy as bathy_mod
from ecwam_tpu_torch.core import grid as grid_mod
from ecwam_tpu_torch.core.spectral import build_spectral_tables
from ecwam_tpu_torch.io import norms as norms_mod
from ecwam_tpu_torch.model.driver import FastWaveModel, parse_date
from ecwam_tpu_torch.model.setup import build_model
from ecwam_tpu_torch.ops import propagation_cuda as pcu
from ecwam_tpu_torch.ops.physics import implsch_cuda as ipk

START = "20230101000000"


def golden_kw() -> dict:
    """``build_model`` keywords of the golden-trajectory configuration."""
    nang, nfre, nfre_red = 12, 18, 15
    topo = bathy_mod.synthetic_topo(invres=2, features=[
        dict(kind="land", lon=(40.0, 44.0), lat=(0.0, 12.0), elev=300.0),
        dict(kind="shoal", lon=(80.0, 92.0), lat=(-12.0, 0.0),
             elev=-15.0)])
    wg = grid_mod.regular_grid(12.0, name="t12")
    tb = build_spectral_tables(nang=nang, nfre=nfre, nfre_red=nfre_red)
    b, obs = bathy_mod.make_bathymetry(topo, wg, tb.fr, nfre_red=nfre_red)
    blk = grid_mod.build_sea_point_block(wg, b)
    return dict(grid=wg, bathy=b, nang=nang, nfre=nfre, nfre_red=nfre_red,
                pad_to=8, iphys=1, idelpro=900.0, idelt=1800.0,
                delpro_lf=450.0, ifrelfmax=3, irefra=1,
                obstructions=bathy_mod.obstructions_to_block(obs, blk))


def shallow_kw() -> dict:
    """A 12° grid with a wavy 3–21 m bottom, 12×30 all advected: depth
    limiting, depth-induced breaking (SDIWBK) and bottom friction are
    active, and the cut falls inside the ladder (IMPHFTAIL)."""
    grid = grid_mod.regular_grid(12.0)
    bathy = np.full((grid.ngy, grid.ngx), -999.0)
    lats = np.linspace(0, np.pi, grid.ngy)[:, None]
    lons = np.linspace(0, 2 * np.pi, grid.ngx)[None, :]
    depth = 12.0 + 9.0 * np.sin(3 * lats) * np.cos(2 * lons)
    for k in range(1, grid.ngy - 1):
        bathy[k, : grid.nlonrgg[k]] = depth[k, : grid.nlonrgg[k]]
    return dict(grid=grid, bathy=bathy, nang=12, nfre=30, idelpro=900.0,
                idelt=1800.0, pad_to=64)


def golden_forcing(n: int, seed: int = 11, cicover=None):
    """forcing_at(step): random 5–18 m/s winds decaying by 18 % a step,
    so some points cross the 4 m/s TAUW-cap threshold."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(5.0, 18.0, n)
    direc = rng.uniform(0.0, 2 * np.pi, n)
    ice = np.zeros(n) if cicover is None else cicover

    def forcing_at(step):
        return dict(wswave=base * (1.0 - 0.18 * step), wdwave=direc,
                    aird=np.full(n, 1.225), wstar=np.zeros(n), cicover=ice)
    return forcing_at


def provider(forcing_at, idelpro: float):
    """A date-keyed forcing provider over ``forcing_at(step)``, one step
    every ``idelpro`` seconds from :data:`START`."""
    def at(date14):
        step = int((parse_date(date14) - parse_date(START))
                   .total_seconds() // idelpro)
        return forcing_at(step)
    return at


def _physics_step(kw: dict, device, full: bool):
    """One physics step on every SRL row of ``build_model(**kw)``, after
    two plain steps under the golden forcing with sea ice on a fifth of
    the points (above and below the ice threshold), through the kernel
    and through the plain version on ``device``: (kernel result, plain
    result, ``margin_at`` of :func:`full_errors` on the step's inputs),
    each result (f_srl, rows, tail[, xllws])."""
    ms = build_model(device=device, **kw)
    n = ms.n_real
    ice = np.where(np.arange(n) % 10 == 3, 0.5,
                   np.where(np.arange(n) % 10 == 7, 0.2, 0.0))
    m = FastWaveModel(ms, provider(golden_forcing(n, cicover=ice), 900.0),
                      START, plain=True)
    m.advance(2)
    scal = torch.cat([m._frc6, m._denv, m._stress6])
    cfg = ms.phys if full else ipk.minimal_config(ms.phys)
    rows = dict(nang=ms.tb.nang, nfre_red=ms.tb.nfre_red, full=full)

    def fresh():
        tail = None if m._tail is None else m._tail.clone()
        return m._f_srl.clone(), m._env2d, scal, tail
    want = ipk.implsch_srl_plain(cfg, *fresh(), **rows)
    counter = "full_launches" if full else "launches"
    n0 = getattr(ipk.implsch_srl, counter)
    got = ipk.implsch_srl(cfg, *fresh(), **rows)
    if got[0].is_cuda and getattr(ipk.implsch_srl, counter) != n0 + 1:
        raise AssertionError("the physics step did not launch the kernel")
    if (got[2] is None) != (want[2] is None):
        raise AssertionError("kernel and plain disagree on the tail block")
    return got, want, srl_margin(cfg, *fresh(), nang=ms.tb.nang,
                                 nfre_red=ms.tb.nfre_red)


def spectrum_error(got, want) -> float:
    """max|k−p| over max|p| of the spectrum and its tail block; raises
    on a non-finite kernel value."""
    spec = 0.0
    for g, w in ((got[0], want[0]), (got[2], want[2])):
        if w is not None:
            if not bool(torch.isfinite(g).all()):
                raise AssertionError("physics kernel: non-finite spectrum")
            spec = max(spec, float((g - w).abs().max() / w.abs().max()))
    return spec


def row_errors(got, want) -> torch.Tensor:
    """Per output row, max|k−p| over max|p| (over max 1e-30 where the
    field is zero)."""
    return ((got - want).abs().amax(dim=1)
            / want.abs().amax(dim=1).clamp(min=1e-30))


# the full-mode rows that integrate the windsea mask (FEMEANWS)
MASK_FIELDS = ("emeanws", "fmeanws", "wsemean", "wsfmean")
# the most points whose mask margin is computed in float64; where more
# points differ, every differing bin counts as off the edge
MARGIN_POINTS = 4096


def full_errors(got, want, got_x, want_x, margin_at, width: float) -> dict:
    """Full mode, kernel against plain, point by point.

    ``err`` (30, n) is each row's |k−p| over the field's max|p|.  A
    windsea-mask bin that differs lies on the mask's edge when the plain
    chain in float64, ``margin_at(points)`` → (nang, nfre, len(points)),
    puts its margin (``xllws_margin``) within ``width`` of 0: its test may
    then go either way in either float32 version.  Such a flip moves the
    MASK_FIELDS of its point by that bin's energy, so their errors are
    zeroed at the points whose differing bins all lie on the edge; every
    other row is held to the limits there.  Returns ``err``; ``edge`` and
    ``off`` (n,), the differing bins of each point on and off the edge;
    and ``margin`` (n,), the largest |margin| of each point's differing
    bins (0 where none was computed)."""
    err = ((got - want).abs()
           / want.abs().amax(1, keepdim=True).clamp(min=1e-30))
    diff = got_x != want_x
    pts = torch.nonzero(diff.flatten(0, 1).any(0)).flatten()
    on = torch.zeros_like(diff)
    margin = torch.zeros(diff.shape[-1], dtype=torch.float64,
                         device=diff.device)
    if 0 < pts.numel() <= MARGIN_POINTS:
        d = diff[..., pts]
        m = torch.where(d, margin_at(pts).abs().to(diff.device), 0.0)
        on[..., pts] = d & (m < width)
        margin[pts] = m.flatten(0, 1).amax(0)
    edge = on.flatten(0, 1).sum(0)
    off = (diff & ~on).flatten(0, 1).sum(0)
    held = (edge > 0) & (off == 0)
    mask_rows = [ipk.SCAL_OUT_FULL.index(k) for k in MASK_FIELDS]
    err[mask_rows] = torch.where(held, torch.zeros_like(err[mask_rows]),
                                 err[mask_rows])
    return dict(err=err, edge=edge, off=off, margin=margin)


def srl_margin(cfg, f_srl, env2d, scal, tail, *, nang: int,
               nfre_red: int):
    """``margin_at`` of :func:`full_errors` for SRL rows: the plain chain's
    mask margin at the given rows, in float64 on the rows' device."""
    def at(rows):
        t = None if tail is None else tail[rows].double()
        fl = ipk.srl_inputs(cfg, f_srl[rows].double(), env2d[:, rows],
                            scal[:, rows], t, nang=nang,
                            nfre_red=nfre_red)[0]
        return ipk.xllws_margin(cfg, fl, env2d[:, rows].double(),
                                scal[:, rows].double())
    return at


def compact_margin(cfg, fl1, env2d, scal):
    """``margin_at`` of :func:`full_errors` for compact (…, n) inputs."""
    return lambda pts: ipk.xllws_margin(
        cfg, *(a[..., pts].double() for a in (fl1, env2d, scal)))


def physics_kernel_vs_plain(kw: dict, device) -> tuple[float, float]:
    """One minimal-mode physics step (see :func:`_physics_step`): kernel
    against plain, (spectrum, stress) as max|k−p| over each field's
    maximum."""
    got, want, _ = _physics_step(kw, device, full=False)
    return spectrum_error(got, want), float(row_errors(got[1], want[1]).max())


def compact_inputs(model: FastWaveModel):
    """A model's state as the compact entry takes it: fl1 (nang, nfre,
    n_pad), env2d (3·nfre, n_pad) and scal (14, n_pad), at the canonical
    points."""
    env = model.setup.env
    env2d = torch.cat([env[k] for k in ipk.ENV_FIELDS]).contiguous()
    rows = torch.cat([model._frc6, model._denv, model._stress6])
    return (model.fl1.contiguous(), env2d,
            model.fp.extract_state(rows).contiguous())


def compact_kernel_vs_plain(kw: dict, device, *, full: bool,
                            width: float) -> dict:
    """The compact entry (kernel C) against its plain version on the state
    of ``build_model(**kw)`` after two plain steps under the golden
    forcing: the spectrum error, the largest output-row error, and the
    xllws bins that differ on and off the mask's edge (:func:`full_errors`
    with ``width``)."""
    ms = build_model(device=device, **kw)
    m = FastWaveModel(ms, provider(golden_forcing(ms.n_real), 900.0),
                      START, plain=True)
    m.advance(2)
    cfg = ms.phys if full else ipk.minimal_config(ms.phys)
    args = compact_inputs(m)
    n0 = ipk.implsch_compact.launches
    got = ipk.implsch_compact(cfg, *args, full=full)
    if got[0].is_cuda and ipk.implsch_compact.launches != n0 + 1:
        raise AssertionError("the compact entry did not launch the kernel")
    want = ipk.implsch_compact_plain(cfg, *args, full=full)
    if not bool(torch.isfinite(got[0]).all()):
        raise AssertionError("compact kernel: non-finite spectrum")
    r = dict(spec=float((got[0] - want[0]).abs().max()
                        / want[0].abs().max()), bins=got[0].numel(),
             xllws=0, off_edge=0, margin=0.0)
    if full:
        fe = full_errors(got[1], want[1], got[2], want[2],
                         compact_margin(cfg, *args), width)
        r.update(rows=float(fe["err"].max()), xllws=int(fe["edge"].sum()),
                 off_edge=int(fe["off"].sum()),
                 margin=float(fe["margin"].max()))
    else:
        r["rows"] = float(row_errors(got[1], want[1]).max())
    return r


def full_kernel_vs_plain(kw: dict, device, *, width: float) -> dict:
    """One full-mode physics step (see :func:`_physics_step`): kernel
    against plain.  Returns the spectrum error, {row name: error} over the
    SCAL_OUT_FULL rows, and the xllws bins that differ on and off the
    mask's edge (:func:`full_errors` with ``width``) with the largest
    |margin| among them."""
    got, want, margin_at = _physics_step(kw, device, full=True)
    fe = full_errors(got[1], want[1], got[3], want[3], margin_at, width)
    rows = fe["err"].amax(1)
    return dict(spec=spectrum_error(got, want),
                rows={k: float(rows[i])
                      for i, k in enumerate(ipk.SCAL_OUT_FULL)},
                xllws=int(fe["edge"].sum()), off_edge=int(fe["off"].sum()),
                margin=float(fe["margin"].max()),
                flip_points=int(((fe["edge"] + fe["off"]) > 0).sum()),
                bins=got[3].numel())


def golden_kernel_vs_plain(device, nsteps: int = 4) -> tuple[dict, dict]:
    """The golden configuration advanced ``nsteps`` steps (forcing swapped
    every 2) through the kernels and through the plain versions, both on
    ``device``.  Returns ({"fl1" and each stress field: max|k−p| over
    max|p|}, {"kernels"/"plain": (advection, physics) launches})."""
    ms = build_model(device=device, **golden_kw())
    forcing_at = golden_forcing(ms.n_real)
    runs, launched = {}, {}
    for plain in (False, True):
        m = FastWaveModel(ms, provider(forcing_at, 900.0), START,
                          plain=plain)
        a0, b0 = pcu.advect.launches, ipk.implsch_srl.launches
        m.advance(nsteps, wind_every=2)
        name = "plain" if plain else "kernels"
        launched[name] = (pcu.advect.launches - a0,
                          ipk.implsch_srl.launches - b0)
        runs[name] = m
    k, p = runs["kernels"], runs["plain"]
    pairs = dict(fl1=(k.fl1, p.fl1))
    pairs.update((s, (k.stress[s], p.stress[s])) for s in ipk.STRESS_KEYS)
    err = {name: float((a - b).abs().max() / b.abs().max())
           for name, (a, b) in pairs.items()}
    return err, launched


GOLDEN_STEPS = 5
GOLDEN_FIELDS = ("ufric", "phiaw", "emean", "wsemean")
GOLDEN_SEP_FIELDS = ("esea", "eswell")


def golden_statistics(device, *, plain: bool = False) -> list[dict]:
    """The golden configuration's statistics.log entries over
    GOLDEN_STEPS output-date steps (``advance(1, full_phys=True)`` under
    the step-0 forcing): swh every step, the GOLDEN_FIELDS and the
    windsea/swell energies on the physics steps — the trajectory of
    ``tests/test_golden_trajectory.py``."""
    ms = build_model(device=device, **golden_kw())
    n = ms.n_real
    m = FastWaveModel(ms, provider(golden_forcing(n), 900.0), START,
                      plain=plain)
    dfim = np.asarray(ms.tb.dfim)
    log = norms_mod.StatisticsLog()
    for _ in range(GOLDEN_STEPS):
        m.advance(1, full_phys=True)
        fl1 = m.fl1.cpu().numpy().astype(np.float64)[..., :n]
        em = (fl1.sum(axis=0) * dfim[:, None]).sum(axis=0)
        date = m.date.strftime("%Y%m%d%H%M%S")
        log.add("swh", date, 4.0 * np.sqrt(np.maximum(em, 0.0)))
        st = m.state
        if st:                                 # physics every 2nd step
            for k in GOLDEN_FIELDS:
                log.add(k, date, st[k].cpu().numpy().astype(np.float64)[:n])
            for k in GOLDEN_SEP_FIELDS:
                log.add(k, date,
                        st["sep"][k].cpu().numpy().astype(np.float64)[:n])
    return log.entries


def golden_statistics_error(entries: list[dict], path: str) -> dict:
    """Relative difference of each entry's average, minimum and maximum
    from the committed ``statistics_golden.json`` at ``path``, by
    "name@date"; raises if the entries do not line up."""
    with open(path) as f:
        want = json.load(f)
    if [(e["name"], e["time"]) for e in entries] != [
            (w["name"], w["date"]) for w in want]:
        raise AssertionError("golden entries do not line up")
    return {f"{e['name']}@{e['time']}": max(
        abs(e[k] - w[k]) / abs(w[k]) for k in ("average", "minimum",
                                                 "maximum"))
        for e, w in zip(entries, want)}
