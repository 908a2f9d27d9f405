"""Shared check configurations and the kernel-against-plain comparisons.

The golden-trajectory configuration of ``tests/test_golden_trajectory.py``
(the 12° ``t12`` grid with synthetic land, a shoal and obstructions,
12×18 with 15 advected, irefra=1, ifrelfmax=3) and its variant with the
trajectory oracle's currents (irefra 3), its decaying-wind forcing
(``tests/test_trajectory_oracle.py:_forcing``), its statistics.log
trajectory (``tests/test_golden_trajectory.py``), a shallow grid on which
every shallow-water term is active (and its cycle-50 variant with polar
sea ice), the small-grid cases of the rest of the physics
(:data:`LEGACY_CASES`: iphys=0, ISNONLIN 0/2, SDICE1/2, LSTRN and the
LBIWBK/LICERUN/LMASKICE switches), the dense ``WaveModel``'s
configurations (the trajectory oracle's two, :data:`WAVEMODEL_CASES`, and
the u* forcing of tests/test_forcing_fidelity.py, :func:`ustar_model`),
and the O320 configurations at full width, built from numpy so that
``chip_smoke.py`` and the port's tests use one definition.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from ecwam_tpu_torch.core import bathy as bathy_mod
from ecwam_tpu_torch.core import grid as grid_mod
from ecwam_tpu_torch.core.spectral import build_spectral_tables
from ecwam_tpu_torch.io import norms as norms_mod
from ecwam_tpu_torch.model.driver import FastWaveModel, WaveModel, parse_date
from ecwam_tpu_torch.model.fusedstep import FusedPropagation
from ecwam_tpu_torch.model.setup import build_model
from ecwam_tpu_torch.ops import propagation_cuda as pcu
from ecwam_tpu_torch.ops import propagation_fused as pfz
from ecwam_tpu_torch.ops.physics import implsch as impl
from ecwam_tpu_torch.ops.physics import implsch_cuda as ipk

START = "20230101000000"
# ECMWF's operational physics options (tests/test_implsch_pallas.py:158-169
# and BASELINE.md's etopo1_oper_an_fc_O48_cy49r1 / _cy50r1 cases)
CY49R1 = dict(llgcbz0=True, llnormagam=True, llcapchnk=True)
CY50R1 = dict(CY49R1, lciwa3=True, lciscal=True)


def golden_kw(irefra: int = 1, currents: bool = False) -> dict:
    """``build_model`` keywords of the golden-trajectory configuration;
    ``currents`` adds the trajectory oracle's surface currents
    (tests/test_trajectory_oracle.py:74-79: 0.35·N(0, 1) m/s in u and v
    from seed 3) for ``irefra`` 2 or 3."""
    nang, nfre, nfre_red = 12, 18, 15
    topo = bathy_mod.synthetic_topo(invres=2, features=[
        dict(kind="land", lon=(40.0, 44.0), lat=(0.0, 12.0), elev=300.0),
        dict(kind="shoal", lon=(80.0, 92.0), lat=(-12.0, 0.0),
             elev=-15.0)])
    wg = grid_mod.regular_grid(12.0, name="t12")
    tb = build_spectral_tables(nang=nang, nfre=nfre, nfre_red=nfre_red)
    b, obs = bathy_mod.make_bathymetry(topo, wg, tb.fr, nfre_red=nfre_red)
    blk = grid_mod.build_sea_point_block(wg, b)
    kw = dict(grid=wg, bathy=b, nang=nang, nfre=nfre, nfre_red=nfre_red,
              pad_to=8, iphys=1, idelpro=900.0, idelt=1800.0,
              delpro_lf=450.0, ifrelfmax=3, irefra=irefra,
              obstructions=bathy_mod.obstructions_to_block(obs, blk))
    if currents:
        rng = np.random.default_rng(3)
        kw["currents"] = (0.35 * rng.standard_normal(blk.nsea),
                          0.35 * rng.standard_normal(blk.nsea))
    return kw


def currents_kw(irefra: int = 3, *, fast: bool = False,
                cfl: bool = False) -> dict:
    """tests/test_fused_pallas.py's current-refraction configuration: the
    6° aqua grid, 12×25, idelpro 900 s, with uniform random currents of
    ±0.2 m/s from seed 7; ``fast`` adds the fast-wave sub-band passes
    (ifrelfmax 5, 450 s), and ``cfl`` makes the CFL current retry bite
    (idelpro 9000 s and ±6 m/s currents, so that some points' outflow
    sums leave [0, 1] with the current terms and stay inside without)."""
    grid = grid_mod.regular_grid(6.0)
    n = grid_mod.build_sea_point_block(
        grid, grid_mod.aqua_bathymetry(grid)).nsea
    rng = np.random.default_rng(7)
    amp = 12.0 if cfl else 0.4
    kw = dict(grid=grid, nang=12, nfre=25, idelpro=9000.0 if cfl else 900.0,
              idelt=900.0, pad_to=64, irefra=irefra,
              currents=(amp * (rng.random(n) - 0.5),
                        amp * (rng.random(n) - 0.5)))
    if fast:
        kw.update(delpro_lf=450.0, ifrelfmax=5)
    return kw


def point_latlon(grid, blk):
    """Latitude and longitude (degrees) of each sea point."""
    lat = grid.lats[blk.kxlt]
    lon = grid.amowep + blk.ixlg * grid.zdello[blk.kxlt]
    return lat, lon


def polar_ice(ms, lat0: float, width: float, thick_min: float,
              thick_max: float) -> dict:
    """Sea ice over the polar rows of ``ms``: cicover rises linearly from 0
    at |φ| = lat0 to 1 at lat0 + width, cithick from thick_min to
    thick_max with it; (n_real,) arrays."""
    lat, _ = point_latlon(ms.grid, ms.blk)
    ci = np.clip((np.abs(lat) - lat0) / width, 0.0, 1.0)
    return dict(cicover=ci, cithick=thick_min + (thick_max - thick_min) * ci)


def shallow_kw(options: bool = False) -> dict:
    """A 12° grid with a wavy 3–21 m bottom, 12×30 all advected: depth
    limiting, depth-induced breaking (SDIWBK) and bottom friction are
    active, and the cut falls inside the ladder (IMPHFTAIL).  ``options``
    adds the cycle-50r1 physics (:data:`CY50R1`); run it under
    :func:`shallow_ice`."""
    grid = grid_mod.regular_grid(12.0)
    bathy = np.full((grid.ngy, grid.ngx), -999.0)
    lats = np.linspace(0, np.pi, grid.ngy)[:, None]
    lons = np.linspace(0, 2 * np.pi, grid.ngx)[None, :]
    depth = 12.0 + 9.0 * np.sin(3 * lats) * np.cos(2 * lons)
    for k in range(1, grid.ngy - 1):
        bathy[k, : grid.nlonrgg[k]] = depth[k, : grid.nlonrgg[k]]
    kw = dict(grid=grid, bathy=bathy, nang=12, nfre=30, idelpro=900.0,
              idelt=1800.0, pad_to=64)
    return dict(kw, **CY50R1) if options else kw


def storm(ms) -> dict:
    """:func:`golden_forcing` keywords for winds of 5–55 m/s (up to 35 m/s
    by the third step): the capped Charnock parameter and RNFAC
    (LLCAPCHNK, with LLNORMAGAM) differ from their defaults only above
    about 25 m/s."""
    return dict(wmax=55.0)


def shallow_ice(ms) -> dict:
    """The shallow grid's cycle-50 forcing: polar ice, cicover 0 → 1 from
    |φ| = 48° to 84° and cithick 0.5 → 2 m, so that SDICE3, LCISCAL,
    SETICE and the sea-ice flux branch are all active, under the
    :func:`storm` winds."""
    return dict(polar_ice(ms, 48.0, 36.0, 0.5, 2.0), **storm(ms))


def with_phys(ms, **phys):
    """``ms`` with its PhysicsConfig's flags replaced — the way the
    reference reaches the options that ``build_model`` takes no keyword
    for (lciwa1/2, lstrn, lbiwbk, licerun, lmaskice)."""
    if not phys:
        return ms
    return dataclasses.replace(ms, phys=dataclasses.replace(ms.phys, **phys))


def build(kw: dict, device, phys: dict | None = None):
    """``build_model(**kw)`` on ``device`` with ``phys``'s flags
    (:func:`with_phys`)."""
    return with_phys(build_model(device=device, **kw), **(phys or {}))


# The rest of the physics on the small grids: name → (build_model
# keywords, PhysicsConfig flags, forcing keywords of golden_forcing or
# None).  iphys=0 alone is ECMWF's iphys_0 flag set
# (BASELINE.md's etopo1_oper_an_fc_O48_iphys_0); the ISNONLIN cases need
# the shallow grid (TRANSF_SNL and the ISNONLIN=0 factor act only in
# finite depth); the sea-ice cases run under shallow_ice.
LEGACY_CASES = {
    "iphys0": (lambda: dict(golden_kw(), iphys=0), {}, None),
    "iphys0_cy49r1": (lambda: dict(golden_kw(), iphys=0, **CY49R1), {},
                      storm),
    "isnonlin0_shallow": (lambda: dict(shallow_kw(), isnonlin=0), {}, None),
    "isnonlin2_shallow": (lambda: dict(shallow_kw(), isnonlin=2), {}, None),
    "sdice1_shallow": (shallow_kw, dict(lciwa1=True), shallow_ice),
    "sdice2_shallow": (shallow_kw, dict(lciwa2=True), shallow_ice),
    "lstrn_shallow": (shallow_kw, dict(lstrn=True), shallow_ice),
    "switches_off_shallow": (shallow_kw, dict(lbiwbk=False, licerun=False,
                                              lmaskice=False),
                             shallow_ice),
}


def legacy_case(name: str) -> dict:
    """The keywords of the checks of :data:`LEGACY_CASES`' ``name``:
    ``kw``, ``phys`` and ``forcing``."""
    make, phys, forcing = LEGACY_CASES[name]
    return dict(kw=make(), phys=phys, forcing=forcing)


def o320_legacy(device):
    """A coverage configuration at full width that puts the rest of the
    physics into one model: O320, 36×36 with 29 advected, idelpro 450 s,
    idelt 900 s, irefra 0, with iphys=0 (Janssen's input and the cycle-4
    dissipation), ISNONLIN=2 (PEAK_ANG and TRANSF_SNL), SDICE1 and, on
    output dates, the sea-ice strain (LSTRN).  The aqua planet's sea points
    get the depth d = 20 + 480·(1 + cos 3λ) m (20 to 980 m), so that
    TRANSF_SNL, SDIWBK and SBOTTOM act; sea ice and winds as in
    :func:`o320_options` (cicover = clip((|φ| − 60°)/15°, 0, 1), cithick =
    2·cicover m; 8–12 m/s from ``default_rng(0)``).  Returns the setup and
    a cold-started ``FastWaveModel`` on ``device``."""
    grid = grid_mod.octahedral_grid(320)
    bathy = grid_mod.aqua_bathymetry(grid)
    for k in range(grid.ngy):
        n = grid.nlonrgg[k]
        lon = np.radians(grid.amowep + np.arange(n) * grid.zdello[k])
        sea = bathy[k, :n] > 0.0
        bathy[k, :n][sea] = (20.0 + 480.0 * (1.0 + np.cos(3.0 * lon)))[sea]
    ms = with_phys(build_model(
        grid=grid, bathy=bathy, nang=36, nfre=36, nfre_red=29,
        idelpro=450.0, idelt=900.0, pad_to=8192, iphys=0, isnonlin=2,
        device=device), lciwa1=True, lstrn=True)
    lat, _ = point_latlon(grid, ms.blk)
    rng = np.random.default_rng(0)
    n = ms.n_real
    ci = np.clip((np.abs(lat) - 60.0) / 15.0, 0.0, 1.0)
    forcing = dict(wswave=8.0 + 4.0 * rng.random(n),
                   wdwave=rng.random(n) * 2.0 * np.pi,
                   aird=np.full(n, 1.225), wstar=np.zeros(n), cicover=ci,
                   cithick=2.0 * ci)
    return ms, FastWaveModel(ms, lambda date14: forcing, START)


def o320_options(device):
    """ECMWF's operational configuration at full width: O320 aqua planet,
    36×36 with 29 advected, idelpro 450 s, idelt 900 s (as chip_smoke.py's
    default O320 model), with current refraction (irefra 2) and the
    cycle-50r1 physics (:data:`CY50R1`).  Forcing from ``default_rng(0)``:
    winds 8–12 m/s in random directions; sea ice cicover = clip((|φ| −
    60°)/15°, 0, 1) and cithick = 2·cicover m.  The surface current is an
    equatorial jet plus a wave-3 eddy pattern (φ, λ the point's latitude
    and longitude):

        u = 0.9·exp(−(φ/8°)²) − 0.3·cos(3λ)·sin(2φ)    (m/s)
        v = 0.3·sin(3λ)·cos(φ)

    a peak speed near 0.95 m/s.  Returns the setup and a cold-started
    ``FastWaveModel`` on ``device``."""
    grid = grid_mod.octahedral_grid(320)
    blk = grid_mod.build_sea_point_block(grid, grid_mod.aqua_bathymetry(grid))
    lat, lon = point_latlon(grid, blk)
    phi, lam = np.radians(lat), np.radians(lon)
    u = (0.9 * np.exp(-(lat / 8.0) ** 2)
         - 0.3 * np.cos(3 * lam) * np.sin(2 * phi))
    v = 0.3 * np.sin(3 * lam) * np.cos(phi)
    ms = build_model(grid=grid, nang=36, nfre=36, nfre_red=29,
                     idelpro=450.0, idelt=900.0, pad_to=8192, irefra=2,
                     currents=(u, v), device=device, **CY50R1)
    rng = np.random.default_rng(0)
    n = ms.n_real
    ci = np.clip((np.abs(lat) - 60.0) / 15.0, 0.0, 1.0)
    forcing = dict(wswave=8.0 + 4.0 * rng.random(n),
                   wdwave=rng.random(n) * 2.0 * np.pi,
                   aird=np.full(n, 1.225), wstar=np.zeros(n), cicover=ci,
                   cithick=2.0 * ci)
    return ms, FastWaveModel(ms, lambda date14: forcing, START)


def golden_forcing(n: int, seed: int = 11, cicover=None, cithick=None,
                   wmax: float = 18.0):
    """forcing_at(step): random 5–``wmax`` m/s winds decaying by 18 % a
    step, so some points cross the 4 m/s TAUW-cap threshold."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(5.0, wmax, n)
    direc = rng.uniform(0.0, 2 * np.pi, n)
    ice = dict(cicover=np.zeros(n) if cicover is None else cicover)
    if cithick is not None:
        ice["cithick"] = cithick

    def forcing_at(step):
        return dict(wswave=base * (1.0 - 0.18 * step), wdwave=direc,
                    aird=np.full(n, 1.225), wstar=np.zeros(n), **ice)
    return forcing_at


def provider(forcing_at, idelpro: float):
    """A date-keyed forcing provider over ``forcing_at(step)``, one step
    every ``idelpro`` seconds from :data:`START`."""
    def at(date14):
        step = int((parse_date(date14) - parse_date(START))
                   .total_seconds() // idelpro)
        return forcing_at(step)
    return at


def tile_rows(t, n: int, dim: int = 0):
    """``t`` with its entries along ``dim`` repeated in order and cut to
    ``n`` (None stays None)."""
    if t is None:
        return None
    reps = -(-n // t.shape[dim])
    return torch.cat([t] * reps, dim=dim).narrow(dim, 0, n).contiguous()


def physics_state(kw: dict, device, forcing=None, phys=None, rows=None):
    """The state a physics step of ``build(kw, device, phys)`` starts
    from after two plain steps under the golden forcing — with
    ``forcing(ms)``'s keywords of :func:`golden_forcing`, or by default
    with sea ice on a fifth of the points (above and below the ice
    threshold): (setup, (f_srl, env2d, scal, tail)), every SRL row, or
    ``rows`` of them, the rows repeated in order (:func:`tile_rows`)."""
    ms = build(kw, device, phys)
    n = ms.n_real
    if forcing is None:
        f_kw = dict(cicover=np.where(
            np.arange(n) % 10 == 3, 0.5,
            np.where(np.arange(n) % 10 == 7, 0.2, 0.0)))
    else:
        f_kw = forcing(ms)
    m = FastWaveModel(ms, provider(golden_forcing(n, **f_kw), 900.0),
                      START, plain=True)
    m.advance(2)
    args = (m._f_srl, m._env2d, torch.cat([m._frc6, m._denv, m._stress6]),
            m._tail)
    if rows is not None:
        args = (tile_rows(args[0], rows), tile_rows(args[1], rows, 1),
                tile_rows(args[2], rows, 1), tile_rows(args[3], rows))
    return ms, args


def _physics_step(kw: dict, device, full: bool, forcing=None, phys=None,
                  rows=None):
    """One physics step on the SRL rows of :func:`physics_state` (every
    row, or ``rows`` of them) through the kernel and through the plain
    version on ``device``: (kernel result, plain result, ``margin_at`` of
    :func:`full_errors` on the step's inputs, the per-row decision
    margins in float64 (:func:`decision_margins`, empty without such
    decisions), each result (f_srl, rows, tail[, xllws])."""
    ms, (f_srl, env2d, scal, tail) = physics_state(kw, device, forcing,
                                                   phys, rows)
    cfg = ms.phys if full else ipk.minimal_config(ms.phys)
    rows = dict(nang=ms.tb.nang, nfre_red=ms.tb.nfre_red, full=full)

    def fresh():
        return (f_srl.clone(), env2d, scal,
                None if tail is None else tail.clone())
    want = ipk.implsch_srl_plain(cfg, *fresh(), **rows)
    counter = "full_launches" if full else "launches"
    n0 = getattr(ipk.implsch_srl, counter)
    got = ipk.implsch_srl(cfg, *fresh(), **rows)
    if got[0].is_cuda and getattr(ipk.implsch_srl, counter) != n0 + 1:
        raise AssertionError("the physics step did not launch the kernel")
    if (got[2] is None) != (want[2] is None):
        raise AssertionError("kernel and plain disagree on the tail block")
    rows_kw = dict(nang=ms.tb.nang, nfre_red=ms.tb.nfre_red)
    margins = (decision_margins(srl_state(cfg, *fresh(), **rows_kw))
               if has_decisions(cfg) else {})
    return got, want, srl_margin(cfg, *fresh(), **rows_kw), margins


def has_decisions(cfg) -> bool:
    """Whether the configuration makes the per-row discrete decisions
    that :func:`held` forgives near their edge (the gravity-capillary
    closure, PEAK_ANG)."""
    return cfg.params.llgcbz0 or cfg.isnonlin == 2


def decision_margins(state: dict) -> dict:
    """The ``margins`` of :func:`held` from a plain chain's state."""
    return dict(gc=state.get("gc_margin"), peak=state.get("peak_margin"))


def srl_state(cfg, f_srl, env2d, scal, tail, *, nang: int, nfre_red: int,
              rows=None) -> dict:
    """The plain chain's state (:func:`.implsch.implsch`) at the given SRL
    rows (all for None), in float64 on the rows' device: its per-row
    decision margins (``gc_margin``, ``peak_margin``, ``frcut_tie``)."""
    rows = slice(None) if rows is None else rows
    t = None if tail is None else tail[rows].double()
    fl, env, frc, stress = ipk.srl_inputs(
        cfg, f_srl[rows].double(), env2d[:, rows].double(),
        scal[:, rows].double(), t, nang=nang, nfre_red=nfre_red)
    return impl.implsch(cfg, fl, env, frc, *stress)[1]


def held(margins: dict, widths: dict, err, off_tol: float):
    """Rows held out of the checks: those off the limit (``err`` (n,), a
    row's largest error, above ``off_tol``) whose decision margin
    ``margins[name]`` (float64, or None) lies within ``widths[name]`` of
    its edge — a loop of TAUT_Z0_GC that may leave at another iteration
    or a cut-off index step ("gc"), or a PEAK_ANG peak that may move to
    another direction maximum ("peak"), in either float32 version."""
    out = torch.zeros_like(err, dtype=torch.bool)
    for name, m in margins.items():
        if m is not None and widths.get(name, 0.0) > 0.0:
            out |= (err > off_tol) & (m.to(err.device) < widths[name])
    return out


def advect_kernel_vs_plain(kw: dict, device, seed: int = 0) -> dict:
    """Kernel A against its plain version on ``build_model(**kw)``: one
    all-band pass and (with fast waves) one sub-band pass on a JONSWAP
    start under random 6–12 m/s winds from ``seed``, each as max|k−p| over
    max|p|; the CFL current-retry mask (irefra 2/3) the kernel computed
    for the setup against the plain version's, as the number of SRL rows
    that differ and the number masked (0 and 0 without currents); both
    CHECKCFL readings; and ``obs``, whether the pass read the obstruction
    table (the kernel's ``OBS`` route)."""
    ms = build_model(device=device, **kw)
    n0 = pcu.advect.launches
    fk = FusedPropagation(ms)
    fpl = FusedPropagation(ms, plain=True)
    if (ms.device.type == "cuda" and ms.irefra in (2, 3)
            and pcu.advect.launches == n0):
        raise AssertionError("the CFL retry did not launch the kernel")
    rng = np.random.default_rng(seed)
    n = ms.n_pad
    f = pfz.refresh_wraps(fk.initial_srl(
        6.0 + 6.0 * rng.random(n), 2.0 * np.pi * rng.random(n))[0], fk.tabs)
    passes = [(fk.nfre_red, None, fk.lc)]
    if fk.nsub > 1:
        passes.append((fk.mlf_w, fk.mlf, fk.lc_lo))
    err = []
    for nf, nw, lc in passes:
        a = dict(nang=fk.nang, nf=nf, nw=nw, S=ms.fused.S, EW=ms.fused.EW,
                 irefra=ms.irefra)
        got = pcu.advect(f, fk.tabs, lc, **a)
        want = pcu.advect_plain(f, fk.tabs, lc, **a)
        err.append(float((got - want).abs().max() / want.abs().max()))
    cur = fk.cfl_bad is not None
    r = dict(main=err[0], sub=err[1] if len(err) > 1 else None,
             cfl_differ=int((fk.cfl_bad != fpl.cfl_bad).sum()) if cur else 0,
             cfl_masked=int(fk.cfl_bad.sum()) if cur else 0,
             diag=fk.cfl_diagnostics(), diag_plain=fpl.cfl_diagnostics(),
             obs=not fk.tabs["obs_ones"])
    return r


def spectrum_error(got, want, keep=None) -> float:
    """max|k−p| over max|p| of the spectrum and its tail block (rows in
    ``keep`` only, if given); raises on a non-finite kernel value."""
    spec = 0.0
    for g, w in ((got[0], want[0]), (got[2], want[2])):
        if w is not None:
            if not bool(torch.isfinite(g).all()):
                raise AssertionError("physics kernel: non-finite spectrum")
            if keep is not None:
                g, w = g[keep], w[keep]
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


def point_errors(got, want) -> torch.Tensor:
    """Per row (point), the largest |k−p| over each output field's
    maximum."""
    return ((got - want).abs()
            / want.abs().amax(1, keepdim=True).clamp(min=1e-30)).amax(0)


def physics_kernel_vs_plain(kw: dict, device, *, forcing=None, phys=None,
                            gc_width: float = 0.0, peak_width: float = 0.0,
                            off_tol: float = 0.0, rows=None) -> tuple:
    """One minimal-mode physics step (see :func:`_physics_step`, on
    ``rows`` rows if given): kernel against plain, (spectrum, stress) as
    max|k−p| over each field's maximum, and the number of rows held out:
    above ``off_tol`` on a gravity-capillary decision edge or a peak tie
    (:func:`held` within ``gc_width`` and ``peak_width``)."""
    got, want, _, margins = _physics_step(kw, device, full=False,
                                          forcing=forcing, phys=phys,
                                          rows=rows)
    keep = ~held(margins, dict(gc=gc_width, peak=peak_width),
                 point_errors(got[1], want[1]), off_tol)
    return (spectrum_error(got, want, keep),
            float(row_errors(got[1][:, keep], want[1][:, keep]).max()),
            int((~keep).sum()))


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
                            width: float, forcing=None, phys=None,
                            gc_width: float = 0.0, peak_width: float = 0.0,
                            off_tol: float = 0.0, rows=None) -> dict:
    """The compact entry (kernel C) against its plain version on the state
    of ``build(kw, device, phys)`` after two plain steps under the golden
    forcing (with ``forcing(ms)``'s keywords, if given), on every point or
    ``rows`` of them (the points repeated in order): the spectrum error,
    the largest output-row error, and the xllws bins that differ on and
    off the mask's edge (:func:`full_errors` with ``width``), over the
    points off a decision edge (:func:`held`)."""
    ms = build(kw, device, phys)
    f_kw = forcing(ms) if forcing is not None else {}
    m = FastWaveModel(ms, provider(golden_forcing(ms.n_real, **f_kw),
                                   900.0), START, plain=True)
    m.advance(2)
    cfg = ms.phys if full else ipk.minimal_config(ms.phys)
    args = compact_inputs(m)
    if rows is not None:
        args = tuple(tile_rows(a, rows, a.dim() - 1) for a in args)
    n0 = ipk.implsch_compact.launches
    got = ipk.implsch_compact(cfg, *args, full=full)
    if got[0].is_cuda and ipk.implsch_compact.launches != n0 + 1:
        raise AssertionError("the compact entry did not launch the kernel")
    want = ipk.implsch_compact_plain(cfg, *args, full=full)
    if not bool(torch.isfinite(got[0]).all()):
        raise AssertionError("compact kernel: non-finite spectrum")
    n = got[0].shape[-1]
    margins = {}
    if has_decisions(cfg):
        env, frc, stress = ipk._unpack_inputs(cfg, args[1].double(),
                                              args[2].double())
        margins = decision_margins(
            impl.implsch(cfg, args[0].double(), env, frc, *stress)[1])
    keep = ~held(margins, dict(gc=gc_width, peak=peak_width),
                 point_errors(got[1], want[1]), off_tol)
    r = dict(spec=float((got[0] - want[0])[..., keep].abs().max()
                        / want[0][..., keep].abs().max()),
             bins=got[0].numel(), xllws=0, off_edge=0, margin=0.0,
             held=int((~keep).sum()), n=n)
    if full:
        kept = torch.nonzero(keep).flatten()
        margin = compact_margin(cfg, *args)
        fe = full_errors(got[1][:, keep], want[1][:, keep],
                         got[2][..., keep], want[2][..., keep],
                         lambda pts: margin(kept[pts]), width)
        r.update(rows=float(fe["err"].max()), xllws=int(fe["edge"].sum()),
                 off_edge=int(fe["off"].sum()),
                 margin=float(fe["margin"].max()))
    else:
        r["rows"] = float(row_errors(got[1][:, keep],
                                     want[1][:, keep]).max())
    return r


def full_kernel_vs_plain(kw: dict, device, *, width: float, forcing=None,
                         phys=None, gc_width: float = 0.0,
                         peak_width: float = 0.0,
                         off_tol: float = 0.0, rows=None) -> dict:
    """One full-mode physics step (see :func:`_physics_step`, on ``rows``
    rows if given): kernel against plain.  Returns the spectrum error, {row name: error} over the
    SCAL_OUT_FULL rows, and the xllws bins that differ on and off the
    mask's edge (:func:`full_errors` with ``width``) with the largest
    |margin| among them, over the rows off a decision edge (:func:`held`,
    rows above ``off_tol`` within ``gc_width`` or ``peak_width``;
    ``held`` counts them)."""
    got, want, margin_at, margins = _physics_step(kw, device, full=True,
                                                  forcing=forcing, phys=phys,
                                                  rows=rows)
    n = got[0].shape[0]
    keep = ~held(margins, dict(gc=gc_width, peak=peak_width),
                 point_errors(got[1], want[1]), off_tol)
    kept = torch.nonzero(keep).flatten()
    fe = full_errors(got[1][:, keep], want[1][:, keep], got[3][..., keep],
                     want[3][..., keep], lambda pts: margin_at(kept[pts]),
                     width)
    rows = fe["err"].amax(1)
    return dict(spec=spectrum_error(got, want, keep),
                held=int((~keep).sum()), n=n,
                rows={k: float(rows[i])
                      for i, k in enumerate(ipk.SCAL_OUT_FULL)},
                xllws=int(fe["edge"].sum()), off_edge=int(fe["off"].sum()),
                margin=float(fe["margin"].max()),
                flip_points=int(((fe["edge"] + fe["off"]) > 0).sum()),
                bins=got[3].numel())


def golden_kernel_vs_plain(device, nsteps: int = 4,
                           kw: dict | None = None) -> tuple[dict, dict]:
    """The golden configuration (or ``build_model(**kw)``) advanced
    ``nsteps`` steps (forcing swapped every 2) through the kernels and
    through the plain versions, both on ``device``.  Returns ({"fl1" and
    each stress field: max|k−p| over max|p|}, {"kernels"/"plain":
    (advection, physics) launches})."""
    ms = build_model(device=device, **(kw or golden_kw()))
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


# the dense WaveModel's weight modes, and the trajectory oracle's
# configurations on the golden grid (tests/test_trajectory_oracle.py:65):
# fast waves with depth refraction, and the currents with irefra 3 (no
# fast waves: the OTF mode refuses them under current refraction)
WEIGHT_MODES = ("cached", "otf", "fused")
OTF_BLOCK = 4
WAVEMODEL_CASES = {
    "fastwaves_refra1": golden_kw,
    "currents3": lambda: dict(golden_kw(irefra=3, currents=True),
                              idelt=900.0, delpro_lf=None, ifrelfmax=0),
}


def wavemodel_kernel_vs_plain(device, config: str, mode: str,
                              nsteps: int = 4) -> tuple[dict, dict, dict]:
    """``WaveModel`` on :data:`WAVEMODEL_CASES`' ``config`` in weight
    ``mode`` (``otf`` in blocks of OTF_BLOCK), ``nsteps`` steps under the
    golden forcing (swapped every 2) through the kernels and through the
    plain versions, both on ``device``.  Returns ({"fl1" and each stress
    field: max|k−p| over max|p|}, {"kernels"/"plain": (kernel A passes,
    kernel C launches)}, and the (passes, launches) the step loop implies
    through the kernels)."""
    ms = build_model(device=device, weights_mode=mode, otf_block=OTF_BLOCK,
                     **WAVEMODEL_CASES[config]())
    forcing_at = golden_forcing(ms.n_real)
    runs, launched = {}, {}
    for plain in (False, True):
        m = WaveModel(ms, provider(forcing_at, ms.idelpro), START,
                      plain=plain)
        a0, c0 = pcu.advect.launches, ipk.implsch_compact.launches
        m.advance(nsteps, wind_every=2)
        name = "plain" if plain else "kernels"
        launched[name] = (pcu.advect.launches - a0,
                          ipk.implsch_compact.launches - c0)
        runs[name] = m
    nsub = (max(1, round(ms.idelpro / ms.delpro_lf))
            if ms.ifrelfmax > 0 else 1)
    phys = sum(1 for i in range(1, nsteps + 1)
               if (i * ms.idelpro) % ms.idelt < 1e-6)
    want = (nsteps * nsub if mode == "fused" else 0, phys)
    k, p = runs["kernels"], runs["plain"]
    pairs = dict(fl1=(k.fl1, p.fl1))
    pairs.update((s, (k.stress[s], p.stress[s])) for s in ipk.STRESS_KEYS)
    err = {name: float((a - b).abs().max() / b.abs().max())
           for name, (a, b) in pairs.items()}
    return err, launched, want


def ustar_model(device, icode: int, *, plain: bool = False,
                ustar: float = 0.5):
    """tests/test_forcing_fidelity.py's u* case: the 12° aqua grid, 12×25,
    idelpro = idelt = 900 s, cached weights, u* forcing (``icode`` 1 or 2)
    of ``ustar`` m/s everywhere with no U10 (zero wind speed).  Returns
    the setup and a ``WaveModel`` whose stress state has taken the
    forcing's u* (``newwind``)."""
    ms = build_model(grid_name="12.0", nang=12, nfre=25, idelpro=900.0,
                     idelt=900.0, pad_to=64, icode_wnd=icode,
                     weights_mode="cached", device=device)
    n = ms.n_real

    def at(date14):
        return dict(wswave=np.zeros(n), wdwave=np.zeros(n),
                    aird=np.full(n, 1.225), wstar=np.zeros(n),
                    cicover=np.zeros(n), ufric=np.full(n, ustar))
    m = WaveModel(ms, at, START, plain=plain)
    return ms, m.newwind(m.date)


def wavemodel_inputs(model: WaveModel, stress: dict | None = None):
    """A ``WaveModel``'s state as the compact entry takes it: (fl1,
    env2d, scal) at every point (with ``stress`` in place of the
    model's, if given)."""
    from ecwam_tpu_torch.model import stepper
    ms = model.setup
    return (model.fl1.contiguous(), stepper.physics_env(ms),
            stepper.physics_scal(ms, model.frc, stress or model.stress))
