"""Derived output parameters (the OUTBS/OUTBLOCK catalog).

Port of ``ecwam_tpu/io/products.py``: the integrated-parameter
computations of outblock.F90:153-612 and the helpers it calls (femean,
sthq, dominant_period, sepwisw, wdirspread, kurtosis, sebtmean, weflux,
cimsstrn, ctcor, meansqs, mwp1/mwp2, outbeta).  Parameter names follow
share/ecwam/parameters.yml (numeric-only names get a ``p`` prefix, e.g.
``p062`` = wave energy flux magnitude).  In the reference these run
outside any Pallas kernel, so they are plain PyTorch here, evaluated
eagerly on the tensors' device; the reference jits the whole catalog as
one XLA program instead.

Direction convention: output directions are degrees in meteorological
convention ``mod(deg·θ + 180, 360)`` (outblock.F90:186).

Point-field functions take fl1 (nang, nfre, npts) and return (npts,).
``compute()`` evaluates the requested fields through one
:class:`ProductContext`, so the shared intermediates (windsea/swell
separation, kurtosis chain, energy flux) are evaluated once.  The
swell-train fields (``p042``-``p050``) run the host partitioning of
:mod:`ecwam_tpu_torch.io.partition` (SEP3TR, numpy) on host copies of the
per-bin swell mask and the spectrum, as the reference does; they need the
windsea mask of a full-mode step on the compact spectrum (the dense
``WaveModel``'s state), and the chunked output path refuses them.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ecwam_tpu_torch.core import constants as c
from ecwam_tpu_torch.core import physparams as pp
from ecwam_tpu_torch.core import spectral as sp
from ecwam_tpu_torch.io import extremes
from ecwam_tpu_torch.ops.physics import const
from ecwam_tpu_torch.ops.physics import gc as gc_mod
from ecwam_tpu_torch.ops.physics import means as means_mod
from ecwam_tpu_torch.ops.physics import stokes as stokes_mod

OLDWSFC = 1.2       # windsea-threshold wind factor (yowfred.F90:82)
FRIC = 28.0         # friction scaling (yowfred.F90:81)

# significant-wave-height period bands '064'..'069' (IPRMINFO cols 4/5;
# descriptions in parameters.yml: 10-12, 12-14, 14-17, 17-21, 21-25, 25-30 s)
TEWH_BANDS = ((10.0, 12.0), (12.0, 14.0), (14.0, 17.0),
              (17.0, 21.0), (21.0, 25.0), (25.0, 30.0))


def swh(fl1, tb):
    em, _ = means_mod.femean(fl1, tb)
    return 4.0 * torch.sqrt(torch.clamp(em, min=0.0))


def mean_direction(fl1, tb):
    """THQ in radians (sthq.F90:40-75)."""
    temp = torch.sum(fl1 * const(tb.dfim, fl1)[None, :, None], dim=1)
    si = torch.sum(const(tb.sinth, fl1)[:, None] * temp, dim=0)
    ci = torch.sum(const(tb.costh, fl1)[:, None] * temp, dim=0)
    ci = torch.where(ci == 0.0, torch.full_like(ci, c.EPSMIN), ci)
    thq = torch.atan2(si, ci)
    return torch.where(thq < 0.0, thq + c.ZPI, thq)


def to_met_deg(theta):
    """Radians → meteorological degrees (outblock.F90:186)."""
    return torch.remainder(c.DEG * theta + 180.0, 360.0)


def mwd(fl1, tb):
    return to_met_deg(mean_direction(fl1, tb))


def mwp(fl1, tb, zmiss: float = c.ZMISS):
    _, fm = means_mod.femean(fl1, tb)
    return torch.where(fm > 0.0, 1.0 / fm, torch.full_like(fm, zmiss))


def pp1d(fl1, tb):
    """Dominant period (dominant_period.F90:42-85)."""
    fcrop = 0.1 * torch.amax(fl1, dim=(0, 1), keepdim=True)
    f1d4 = torch.sum(torch.where(fl1 > fcrop, fl1, torch.zeros_like(fl1)),
                     dim=0) * tb.delth
    f1d4 = f1d4**4                                # (nfre, npts)
    em = torch.sum(const(tb.dfim, fl1)[:, None] * f1d4, dim=0)
    dp = torch.sum(const(tb.dfimfr, fl1)[:, None] * f1d4, dim=0)
    good = (em > 0.0) & (dp > c.EPSMIN)
    return torch.where(good, em / torch.where(good, dp, torch.ones_like(dp)),
                       torch.zeros_like(em))


def pp1d_margin(fl1, tb):
    """Each point's distance from PP1D's crop edge fl1 > 0.1·max: min
    over bins of |fl1 − 0.1·max| / max (a bin nearer than a small width
    may be cropped the other way in float32)."""
    fmax = torch.amax(fl1, dim=(0, 1))
    d = torch.amin((fl1 - 0.1 * fmax).abs(), dim=(0, 1))
    return d / torch.clamp(fmax, min=1e-300)


def wind_direction(wdwave):
    return torch.remainder(c.DEG * wdwave + 180.0, 360.0)


def cdww(u10, ustar, z0b, chrnck, params, *, llgcbz0: bool = False):
    """Drag coefficient from the wave-modified Charnock (outbeta.F90:58-80)."""
    if llgcbz0:
        alphamax_u10 = torch.full_like(u10, pp.ALPHAMAX)
    else:
        alphamax_u10 = torch.clamp(0.02 + 0.01 * u10, max=pp.ALPHAMAX)
    usm = 1.0 / torch.clamp(ustar, min=c.EPSUS)
    betam = torch.clamp(torch.minimum(chrnck, alphamax_u10),
                        min=params.alphamin)
    z0atm = pp.RNUM * usm + c.GM1 * betam * ustar**2
    cd = (pp.XKAPPA / torch.log(1.0 + pp.XNLEV / z0atm)) ** 2
    return torch.clamp(cd, max=0.01)


def _simpson_period(fl1, tb, moment_weight, tail_coef, sqrt_out: bool):
    nfre_odd = tb.nfre - 1 + tb.nfre % 2
    temp = torch.sum(fl1[:, :nfre_odd], dim=0)      # (nfre_odd, npts)
    em = torch.sum(const(tb.dfim_sim[:nfre_odd], fl1)[:, None] * temp, dim=0)
    mw = torch.sum(const(moment_weight[:nfre_odd], fl1)[:, None] * temp,
                   dim=0)
    t_last = temp[-1]
    em = em + sp.WETAIL * tb.fr[nfre_odd - 1] * tb.delth * t_last
    mw = mw + tail_coef * t_last
    good = (em > 0.0) & (mw > c.EPSMIN)
    ratio = em / torch.where(good, mw, torch.ones_like(mw))
    if sqrt_out:
        ratio = torch.sqrt(ratio)
    return torch.where(good, torch.clamp(ratio, max=1.0 / tb.fr[0]),
                       torch.zeros_like(ratio))


def mwp1(fl1, tb):
    """Mean period from the f-moment, Simpson rule (mwp1.F90:55-95)."""
    nfre_odd = tb.nfre - 1 + tb.nfre % 2
    coef = sp.WP1TAIL * tb.delth * tb.fr[nfre_odd - 1] ** 2
    return _simpson_period(fl1, tb, tb.dfimfr_sim, coef, sqrt_out=False)


def mwp2(fl1, tb):
    """Mean period from the f²-moment, Simpson rule (mwp2.F90:48-90)."""
    nfre_odd = tb.nfre - 1 + tb.nfre % 2
    coef = sp.WP2TAIL * tb.delth * tb.fr[nfre_odd - 1] ** 3
    return _simpson_period(fl1, tb, tb.dfimfr2_sim, coef, sqrt_out=True)


def _scosfl(fm, tb):
    """Mean-direction cosine Fourier coefficient of one frequency's
    directional distribution fm (nang, npts) (scosfl.F90:90-120)."""
    si = torch.sum(const(tb.sinth, fm)[:, None] * fm, dim=0)
    ci = torch.sum(const(tb.costh, fm)[:, None] * fm, dim=0)
    meandir = torch.where((ci == 0.0) & (si == 0.0), torch.zeros_like(ci),
                          torch.atan2(si, ci))
    th = const(tb.th, fm)[:, None]
    return tb.delth * torch.sum(torch.cos(th - meandir[None, :]) * fm, dim=0)


def _scosfl_at(fl1, m_index, tb):
    """:func:`_scosfl` at per-point frequency index ``m_index``."""
    nang = fl1.shape[0]
    fm = torch.gather(fl1, 1, m_index.to(torch.int64)[None, None, :]
                      .expand(nang, 1, -1))[:, 0]
    return _scosfl(fm, tb)


def wdirspread(fl1, emean, tb, *, llpeakf: bool = True):
    """Directional width σ=√(2(1−R1)) (wdirspread.F90:98-158): at the
    spectral peak (LLPEAKF, the form SEPWISW calls; ``emean`` unused) or
    integrated over frequency against the mean energy ``emean``."""
    if llpeakf:
        # peak of the 1-D spectrum (peakfri.F90:84-115)
        f1d = torch.sum(fl1, dim=0) * tb.delth        # (nfre, npts)
        epeak, ipeak = torch.max(f1d, dim=0)
        r1 = _scosfl_at(fl1, ipeak, tb)
        pos = epeak > 0.0
        spread = torch.where(
            pos, torch.clamp(r1 / torch.where(pos, epeak,
                                              torch.ones_like(epeak)),
                             max=1.0), torch.ones_like(r1))
    else:
        acc = torch.zeros_like(emean)
        for m in range(tb.nfre):
            acc = acc + _scosfl(fl1[:, m], tb) * float(tb.dfim[m])
        temp = _scosfl(fl1[:, tb.nfre - 1], tb)
        acc = acc / tb.delth + temp * (sp.WETAIL * tb.fr[-1])
        big = emean > c.EPSMIN
        spread = torch.where(
            big, torch.clamp(acc / torch.clamp(emean, min=c.EPSMIN),
                             max=1.0), torch.ones_like(acc))
    return torch.sqrt(2.0 * torch.clamp(1.0 - spread, min=0.0))


def _connect_windsea_boundary(swm, fl1):
    """Topological connection of the windsea low-frequency boundary
    (sepwisw.F90:212-222): scanning from the highest frequency, while no
    two adjacent swell bins were met, a swell bin below a windsea bin with
    no greater energy is re-assigned to windsea."""
    nfre = swm.shape[1]
    new = [swm[:, nfre - 1]]
    stopped = torch.zeros_like(swm[:, 0], dtype=torch.bool)
    cur = swm[:, nfre - 1]
    for m in range(nfre - 1, 0, -1):
        prev = swm[:, m - 1]
        stopped = stopped | ((cur == 1.0) & (prev == 1.0))
        drop = (~stopped) & (cur == 0.0) & (prev == 1.0) & \
            (fl1[:, m] >= fl1[:, m - 1])
        prev = torch.where(drop, torch.zeros_like(prev), prev)
        new.append(prev)
        cur = prev
    return torch.stack(new[::-1], dim=1)


def sepwisw(fl1, xllws, cinv, ufric, wswave, wdwave, tb):
    """Windsea/swell split and both parameter sets (sepwisw.F90:120-300).

    Returns dict with eswell/fswell/thswell/p1swell/p2swell/sprdswell,
    esea/fsea/thwisea/p1sea/p2sea/sprdsea, the swell mask ``swm`` and the
    swell spectrum ``flsw`` (inputs to the train partitioning).
    """
    coef = OLDWSFC * FRIC
    th = const(tb.th, fl1)[:, None]
    coswdif = torch.cos(th - wdwave[None, :])         # (nang, npts)
    xinvwvage = ufric[None, :] * cinv                 # (nfre, npts)
    dircoef = coef * coswdif                          # (nang, npts)

    one, zero = torch.ones_like(fl1), torch.zeros_like(fl1)
    checkta = xinvwvage[None, :, :] * dircoef[:, None, :]
    swm = torch.where((xllws != 0.0) | (checkta >= 1.0), zero, one)

    # consistency check: swell mean freq must stay below windsea's
    # (sepwisw.F90:161-209)
    f_sw = fl1 * swm
    esw, fsw = means_mod.femean(f_sw, tb)
    ese, fse = means_mod.femean(torch.clamp(fl1 - f_sw, min=0.0), tb)
    r = (fsw > 0.96 * fse).to(fl1.dtype)
    dircoef2 = r[None, :] * coef * torch.sign(0.4 + coswdif)
    checkta2 = xinvwvage[None, :, :] * dircoef2[:, None, :]
    swm = torch.where(checkta2 >= 1.0, zero, swm)
    swm = _connect_windsea_boundary(swm, fl1)

    flsw = torch.clamp(fl1, min=c.EPSMIN) * swm
    eswell, fswell = means_mod.femean(flsw, tb)
    thswell = mean_direction(flsw, tb)
    p1swell = mwp1(flsw, tb)
    p2swell = mwp2(flsw, tb)
    sprdswell = wdirspread(flsw, eswell, tb)

    # windsea with direction-noise seeding (sepwisw.F90:269-280)
    m_idx = torch.as_tensor(np.arange(tb.nfre) >= tb.nfre // 2,
                            device=fl1.device)[None, :, None]
    noise_zone = m_idx & (coswdif[:, None, :] > 0.8)
    fsea_sp = torch.where(
        noise_zone,
        torch.clamp(fl1 - flsw + c.EPSMIN * coswdif[:, None, :] ** 4,
                    min=0.0),
        torch.clamp(fl1 - flsw, min=0.0))
    esea, fsea = means_mod.femean(fsea_sp, tb)
    thwisea = mean_direction(fsea_sp, tb)
    thwisea = torch.where(esea <= 1.0e-9, wdwave, thwisea)
    p1sea = mwp1(fsea_sp, tb)
    p2sea = mwp2(fsea_sp, tb)
    sprdsea = wdirspread(fsea_sp, esea, tb)

    return dict(eswell=eswell, fswell=fswell, thswell=thswell,
                p1swell=p1swell, p2swell=p2swell, sprdswell=sprdswell,
                esea=esea, fsea=fsea, thwisea=thwisea,
                p1sea=p1sea, p2sea=p2sea, sprdsea=sprdsea,
                swm=swm, flsw=flsw, coswdif=coswdif)


# ---------------------------------------------------------------------------
# period-band wave heights (sebtmean.F90:80-200, se10mean.F90:63-70)
# ---------------------------------------------------------------------------

def sebtmean(fl1, tb, tbot: float, ttop: float):
    """Variance between periods [tbot, ttop] s, trapezoid over the 1-D
    spectrum with interpolated band edges and f⁻⁵ tail (sebtmean.F90)."""
    fr = np.asarray(tb.fr, np.float64)
    nfre = tb.nfre
    fbot_r = 1.0 / max(ttop, 1e-10)          # lower frequency bound
    fcutb_ft = min(fbot_r, fr[-1])
    fcutb = max(fr[0], fcutb_ft)
    fbot = max(fbot_r, fr[-1])
    mcutb = 0
    while fr[mcutb] < fcutb and mcutb < nfre - 1:
        mcutb += 1
    ftop_r = 1.0 / max(tbot, 1e-10)
    fcutt = max(fr[0], min(ftop_r, fr[-1]))
    ftop = max(ftop_r, fr[-1])
    mcutt = nfre - 1
    while fr[mcutt] > fcutt and mcutt > 0:
        mcutt -= 1
    if fcutb == fcutt:
        mcutt = mcutb - 1

    f1d_all = torch.sum(fl1, dim=0) * tb.delth      # (nfre, npts)
    ebt = torch.full((fl1.shape[2],), c.EPSMIN, dtype=fl1.dtype,
                     device=fl1.device)

    frloc = fr.copy()
    f1d = {m: f1d_all[m] for m in range(nfre)}
    if mcutb > 0:
        frloc[mcutb - 1] = fcutb
        wl = (fr[mcutb] - fcutb) / (fr[mcutb] - fr[mcutb - 1])
        f1d[mcutb - 1] = wl * f1d_all[mcutb - 1] + (1.0 - wl) * f1d_all[mcutb]
    if mcutt < nfre - 1:
        frloc[mcutt + 1] = fcutt
        wl = (fr[mcutt + 1] - fcutt) / (fr[mcutt + 1] - fr[mcutt])
        f1d[mcutt + 1] = wl * f1d_all[mcutt] + (1.0 - wl) * f1d_all[mcutt + 1]

    for m in range(max(mcutb - 1, 0), min(mcutt, nfre - 2) + 1):
        df = 0.5 * (frloc[m + 1] - frloc[m])
        ebt = ebt + df * (f1d[m + 1] + f1d[m])

    if fcutb_ft < fcutb and fcutb == fr[0]:
        wl = (fr[0] - fcutb_ft) / fr[0]
        df = 0.5 * (fr[0] - fcutb_ft) * (1.0 + (1.0 - wl))
        ebt = ebt + df * f1d[0]

    if fbot < ftop:
        zw = 0.25 * float(tb.fr5[-1]) * (1.0 / fbot**4 - 1.0 / ftop**4)
        ebt = ebt + zw * f1d_all[nfre - 1]
    return ebt


def se10mean(fl1, tb):
    """Variance of waves with period > 10 s (se10mean.F90:63-70)."""
    return sebtmean(fl1, tb, 10.0, 1.0 / float(tb.fr[0]))


# ---------------------------------------------------------------------------
# wave energy flux, crest-trough correlation
# ---------------------------------------------------------------------------

def weflux(fl1, cgroup, tb):
    """Wave energy flux magnitude (W/m) and mean direction
    (weflux.F90:95-180)."""
    fcg = fl1 * cgroup[None, :, :]
    dfim = const(tb.dfim, fl1)[None, :, None]
    sinth = const(tb.sinth, fl1)[:, None]
    costh = const(tb.costh, fl1)[:, None]
    mag = torch.sum(fcg * dfim, dim=(0, 1))
    wefx = torch.sum(torch.sum(fcg * dfim, dim=1) * sinth, dim=0)
    wefy = torch.sum(torch.sum(fcg * dfim, dim=1) * costh, dim=0)
    # f⁻⁵ tail: group velocity → g/(4πf) deep-water weight (weflux.F90:137-155)
    delt = sp.FRTAIL * tb.delth * c.G / (2.0 * c.ZPI)
    t_last = fl1[:, -1, :]
    mag = mag + delt * torch.sum(t_last, dim=0)
    wefx = wefx + delt * torch.sum(t_last * sinth, dim=0)
    wefy = wefy + delt * torch.sum(t_last * costh, dim=0)
    mag = c.ROWATER * c.G * mag
    wefy = torch.where(wefy == 0.0, torch.full_like(wefy, c.EPSMIN), wefy)
    wdir = torch.atan2(wefx, wefy)
    wdir = torch.where(wdir < 0.0, wdir + c.ZPI, wdir)
    return mag, wdir


def ctcor(fl1, tb, zmiss: float = c.ZMISS):
    """Crest-trough correlation / spectral width index (ctcor.F90:68-120)."""
    temp = torch.sum(fl1, dim=0)                 # (nfre, npts)
    dfim = const(tb.dfim, fl1)[:, None]
    dfimfr = const(tb.dfimfr, fl1)[:, None]
    em = torch.sum(temp * dfim, dim=0)
    zt1 = torch.sum(temp * dfimfr, dim=0)
    pos = zt1 > 0.0
    zt1 = torch.where(
        pos, torch.clamp(em / torch.where(pos, zt1, torch.ones_like(zt1)),
                         max=1.0 / tb.fr[0]), torch.zeros_like(zt1))
    zarg = c.PI * const(tb.fr, fl1)[:, None] * zt1[None, :]
    zamp = dfim * temp
    zrho = torch.sum(zamp * torch.cos(zarg), dim=0)
    zlam = torch.sum(zamp * torch.sin(zarg), dim=0)
    big = em > 0.0
    return torch.where(big, torch.sqrt(zrho**2 + zlam**2)
                       / torch.where(big, em, torch.ones_like(em)),
                       torch.full_like(em, zmiss))


# ---------------------------------------------------------------------------
# ProductContext + catalog
# ---------------------------------------------------------------------------

class ProductContext:
    """Everything the catalog functions need for one output instant.

    ``state`` is the physics-step state dict (mij, stress fields, fluxes,
    Stokes drift, and ``sep``, the windsea/swell rows of the chunked
    full-mode step) merged with the stress state; ``env`` the depth
    property tables (wavnum/cgroup/cinv/depth/stokfac, shape (nfre, npts)
    or (npts,)); ``frc`` the current forcing.
    """

    def __init__(self, fl1, tb, state, frc, params, env=None, *,
                 llgcbz0: bool = False, ntrain: int = 3):
        self.fl1 = fl1
        self.ntrain = ntrain
        self.tb = tb
        self.state = state or {}
        self.frc = frc
        self.params = params
        self.env = env or {}
        self.llgcbz0 = llgcbz0

    def _zeros(self):
        return self.fl1.new_zeros(self.fl1.shape[2])

    @functools.cached_property
    def sep(self):
        st, frc = self.state, self.frc
        if "sep" in st:
            # per-point windsea/swell rows from the chunked full-mode
            # physics step (fusedstep.full_chunked_rows)
            return dict(st["sep"])
        xllws = st.get("xllws")
        if xllws is None:
            # before the first physics step (the step-0 output): no
            # windsea mask yet, as in the reference
            xllws = torch.zeros_like(self.fl1)
        return sepwisw(self.fl1, xllws, self.env["cinv"], st["ufric"],
                       frc["wswave"], frc["wdwave"], self.tb)

    @functools.cached_property
    def kurt(self):
        return extremes.kurtosis(self.fl1, self.env["depth"], self.tb)

    @functools.cached_property
    def wef(self):
        return weflux(self.fl1, self.env["cgroup"], self.tb)

    @functools.cached_property
    def trains(self):
        """Swell-train partitioning (sep3tr.F90), host numpy at output
        cadence (:mod:`ecwam_tpu_torch.io.partition`) on host copies of
        the windsea/swell separation with its per-bin swell mask."""
        from ecwam_tpu_torch.io import partition
        st, frc = self.state, self.frc
        sep = self.sep
        if "swm" not in sep:
            # the chunked full-mode state keeps only per-point rows; the
            # partitioning needs the per-bin swell mask
            if "xllws" not in st:
                raise NotImplementedError(
                    "swell-train products need the per-bin swell mask; "
                    "not available from the chunked full-mode step")
            sep = sepwisw(self.fl1, st["xllws"], self.env["cinv"],
                          st["ufric"], frc["wswave"], frc["wdwave"],
                          self.tb)

        def host(v):
            return v.detach().cpu().numpy()
        return partition.sep3tr(
            host(self.fl1), host(st["mij"]).astype(np.int32),
            {k: host(v) for k, v in sep.items()}, host(frc["wswave"]),
            host(frc["wdwave"]), self.tb, ntrain=self.ntrain)

    @functools.cached_property
    def coswdif(self):
        th = const(self.tb.th, self.fl1)[:, None]
        return torch.cos(th - self.frc["wdwave"][None, :])


def _hs_of(key):
    return lambda ctx: 4.0 * torch.sqrt(torch.clamp(ctx.sep[key], min=0.0))


def _inv_period(key):
    def fn(ctx):
        f = ctx.sep[key]
        return torch.where(f > 0.0, 1.0 / torch.clamp(f, min=c.EPSMIN),
                           torch.full_like(f, c.ZMISS))
    return fn


def _train(field, i):
    """Train ``i``'s wave height, direction (meteorological degrees) or
    peak period from the host partitioning, on the spectrum's device."""
    def fn(ctx):
        v = torch.as_tensor(ctx.trains[field][:, i], dtype=ctx.fl1.dtype,
                            device=ctx.fl1.device)
        if field == "thtrain":
            # the reference's compute() converts the trains with
            # np.degrees, not the rounded DEG of to_met_deg
            return torch.remainder(torch.rad2deg(v) + 180.0, 360.0)
        if field == "emtrain":
            return 4.0 * torch.sqrt(torch.clamp(v, min=0.0))
        return v
    return fn


CATALOG = {
    # --- core integrated parameters (outblock.F90:223-300)
    "swh": lambda ctx: swh(ctx.fl1, ctx.tb),
    "mwd": lambda ctx: mwd(ctx.fl1, ctx.tb),
    "mwp": lambda ctx: mwp(ctx.fl1, ctx.tb),
    "ustar": lambda ctx: ctx.state["ufric"],
    "dwi": lambda ctx: wind_direction(ctx.frc["wdwave"]),
    "pp1d": lambda ctx: pp1d(ctx.fl1, ctx.tb),
    "cdww": lambda ctx: cdww(ctx.frc["wswave"], ctx.state["ufric"],
                             ctx.state["z0b"], ctx.state["chrnck"],
                             ctx.params, llgcbz0=ctx.llgcbz0),
    "tauw_over_ust2": lambda ctx: ctx.state["tauw"]
    / torch.clamp(ctx.state["ufric"] ** 2, min=c.EPSUS),
    # default cutoff is the last gravity-capillary wavenumber
    # (userin.F90:1213-1216)
    "msqs": lambda ctx: gc_mod.meansqs(
        float(gc_mod.gc_tables().xk[-1]), ctx.fl1, ctx.env["wavnum"],
        ctx.state["ufric"], ctx.coswdif, ctx.tb, ctx.params),
    # mss over the model prognostic range only (outblock.F90:605-609)
    "msqs_mod": lambda ctx: gc_mod.meansqs(
        float((c.ZPI * ctx.tb.fr[-1]) ** 2 / c.G), ctx.fl1,
        ctx.env["wavnum"], ctx.state["ufric"], ctx.coswdif, ctx.tb,
        ctx.params),
    "wind": lambda ctx: ctx.frc["wswave"],
    # --- windsea / swell (outblock.F90:302-345, 23-28)
    "shww": _hs_of("esea"),
    "shts": _hs_of("eswell"),
    "mdww": lambda ctx: to_met_deg(ctx.sep["thwisea"]),
    "mdts": lambda ctx: to_met_deg(ctx.sep["thswell"]),
    "mpww": _inv_period("fsea"),
    "mpts": _inv_period("fswell"),
    "p1ww": lambda ctx: ctx.sep["p1sea"],
    "p1ps": lambda ctx: ctx.sep["p1swell"],
    "p2ww": lambda ctx: ctx.sep["p2sea"],
    "p2ps": lambda ctx: ctx.sep["p2swell"],
    "dwww": lambda ctx: ctx.sep["sprdsea"],
    "dwps": lambda ctx: ctx.sep["sprdswell"],
    # --- moments / widths
    "mp1": lambda ctx: mwp1(ctx.fl1, ctx.tb),
    "mp2": lambda ctx: mwp2(ctx.fl1, ctx.tb),
    "wdw": lambda ctx: wdirspread(
        ctx.fl1, means_mod.femean(ctx.fl1, ctx.tb)[0], ctx.tb,
        llpeakf=False),
    # --- freak-wave / extremes (kurtosis.F90)
    "wsk": lambda ctx: ctx.kurt["c4"],
    "bfi": lambda ctx: ctx.kurt["bfi2"],
    "wsp": lambda ctx: ctx.kurt["qp"],
    "hmax": lambda ctx: ctx.kurt["hmax"],
    "tmax": lambda ctx: ctx.kurt["tmax"],
    "p057": lambda ctx: ctx.kurt["c3"],
    "p070": lambda ctx: ctx.kurt["eta_m"],
    "p071": lambda ctx: ctx.kurt["r"],
    "p072": lambda ctx: ctx.kurt["xnslc"],
    # --- bathymetry / environment
    "wmb": lambda ctx: ctx.env["depth"],
    "p053": lambda ctx: ctx.frc["aird"],
    "p054": lambda ctx: ctx.frc["wstar"],
    "ci": lambda ctx: ctx.frc["cicover"],
    "p056": lambda ctx: ctx.frc.get("cithick", ctx._zeros()),
    "ocu": lambda ctx: ctx.frc.get("ucur", ctx._zeros()),
    "vcu": lambda ctx: ctx.frc.get("vcur", ctx._zeros()),
    # --- Stokes drift & air-sea fluxes (state from implsch)
    "ust": lambda ctx: ctx.state["ustokes"],
    "vst": lambda ctx: ctx.state["vstokes"],
    "p039": lambda ctx: ctx.state["phieps"],
    "p040": lambda ctx: ctx.state["phiaw"],
    "p041": lambda ctx: ctx.state["tauoc"],
    "p073": lambda ctx: ctx.state["tauxd"],
    "p074": lambda ctx: ctx.state["tauyd"],
    "p075": lambda ctx: ctx.state["tauocxd"],
    "p076": lambda ctx: ctx.state["tauocyd"],
    "p077": lambda ctx: torch.clamp(-ctx.state["phiocd"], min=0.0),
    # --- ice strain
    "p051": lambda ctx: stokes_mod.cimsstrn(
        ctx.fl1, ctx.env["wavnum"], ctx.env["depth"],
        ctx.frc.get("cithick", ctx._zeros()), ctx.tb),
    # --- period-band heights '052', '064'-'069'
    "p052": lambda ctx: 4.0 * torch.sqrt(
        torch.clamp(se10mean(ctx.fl1, ctx.tb), min=0.0)),
    # --- energy flux
    "p062": lambda ctx: ctx.wef[0],
    "p063": lambda ctx: to_met_deg(ctx.wef[1]),
    # --- crest-trough correlation
    "wss": lambda ctx: ctcor(ctx.fl1, ctx.tb),
}

for _i, (_tb, _tt) in enumerate(TEWH_BANDS):
    CATALOG[f"p{64 + _i:03d}"] = (
        lambda ctx, tbv=_tb, ttv=_tt: 4.0 * torch.sqrt(
            torch.clamp(sebtmean(ctx.fl1, ctx.tb, tbv, ttv), min=0.0)))

# swell trains '042'-'050': height, direction and period of trains 1-3,
# from the host partitioning
TRAIN_FIELDS = frozenset(f"p{i:03d}" for i in range(42, 51))
for _i, _n in enumerate(sorted(TRAIN_FIELDS)):
    CATALOG[_n] = _train(("emtrain", "thtrain", "pmtrain")[_i % 3], _i // 3)

# legacy aliases used by earlier configs/tests
CATALOG["mwp1"] = CATALOG["mp1"]
CATALOG["mwp2"] = CATALOG["mp2"]
CATALOG["mss"] = CATALOG["msqs"]

# fields read from the kurtosis chain (the intermediates compute() returns)
_KURT_FIELDS = frozenset(("wsk", "bfi", "wsp", "hmax", "tmax", "p057",
                          "p070", "p071", "p072"))


def compute(names, fl1, tb, state, frc, params, env=None, *,
            llgcbz0: bool = False, ntrain: int = 3,
            return_intermediates: bool = False):
    """Evaluate a list of catalog fields → dict name → (npts,) tensor, on
    fl1's device.

    Shared intermediates (sepwisw, kurtosis, weflux, and the host
    partitioning of the swell-train fields '042'-'050') are evaluated
    once per call.
    """
    ctx = ProductContext(fl1, tb, state, frc, params, env, llgcbz0=llgcbz0,
                         ntrain=ntrain)
    out = {n: CATALOG[n](ctx) for n in names}
    if return_intermediates:
        inter = dict(sep=ctx.sep)
        if any(n in _KURT_FIELDS for n in names):
            inter["kurt"] = ctx.kurt
        if any(n in TRAIN_FIELDS for n in names):
            inter["trains"] = ctx.trains
        return out, inter
    return out


def _slice_cols(tree: dict, s: int, count: int) -> dict:
    """Columns [s, s + count) of every tensor (nested dicts too): views
    on the tensors' device, no copy."""
    return {k: (_slice_cols(v, s, count) if isinstance(v, dict)
                else v[..., s:s + count]) for k, v in tree.items()}


def compute_chunked(names, fl1_chunk_fn, n_pad, tb, state, frc, params,
                    env=None, *, llgcbz0: bool = False,
                    chunk: int = 65536, so_correct=None):
    """Catalog evaluation chunked over the point axis — the at-scale
    output path (outblock.F90's NPROMA blocking role): the compact
    spectrum is pulled per chunk via ``fl1_chunk_fn(start, count)``
    (driver.FastWaveModel.fl1_chunk) and never formed whole; products are
    per-point reductions, so per-chunk results concatenate exactly.

    ``state``, ``frc`` and ``env`` are tensors on the model's device;
    each chunk takes views of their columns (no copy, no upload).
    ``so_correct(fl, env_chunk)`` optionally applies the second-order
    output correction per chunk.  Returns name → (n_pad,) tensor on the
    device.  Swell-train fields are not available on this path.
    """
    bad = [n for n in names if n in TRAIN_FIELDS]
    if bad:
        raise NotImplementedError(
            f"swell-train products {bad} are not available on the "
            "chunked output path")
    C = min(chunk, n_pad)
    # halo-extended variants have length n_pad+1 — drop them (the
    # catalog reads only the padded-point arrays)
    env = {k: v for k, v in (env or {}).items() if not k.endswith("_ext")}
    pieces = {n: [] for n in names}
    for s in range(0, n_pad, C):
        count = min(C, n_pad - s)
        fl_c = fl1_chunk_fn(s, count)
        env_c = _slice_cols(env, s, count)
        if so_correct is not None:
            fl_c = so_correct(fl_c, env_c)
        fields = compute(names, fl_c, tb, _slice_cols(state, s, count),
                         _slice_cols(frc, s, count), params, env=env_c,
                         llgcbz0=llgcbz0)
        for n in names:
            pieces[n].append(fields[n])
    return {n: torch.cat(v) for n, v in pieces.items()}
