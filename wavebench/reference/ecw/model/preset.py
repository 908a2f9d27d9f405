"""Cold-start initial spectra (the `ecwam-preset` equivalent).

Copied unchanged from ``ecwam_tpu/model/preset.py`` (numpy only, no
JAX), with its imports pointed at ``wavebench.reference.ecw``: the port
imports nothing of the JAX package.

Re-derivations of:
  - PEAK     fetch-law peak frequency / Phillips parameter
             (peak.F90:38-53, yowjons.F90:18-21)
  - JONSWAP  1-D JONSWAP spectrum                (jonswap.F90:39-62)
  - SPR      cos² directional spreading          (spr.F90:40-52)
  - MSTART   assembly by start option IOPTI      (mstart.F90:49-80)

Defaults follow the operational preset run script
(share/ecwam/scripts/ecwam_run_preset.sh:153-206: IOPTI=1, ALFA=0.018,
GAMMA=3.0, SA=0.07, SB=0.09, FETCH=50 km, FM=0.2 Hz).
"""

from __future__ import annotations

import numpy as np

from wavebench.reference.ecw.core import constants as c

AJONS = 2.84             # fetch-law constants (yowjons.F90:18-21)
BJONS = 0.033
DJONS = -3.0 / 10.0
EJONS = 2.0 / 3.0


def peak(u10, fetch: float, fpmax: float, xp=np):
    """Fetch-limited peak frequency and alpha (peak.F90:38-53).

    ``xp`` selects the array backend (numpy on host, jax.numpy for the
    on-device cold start — MSTART is closed-form per point, so building
    the initial state on device avoids shipping the full spectrum
    through the host)."""
    if xp is np:
        u10 = np.asarray(u10, dtype=np.float64)
    windy = u10 > 0.1e-8
    u = xp.where(windy, u10, 1.0)
    gxu = c.G * fetch / (u * u)
    ug = c.G / u
    fp = xp.maximum(AJONS * gxu**DJONS, 0.13)
    fp = xp.minimum(fp, fpmax / ug)
    alphaj = xp.maximum(BJONS * fp**EJONS, 0.0081)
    return xp.where(windy, fp * ug, 0.0), xp.where(windy, alphaj, 0.0)


def jonswap_1d(fr, fp, alphaj, zgamma: float, sa: float, sb: float,
               xp=np):
    """JONSWAP spectrum ET(pt, nfre) (jonswap.F90:39-62)."""
    fr = xp.asarray(fr)[None, :]
    fp = xp.asarray(fp)[:, None]
    alphaj = xp.asarray(alphaj)[:, None]
    sigma = xp.where(fr > fp, sb, sa)
    active = (alphaj != 0.0) & (fp != 0.0)
    fp_safe = xp.where(fp == 0.0, 1.0, fp)
    earg = xp.minimum(0.5 * ((fr - fp_safe) / (sigma * fp_safe)) ** 2, 50.0)
    fjon = zgamma ** xp.exp(-earg)
    fmpf = xp.minimum(1.25 * (fp_safe / fr) ** 4, 50.0)
    et = (alphaj / (fr**5 * c.ZPI4GM2)) * xp.exp(-fmpf) * fjon
    return xp.where(active, et, 0.0)


def spread(th, thetaq, xp=np):
    """cos² spreading ST(pt, nang) (spr.F90:40-52)."""
    the = xp.cos(xp.asarray(th)[None, :] - xp.asarray(thetaq)[:, None])
    st = (2.0 / c.PI) * the**2
    st = xp.where(st < 0.1e-8, 0.0, st)
    return xp.where(the > 0.0, st, 0.0)


def mstart(tb, wswave, wdwave, *, iopti: int = 1,
           fetch: float = 50000.0, frmax: float = 0.2,
           alfa: float = 0.018, fm: float = 0.2, zgamma: float = 3.0,
           sa: float = 0.07, sb: float = 0.09, thetaq: float = 0.0):
    """Initial spectra fl1 (nang, nfre, npts) (mstart.F90:49-80)."""
    npts = len(wswave)
    if iopti == 1:
        fp, alphaj = peak(wswave, fetch, frmax)
        thes = np.asarray(wdwave)
    elif iopti == 0:
        fp = np.full(npts, fm)
        alphaj = np.full(npts, alfa)
        thes = np.full(npts, thetaq)
    elif iopti == 2:
        fp, alphaj = peak(wswave, fetch, frmax)
        calm = np.asarray(wswave) <= 0.1e-8
        fp = np.where(calm, fm, fp)
        alphaj = np.where(calm, alfa, alphaj)
        thes = np.where(calm, 0.0, np.asarray(wdwave))
    else:
        raise ValueError(f"IOPTI={iopti} not supported")
    et = jonswap_1d(tb.fr, fp, alphaj, zgamma, sa, sb)   # (npts, nfre)
    st = spread(tb.th, thes)                             # (npts, nang)
    return np.transpose(st[:, :, None] * et[:, None, :], (1, 2, 0))


# MSWELL fixed swell systems (mswell.F90:66-95): (Hs, dir°, ωp, L, lat, lon)
MSWELL_SYSTEMS = (
    (2.0, 135.0, 0.3117, 250000.0, 47.0, 165.0),
    (2.0, 90.0, 0.3117, 200000.0, -50.0, 20.0),
    (2.0, 180.0, 0.3117, 200000.0, 35.0, 331.0),
    (2.0, 45.0, 0.3117, 150000.0, 52.0, 329.0),
)
MSWELL_NSP = 5


def mswell(tb, plat, plon):
    """Swell-only cold start (mswell.F90:40-170): four localized swell
    systems with ω^-(NSP+1) spectra, cos⁴ spreading and exponential
    spatial decay over a great-circle distance scale.

    Returns fl1 (nang, nfre, npts).
    """
    npts = len(plat)
    nang, nfre = tb.nang, tb.nfre
    fl1 = np.zeros((nang, nfre, npts))
    cq0 = 16.0 / (3.0 * c.ZPI)
    omega = c.ZPI * np.asarray(tb.fr)                  # (nfre,)
    nsp = MSWELL_NSP
    for (h0, th0_deg, omegap, xl, lat0, lon0) in MSWELL_SYSTEMS:
        theta0 = c.RAD * th0_deg
        cosdir = np.cos(np.asarray(tb.th) - theta0)
        q0 = np.where(cosdir > 0.0, cq0 * cosdir**4, 0.0)
        e0 = h0**2 / 16.0
        cex = (nsp + 1.0) / nsp
        cs0 = (nsp + 1) * e0 * omegap**nsp
        s0 = (cs0 / omega ** (nsp + 1)) * np.exp(
            -cex * (omegap / omega) ** nsp)
        s0 = np.where(s0 < 0.001, 0.0, s0)
        fl0 = q0[:, None] * s0[None, :]                # (nang, nfre)
        # haversine angular distance (yowsphere.F90:33-80)
        slat = np.sin(0.5 * (lat0 - np.asarray(plat)) * c.RAD) ** 2
        slon = np.sin(0.5 * (lon0 - np.asarray(plon)) * c.RAD) ** 2
        h = np.sqrt(np.maximum(
            slat + np.cos(lat0 * c.RAD)
            * np.cos(np.asarray(plat) * c.RAD) * slon, 0.0))
        ang = 2.0 * np.arcsin(np.minimum(h, 1.0))
        dist = 2.0 * c.R_EARTH * ang / xl
        sprd = np.where(dist < 10.0, np.exp(-dist), 0.0)
        fl1 += fl0[:, :, None] * sprd[None, None, :]
    return fl1
