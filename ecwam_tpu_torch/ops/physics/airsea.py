"""Air-sea momentum closure: friction velocity / roughness length.

Port of ``ecwam_tpu/ops/physics/airsea.py``: CHNKMIN (chnkmin.F90:28),
Z0WAVE (z0wave.F90:40-60), TAUT_Z0's default non-LLGCBZ0 Newton solve
(taut_z0.F90:230-290), AIRSEA (airsea.F90:44-70) and WSIGSTAR
(wsigstar.F90:48-86).  All arrays are shape (npts,).  The Newton loop
runs the reference's fixed NITER=18 steps (the body is idempotent at
the fixed point, so the reference's early exit does not change
converged results).
"""

from __future__ import annotations

import math

import torch

from ecwam_tpu_torch.core import constants as c
from ecwam_tpu_torch.core import physparams as pp

EPS1 = 0.00001            # tauw/u*² margin (yowtabl.F90:34)
NITER = 18
WSPMIN_DEFAULT = 1.0      # standalone minimum wind speed (userin.F90:917)


def chnkmin(u10, params: pp.PhysParams):
    """Minimum Charnock parameter for very high winds (chnkmin.F90:28)."""
    return params.alphamin + (params.alpha - params.alphamin) * 0.5 * (
        1.0 - torch.tanh(u10 - params.chnkmin_u))


def z0wave(us, tauw, u10, params: pp.PhysParams):
    """Roughness length from u* and wave stress (z0wave.F90:40-60).

    Returns (z0, z0b, chrnck).
    """
    if params.llcapchnk:
        alphaog = chnkmin(u10, params) * c.GM1
    else:
        alphaog = params.alpha * c.GM1
    ust2 = us**2
    arg = torch.clamp(ust2 - tauw, min=EPS1)
    z0 = alphaog * us**3 / torch.sqrt(arg)
    z0b = alphaog * ust2
    chrnck = c.G * z0 / ust2
    return z0, z0b, chrnck


def taut_z0(utop, udir, tauw, tauwdir, ustar_guess, params: pp.PhysParams,
            *, iusfg: int = 0):
    """Total stress / roughness closure, non-gravity-capillary branch
    (taut_z0.F90:230-290 "ELSE" branch of LLGCBZ0).

    Newton iteration on  u* = κ·U10 / log(XNLEV/z0tot)  with
    z0 = α·u*²/g / sqrt(1 - tauw/τ) + viscous sublayer.

    Returns (ustar, z0, z0b, chrnck).
    """
    cosdiff = torch.cos(udir - tauwdir)
    tauwact = torch.clamp(tauw * cosdiff, min=c.EPSMIN)
    tauweff = tauwact * (1.0 + EPS1)

    if params.llcapchnk:
        charnock_min = chnkmin(utop, params)
        xmin = 0.15 * (params.alpha - charnock_min)
        alphaog = charnock_min * c.GM1
    else:
        xmin = torch.zeros_like(utop)
        alphaog = torch.full_like(utop, params.alpha * c.GM1)

    xkutop = pp.XKAPPA * utop
    xlogxl = math.log(pp.XNLEV)

    if iusfg == 1:
        ustold = ustar_guess
    else:
        ustold = utop * torch.sqrt(
            torch.clamp(c.ACD + c.BCD * utop, max=c.CDMAX))
    tauold = torch.maximum(ustold**2, tauweff)
    ustar = torch.sqrt(tauold)
    ustm1 = 1.0 / torch.clamp(ustar, min=c.EPSUS)
    z0ch = torch.zeros_like(ustar)
    for _ in range(NITER):
        x = torch.maximum(tauwact / tauold, xmin)
        z0ch = alphaog * tauold / torch.sqrt(1.0 - x)
        z0vis = pp.RNUM * ustm1
        z0tot = z0ch + z0vis
        xologz0 = 1.0 / (xlogxl - torch.log(z0tot))
        f = ustar - xkutop * xologz0
        zz = ustm1 * (z0ch * (2.0 - 3.0 * x) / (1.0 - x) - z0vis) / z0tot
        delf = 1.0 - xkutop * xologz0**2 * zz
        ustar = torch.where(delf != 0.0, ustar - f / delf, ustar)
        tauold = torch.maximum(ustar**2, tauweff)
        ustar = torch.sqrt(tauold)
        ustm1 = 1.0 / torch.clamp(ustar, min=c.EPSUS)

    z0b = alphaog * tauold
    chrnck = torch.clamp(c.G * z0ch * ustm1**2, min=params.alphamin)
    return ustar, z0ch, z0b, chrnck


def airsea(u10, udir, tauw, tauwdir, ustar, params: pp.PhysParams,
           *, icode_wnd: int = 3, iusfg: int = 0,
           wspmin: float = WSPMIN_DEFAULT):
    """Surface-stress dispatch (airsea.F90:44-70).

    icode_wnd==3: wind-speed forcing → TAUT_Z0 solve.
    icode_wnd in (1, 2): u* forcing → Z0WAVE + log-profile U10.
    The gravity-capillary closure (LLGCBZ0) is not ported yet.

    Returns (u10, ustar, z0, z0b, chrnck).
    """
    if params.llgcbz0:
        raise NotImplementedError("LLGCBZ0 (taut_z0_gc) is not ported")
    if icode_wnd == 3:
        ustar, z0, z0b, chrnck = taut_z0(
            u10, udir, tauw, tauwdir, ustar, params, iusfg=iusfg)
        return u10, ustar, z0, z0b, chrnck
    if icode_wnd in (1, 2):
        z0, z0b, chrnck = z0wave(ustar, tauw, u10, params)
        u10_new = (1.0 / pp.XKAPPA) * ustar * (
            math.log(pp.XNLEV) - torch.log(z0))
        return torch.clamp(u10_new, min=wspmin), ustar, z0, z0b, chrnck
    raise ValueError(f"invalid ICODE_WND={icode_wnd}")


def wsigstar(wswave, ufric, z0m, wstar, params: pp.PhysParams,
             *, wspmin: float = WSPMIN_DEFAULT):
    """Relative standard deviation of u* from gustiness (wsigstar.F90:48-86)."""
    sig_nmax = 0.9
    bg_gust = 0.0
    onethird = 1.0 / 3.0
    if params.llgcbz0 or params.llnormagam:
        u10m1 = 1.0 / torch.clamp(wswave, min=wspmin)
        z0vis = pp.RNUM / torch.clamp(ufric, min=c.EPSUS)
        zchar = c.G * (z0m - z0vis) / torch.clamp(ufric**2, min=c.EPSUS)
        zchar = torch.clamp(zchar, params.alphamin, pp.ALPHAMAX)
        bcd_loc = c.BCDLIN * torch.sqrt(zchar)
        c_d = c.ACDLIN + bcd_loc * wswave
        dc_ddu = bcd_loc
        sig_conv = 1.0 + 0.5 * wswave / c_d * dc_ddu
        u10 = wswave
    else:
        u10 = torch.clamp(
            ufric / pp.XKAPPA * (math.log(10.0) - torch.log(z0m)),
            min=wspmin)
        u10m1 = 1.0 / u10
        c2u10p1 = c.C2CD * u10**c.P1CD
        u10p2 = u10**c.P2CD
        c_d = (c.C1CD + c2u10p1) * u10p2
        dc_ddu = (c.P2CD * c.C1CD + (c.P1CD + c.P2CD) * c2u10p1) * u10p2 * u10m1
        sig_conv = 1.0 + 0.5 * u10 / c_d * dc_ddu
    return torch.clamp(
        sig_conv * u10m1 * (bg_gust * ufric**3
                            + 0.5 * pp.XKAPPA * wstar**3) ** onethird,
        max=sig_nmax)
