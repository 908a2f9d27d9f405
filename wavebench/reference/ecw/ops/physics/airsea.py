"""Air-sea momentum closure: friction velocity / roughness length.

Port of ``ecwam_tpu/ops/physics/airsea.py``: CHNKMIN (chnkmin.F90:28),
Z0WAVE (z0wave.F90:40-60), TAUT_Z0's default Newton solve
(taut_z0.F90:230-290) and its LLGCBZ0 gravity-capillary branch
(taut_z0.F90:146-281), AIRSEA (airsea.F90:44-70) and WSIGSTAR
(wsigstar.F90:48-86).  All arrays are shape (npts,).  The loops run the
reference's fixed NITER=18 steps; the default Newton body is idempotent
at the fixed point, and the gravity-capillary branch turns the
reference's per-point early exits into convergence masks.
"""

from __future__ import annotations

import math

import torch

from wavebench.reference.ecw.core import constants as c
from wavebench.reference.ecw.core import physparams as pp
from wavebench.reference.ecw.ops.physics import gc as gc_mod

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


def _cdm(u):
    """Empirical neutral drag curve CDM (taut_z0 cdm.func.h)."""
    return torch.clamp(
        torch.minimum(0.0006 + 0.00008 * u,
                      0.001 + 0.0018 * torch.exp(-0.05 * (u - 33.0))),
        min=0.001)


def taut_z0_gc(utop, udir, tauw, tauwdir, ustar_guess, halp, rnfac,
               params: pp.PhysParams, *, iusfg: int = 0, gct=None):
    """LLGCBZ0 branch of the stress solve (taut_z0.F90:146-281).

    The total stress balance  u*² = tauw_eff + tau_visc + tau_gc  is solved
    by under-relaxed fixed-point iteration with the gravity-capillary stress
    from STRESS_GC, then z0/Charnock by a Newton iteration on the log
    profile.  The reference's per-point early exits become convergence
    masks; 'no convergence after NITER' fallbacks are applied per point.

    Returns (ustar, z0, z0b, chrnck, margin).  ``margin`` (npts,) is the
    smallest distance from its edge of any discrete decision that set the
    result: each convergence test evaluated before its loop's exit, as
    |(|Δ| − pce·x)/(pce·x)|; the fallback / second-stage test x1 vs pmax,
    as |x1 − pmax|/pmax; and each NS_GC floor inside the first loop, as
    its argument's distance from an integer (:func:`.gc.ns_gc_tie`).
    Where it is tiny two float32 versions may leave a loop at different
    iterations.
    """
    if gct is None:
        gct = gc_mod.gc_tables()
    z0min = 1.0e-6
    pmax = 0.99
    pce_gc = 0.001 if iusfg == 1 else 0.005
    rnukappam1 = 0.04 * pp.RNU / pp.XKAPPA

    cosdiff = torch.cos(udir - tauwdir)
    tauwact = torch.clamp(tauw * cosdiff, min=c.EPSMIN)
    llcosdiff = cosdiff > 0.9

    if params.llcapchnk:
        alphaog = chnkmin(utop, params) * c.GM1
    else:
        alphaog = torch.zeros_like(utop)

    usmax = torch.clamp(
        -0.21339 + utop * (0.093698 + utop * (-0.0020944 + 5.5091e-5 * utop)),
        min=0.03)
    tauweff = torch.minimum(tauwact * (1.0 + EPS1), usmax**2)

    if iusfg == 0:
        # first-guess drag coefficient (taut_z0.F90:163-180)
        x = torch.clamp(tauwact / torch.clamp(ustar_guess, min=c.EPSUS)**2,
                        max=pmax)
        zchar = torch.minimum(
            params.alpha * c.GM1 * ustar_guess**2 / torch.sqrt(1.0 - x),
            0.05 * torch.exp(-0.05 * (utop - 35.0)))
        zchar = torch.clamp(zchar, max=pp.ALPHAMAX)
        cdfg = torch.where(
            utop < 1.0, torch.full_like(utop, 0.002),
            torch.where(llcosdiff,
                        c.ACDLIN + c.BCDLIN * torch.sqrt(zchar) * utop,
                        _cdm(utop)))
        ustar = utop * torch.sqrt(cdfg)
    else:
        ustar = ustar_guess

    w1 = 0.85 - 0.05 * (torch.tanh(10.0 * (utop - 5.0)) + 1.0)
    xkutop = pp.XKAPPA * utop
    margin = torch.full_like(utop, torch.inf)

    def edge(live, d, scale):
        rel = ((d - scale) / scale).abs()
        return torch.where(live, torch.minimum(margin, rel), margin)

    ustold, tauold, ust = ustar, ustar**2, ustar
    z0c = torch.zeros_like(ustar)
    tauunr = torch.zeros_like(ustar)
    done = torch.zeros_like(ustar, dtype=torch.bool)
    for _ in range(NITER):
        z0n = torch.clamp(
            pp.XNLEV / (torch.exp(torch.clamp(xkutop / ustold, max=50.0))
                        - 1.0), min=z0min)
        tauv = rnukappam1 * ustold / z0n
        ang = (params.ang_gc_a
               + params.ang_gc_b * torch.tanh(params.ang_gc_c * tauold))
        tauunr_n = gc_mod.stress_gc(ang, ustold, z0n, z0min, halp, rnfac,
                                    gct, params)
        taunew = tauweff + tauv + tauunr_n
        ustmix = w1 * ustold + (1.0 - w1) * torch.sqrt(taunew)
        live = ~done
        margin = torch.where(live, torch.minimum(
            margin, gc_mod.ns_gc_tie(ustold, gct)), margin)
        margin = edge(live, (ustmix - ustold).abs(), pce_gc * ustmix)
        done_new = done | ((ustmix - ustold).abs() < pce_gc * ustmix)
        ust = torch.where(done, ust, ustmix)
        z0c = torch.where(done, z0c, z0n)
        tauunr = torch.where(done, tauunr, tauunr_n)
        tauold = torch.where(done_new, tauold, ustmix**2)
        ustold = torch.where(done_new, ustold, ustmix)
        done = done_new
    ustar, tauold1, conv1 = ust, tauold, done

    x1 = tauweff / tauold1
    margin = torch.minimum(margin, ((x1 - pmax) / pmax).abs())
    fallback = (~conv1) & (x1 >= pmax)
    ust_fb = utop * torch.sqrt(_cdm(utop))
    z0minrst = ust_fb**2 * params.alpha * c.GM1
    z0_fb = torch.maximum(
        pp.XNLEV / (torch.exp(torch.clamp(xkutop / ust_fb, max=50.0)) - 1.0),
        z0minrst)
    z0_ok = torch.clamp(
        pp.XNLEV / (torch.exp(torch.clamp(xkutop / ustar, max=50.0)) - 1.0),
        min=z0min)
    z0b_ok = z0_ok * torch.sqrt(tauunr / tauold1)
    ustar = torch.where(fallback, ust_fb, ustar)
    z0 = torch.where(fallback, z0_fb, z0_ok)
    z0b = torch.where(fallback, z0minrst, z0b_ok)

    # --- second stage: Newton solve for z0/Charnock where x1 < pmax
    second = x1 < pmax
    usnrf, z0nrf, z0bnrf = ustar, z0, z0b
    tau0 = torch.maximum(ustar**2, tauweff)
    alpog = torch.maximum(torch.clamp(z0b / tau0, max=pp.ALPHAMAX), alphaog)

    ustold, tauold, ust, z0c, z0bc = ustar, tau0, ustar, z0, z0b
    xk = torch.zeros_like(ustar)
    done = torch.zeros_like(ustar, dtype=torch.bool)
    for _ in range(NITER):
        x = torch.clamp(tauweff / tauold, max=pmax)
        ustm1 = 1.0 / torch.clamp(ustold, min=c.EPSUS)
        z0vis = pp.RNUM * ustm1
        h = 0.5 * z0vis / (1.0 - x)
        z0b_n = alpog * tauold
        z0_n = h + torch.sqrt(h**2 + z0b_n**2 / (1.0 - x))
        xologz0 = 1.0 / torch.log(pp.XNLEV / z0_n + 1.0)
        f = ustold - xkutop * xologz0
        zz = (2.0 * ustm1 * (3.0 * z0b_n**2 + 0.5 * z0vis * z0_n - z0_n**2)
              / (2.0 * z0_n**2 * (1.0 - x) - z0vis * z0_n))
        delf = 1.0 - xkutop * xologz0**2 * zz
        ust_n = torch.where(delf != 0.0, ustold - f / delf, ustold)
        taunew = torch.maximum(ust_n**2, tauweff)
        ust_n = torch.sqrt(taunew)
        margin = edge(~done & second, (taunew - tauold).abs(),
                      pce_gc * tauold)
        done_new = done | ((taunew - tauold).abs() < pce_gc * tauold)
        ust = torch.where(done, ust, ust_n)
        z0c = torch.where(done, z0c, z0_n)
        z0bc = torch.where(done, z0bc, z0b_n)
        xk = torch.where(done, xk, x)
        tauold = torch.where(done_new, tauold, taunew)
        ustold = torch.where(done_new, ustold, ust_n)
        done = done_new
    conv2 = done

    # no-convergence restore (taut_z0.F90:266-273)
    ust2 = torch.where(conv2, ust, usnrf)
    z02 = torch.where(conv2, z0c, z0nrf)
    z0b2 = torch.where(conv2, z0bc, z0bnrf)
    ustm1_2 = 1.0 / torch.clamp(ust2, min=c.EPSUS)
    chrnck_nc = torch.clamp(
        c.G * (z02 - pp.RNUM * ustm1_2) * ustm1_2**2, min=params.alphamin)
    chrnck_c = torch.clamp(
        c.G * (z0b2 / torch.sqrt(1.0 - xk)) * ustm1_2**2, min=params.alphamin)
    chrnck2 = torch.where(conv2, chrnck_c, chrnck_nc)

    # x1 >= pmax points skip the second stage (taut_z0.F90:278-281)
    ustm1_1 = 1.0 / torch.clamp(ustar, min=c.EPSUS)
    chrnck1 = torch.clamp(
        c.G * (z0 - pp.RNUM * ustm1_1) * ustm1_1**2, min=params.alphamin)
    ustar = torch.where(second, ust2, ustar)
    z0 = torch.where(second, z02, z0)
    z0b = torch.where(second, z0b2, z0b)
    chrnck = torch.where(second, chrnck2, chrnck1)
    return ustar, z0, z0b, chrnck, margin


def airsea(u10, udir, tauw, tauwdir, ustar, params: pp.PhysParams,
           *, icode_wnd: int = 3, iusfg: int = 0,
           wspmin: float = WSPMIN_DEFAULT, halp=None, rnfac=None,
           with_margin: bool = False):
    """Surface-stress dispatch (airsea.F90:44-70).

    icode_wnd==3: wind-speed forcing → TAUT_Z0 solve (LLGCBZ0 selects the
    gravity-capillary closure, which needs ``halp`` and ``rnfac``).
    icode_wnd in (1, 2): u* forcing → Z0WAVE + log-profile U10.

    Returns (u10, ustar, z0, z0b, chrnck), and with ``with_margin`` the
    gravity-capillary closure's decision margin (:func:`taut_z0_gc`;
    +inf for TAUT_Z0, which takes no discrete decision; for u* forcing
    Z0WAVE's relative gap (u*² − τw)/u*², whose inverse amplifies the
    rounding of its root's argument, +inf where the EPS1 floor holds).
    """
    if icode_wnd == 3:
        if params.llgcbz0:
            ustar, z0, z0b, chrnck, margin = taut_z0_gc(
                u10, udir, tauw, tauwdir, ustar, halp, rnfac, params,
                iusfg=iusfg)
        else:
            ustar, z0, z0b, chrnck = taut_z0(
                u10, udir, tauw, tauwdir, ustar, params, iusfg=iusfg)
            margin = torch.full_like(ustar, torch.inf)
        out = (u10, ustar, z0, z0b, chrnck)
        return out + (margin,) if with_margin else out
    if icode_wnd in (1, 2):
        z0, z0b, chrnck = z0wave(ustar, tauw, u10, params)
        u10_new = (1.0 / pp.XKAPPA) * ustar * (
            math.log(pp.XNLEV) - torch.log(z0))
        out = (torch.clamp(u10_new, min=wspmin), ustar, z0, z0b, chrnck)
        # the margin: Z0WAVE's relative gap u*² − τw over u*², whose
        # inverse amplifies rounding; +inf where the EPS1 floor holds
        gap = ustar**2 - tauw
        margin = torch.where(gap > EPS1, gap / ustar**2,
                             torch.full_like(gap, torch.inf))
        return out + (margin,) if with_margin else out
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
