"""Gravity-capillary spectrum subsystem, for the LLGCBZ0 closure.

Port of ``ecwam_tpu/ops/physics/gc.py``: the log-spaced wavenumber
tables of INITGC (initgc.F90:19-77, ω² = g·k + T·k³), NS_GC
(ns_gc.F90:17-24), OMEGAGC (omegagc.F90:20-34), STRESS_GC
(stress_gc.F90:40-106), MEANSQS_LF (meansqs_lf.F90), HALPHAP
(halphap.F90:30-100), and the output products' mean square slope,
MEANSQS_GC (meansqs_gc.F90:56-78) and MEANSQS (meansqs.F90:75-97).  The
tables are numpy, built once; the per-point functions are PyTorch over
(npts,) with the scalar loop over the NWAV = 82 gc wavenumbers as a
masked sum.

NS_GC floors a u*-dependent logarithm to the cut-off index; where that
argument sits next to an integer the index, and the gc stress with it,
may step on a last-bit change of u*.  :func:`ns_gc_tie` gives the
argument's distance from the nearest integer.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from wavebench.reference.ecw.core import constants as c
from wavebench.reference.ecw.core import physparams as pp
from wavebench.reference.ecw.ops.physics import const
from wavebench.reference.ecw.ops.physics import means as means_mod

KRATIO_GC = 1.2          # yowfred.F90:62
XKS_GC = 0.006           # smallest gc wavenumber (yowfred.F90:64)
XKL_GC = 20000.0         # largest gc wavenumber (yowfred.F90:65)
XLOGKRATIOM1_GC = 1.0 / math.log(KRATIO_GC)


def _fomeg(k: np.ndarray) -> np.ndarray:
    """Gravity-capillary dispersion ω(k) (gc_dispersion.h)."""
    return np.sqrt(c.G * k + c.SURFT * k**3)


@dataclasses.dataclass(frozen=True)
class GCTables:
    """Log-spaced gravity-capillary wavenumber tables (initgc.F90:48-77)."""

    nwav: int
    xk: np.ndarray            # wavenumbers k_i = XKS_GC·KRATIO^(i)
    xkm: np.ndarray           # 1/k
    omega: np.ndarray         # ω(k)
    omxkm3: np.ndarray        # ω/k³
    vg: np.ndarray            # group speed
    cm: np.ndarray            # 1/c
    c2osqrtvg: np.ndarray     # c²/√vg
    xkmsqrtvgoc2: np.ndarray  # (1/k)/(c²/√vg)
    om3gmkm: np.ndarray       # ω³/(g·k)
    delkcc: np.ndarray        # centred Δk/(c²/√vg)
    delkcc_ns: np.ndarray     # one-sided Δk/(c²/√vg) for the cut-off bin
    delkcc_omxkm3: np.ndarray


def build_gc_tables() -> GCTables:
    nwav = int(round(math.log(XKL_GC / XKS_GC) / math.log(KRATIO_GC)))
    i = np.arange(nwav, dtype=np.float64)
    xk = XKS_GC * KRATIO_GC**i
    xkm = 1.0 / xk
    omega = _fomeg(xk)
    vg = 0.5 / omega * (c.G + 3.0 * c.SURFT * xk**2)
    cph = omega / xk
    c2osqrtvg = cph**2 / np.sqrt(vg)
    delkcc = np.empty(nwav)
    delkcc_ns = np.empty(nwav)
    delkcc[0] = 0.5 * (xk[1] - xk[0]) / c2osqrtvg[0]
    delkcc_ns[0] = delkcc[0]
    delkcc[1:-1] = 0.5 * (xk[2:] - xk[:-2]) / c2osqrtvg[1:-1]
    delkcc_ns[1:-1] = 0.5 * (xk[2:] - xk[1:-1]) / c2osqrtvg[1:-1]
    delkcc[-1] = 0.5 * (xk[-1] - xk[-2]) / c2osqrtvg[-1]
    delkcc_ns[-1] = delkcc[-1]
    omxkm3 = omega * xkm**3
    return GCTables(
        nwav=nwav, xk=xk, xkm=xkm, omega=omega, omxkm3=omxkm3, vg=vg,
        cm=1.0 / cph, c2osqrtvg=c2osqrtvg,
        xkmsqrtvgoc2=xkm / c2osqrtvg, om3gmkm=omega**3 / (c.G * xk),
        delkcc=delkcc, delkcc_ns=delkcc_ns,
        delkcc_omxkm3=delkcc * omxkm3)


@functools.cache
def gc_tables() -> GCTables:
    """The tables, built once."""
    return build_gc_tables()


def _ns_argument(ustar, gct: GCTables):
    xks = c.SQRTGOSURFT / (1.48 + 2.05 * ustar)
    return torch.log(torch.clamp(xks * gct.xkm[0], min=1.0)) * XLOGKRATIOM1_GC


def ns_gc(ustar, gct: GCTables):
    """0-based index of the u*-dependent gc cut-off (ns_gc.F90:21-23)."""
    # Fortran NS = MIN(INT(...)+1, NWAV-1), 1-based: MIN(INT, NWAV-2) 0-based
    ns0 = torch.floor(_ns_argument(ustar, gct)).to(torch.int64)
    return torch.clamp(ns0, max=gct.nwav - 2)


def ns_gc_tie(ustar, gct: GCTables):
    """Distance of NS_GC's floor argument from the nearest integer, or 1
    where the index is clamped at NWAV-2 (no step can happen there)."""
    arg = _ns_argument(ustar, gct)
    tie = (arg - torch.round(arg)).abs()
    return torch.where(arg < gct.nwav - 2, tie, torch.ones_like(tie))


def omegagc(ustar, gct: GCTables):
    """Cut-off index, wavenumber and angular frequency (omegagc.F90:28-33)."""
    ns = ns_gc(ustar, gct)
    return ns, const(gct.xk, ustar)[ns], const(gct.omega, ustar)[ns]


def stress_gc(ang_gc, ustar, z0, z0min, halp, rnfac,
              gct: GCTables, params: pp.PhysParams):
    """Gravity-capillary wave-supported stress (stress_gc.F90:63-103).

    All inputs are (npts,).  The reference's scalar loop over wavenumbers
    NS..NWAV becomes a masked sum over the static gc axis.
    """
    xlama, xlamb, nlam = 0.25, 4.0, 4

    ns = ns_gc(ustar, gct)                                    # (npts,)
    xk = const(gct.xk, ustar)[None, :]                        # (1, nwav)
    cm = const(gct.cm, ustar)[None, :]
    om3gmkm = const(gct.om3gmkm, ustar)[None, :]
    xkmsqrtvgoc2 = const(gct.xkmsqrtvgoc2, ustar)[None, :]
    delkcc_omxkm3 = const(gct.delkcc_omxkm3, ustar)[None, :]
    dns_omxkm3 = const(gct.delkcc_ns * gct.omxkm3, ustar)
    c2osqrtvg_ns = const(gct.c2osqrtvg, ustar)[ns]

    tauwcg_min = (ustar * (z0min / z0))**2
    xlambda = 1.0 + xlama * torch.tanh(xlamb * ustar**nlam)
    zabhrc = ang_gc * params.betamaxoxkappa2 * halp * c2osqrtvg_ns

    if params.llnormagam:
        const_n = (rnfac * params.bmaxokap * halp * c2osqrtvg_ns
                   / torch.clamp(ustar, min=c.EPSUS))
    else:
        const_n = torch.zeros_like(ustar)

    x = ustar[:, None] * cm
    # log(xk·z0) = log(xk) + log(z0), as the reference writes it
    xlog = (torch.log(xk) + torch.log(z0)[:, None]
            + pp.XKAPPA / (x + params.zalp))
    zlog = torch.clamp(xlog - torch.log(xlambda)[:, None], max=0.0)
    zlog2x = zlog * zlog * x
    gam_w = zlog2x * zlog2x * torch.exp(xlog) * om3gmkm       # (npts, nwav)
    zn = const_n[:, None] * xkmsqrtvgoc2 * gam_w
    gamnorma = (1.0 + params.rn1_rn * zn) / (1.0 + zn)

    iwav = torch.arange(gct.nwav, device=ustar.device)[None, :]
    g = gam_w * gamnorma
    tail = torch.sum(torch.where(iwav > ns[:, None], g * delkcc_omxkm3,
                                 torch.zeros_like(g)), dim=1)
    g_ns = torch.gather(g, 1, ns[:, None])[:, 0]
    tauwcg = g_ns * dns_omxkm3[ns] + tail
    return torch.maximum(zabhrc * tauwcg, tauwcg_min)


def meansqs_lf(nfre_eff: int, fl1, wavnum, tb):
    """Mean square slope of the resolved spectrum below bin ``nfre_eff``
    (meansqs_lf.F90:38-56).  fl1: (nang, nfre, npts), wavnum: (nfre, npts)."""
    f1d = torch.sum(fl1[:, :nfre_eff], dim=0)                # (nfre_eff, npts)
    w = const(tb.dfim[:nfre_eff], fl1)[:, None] * wavnum[:nfre_eff]**2
    return torch.sum(w * f1d, dim=0)


def halphap(fl1, wavnum, coswdif, tb, params: pp.PhysParams):
    """Half the Phillips parameter (halphap.F90:54-99).

    fl1: (nang, nfre, npts), wavnum: (nfre, npts), coswdif: (nang, npts).
    """
    wd = 0.5 + 0.5 * torch.sign(coswdif)                      # (nang, npts)
    flwd = fl1 * wd[:, None, :]
    xmss = meansqs_lf(tb.nfre, flwd, wavnum, tb)
    em, fm = means_mod.femean(flwd, tb)
    f1d_last = torch.sum(flwd[:, -1, :], dim=0) * float(tb.delth)
    alphap_tail = float(c.ZPI4GM2 * tb.fr[-1]**5) * f1d_last  # reference literal
    ok = (em > 0.0) & (fm < tb.fr[tb.nfre - 3])
    alphap_spec = xmss / torch.clamp(
        math.log(tb.fr[-1]) - torch.log(torch.clamp(fm, min=c.EPSMIN)),
        min=c.EPSMIN)
    alphap = torch.where(ok & (alphap_spec <= params.alphapmax),
                         alphap_spec, alphap_tail)
    return 0.5 * torch.clamp(alphap, max=params.alphapmax)


def meansqs_gc(xkmss: float, halp, ustar, gct: GCTables):
    """Gravity-capillary mean-square-slope contribution
    (meansqs_gc.F90:56-78).  Returns (xmsscg, frgc)."""
    ne = min(max(
        int(round(math.log(xkmss * gct.xkm[0]) * XLOGKRATIOM1_GC)), 1),
        gct.nwav) - 1                                          # 0-based
    ns, xks, oms = omegagc(ustar, gct)
    frgc = oms / float(c.ZPI)
    dns_xkm = const(gct.delkcc_ns * gct.xkm, ustar)
    dcc_xkm = const(gct.delkcc * gct.xkm, ustar)[None, :]
    c2osqrtvg = const(gct.c2osqrtvg, ustar)

    # where the spectral cut-off exceeds the msqs cut-off, integrate nothing
    over = xks > xkmss
    ns_eff = torch.where(over, torch.full_like(ns, ne), ns)
    base = torch.where(over, torch.zeros_like(ustar), dns_xkm[ns_eff])
    iwav = torch.arange(gct.nwav, device=ustar.device)[None, :]
    mask = (iwav > ns_eff[:, None]) & (iwav <= ne)
    xmss = base + torch.sum(torch.where(mask, dcc_xkm,
                                        torch.zeros_like(dcc_xkm)), dim=1)
    return xmss * c2osqrtvg[ns_eff] * halp, frgc


def meansqs(xkmss: float, fl1, wavnum, ustar, coswdif, tb,
            params: pp.PhysParams, gct: GCTables | None = None):
    """Total mean square slope up to wavenumber ``xkmss`` (meansqs.F90:75-97)."""
    if gct is None:
        gct = gc_tables()
    halp = halphap(fl1, wavnum, coswdif, tb, params)
    xmss, frgc = meansqs_gc(xkmss, halp, ustar, gct)
    fcut = math.sqrt(c.G * xkmss) / c.ZPI
    nfre_mss = int(math.log(fcut / tb.fr[0]) / math.log(tb.fratio)) + 1
    nfre_eff = min(tb.nfre, nfre_mss)
    xmss = xmss + meansqs_lf(nfre_eff, fl1, wavnum, tb)
    xlogfs = math.log(tb.fr[nfre_eff - 1])
    tail = 2.0 * halp * torch.clamp(
        torch.log(torch.clamp(frgc, max=fcut)) - xlogfs, min=0.0)
    return xmss + tail
