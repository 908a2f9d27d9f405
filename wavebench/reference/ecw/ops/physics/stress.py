"""Wave-supported stress: prognostic-range cut, tail stress, total wave stress.

Port of ``ecwam_tpu/ops/physics/stress.py``: FRCUTINDEX
(frcutindex.F90:64-108), TAU_PHI_HF (tau_phi_hf.F90:73-255, with the
LLGCBZ0 cut-off and the LLNORMAGAM normalisation) and STRESSO
(stresso.F90:63-160).

Layout: fl1 (nang, nfre, npts); mij is the 0-based cut index (npts,) int64.
"""

from __future__ import annotations

import torch

from wavebench.reference.ecw.core import constants as c
from wavebench.reference.ecw.core import physparams as pp
from wavebench.reference.ecw.core import spectral as sp
from wavebench.reference.ecw.ops.physics import tables
from wavebench.reference.ecw.ops.physics import const
from wavebench.reference.ecw.ops.physics import gc as gc_mod
from wavebench.reference.ecw.ops.physics.airsea import EPS1

CITHRSH_TAIL = 0.3        # LMASKICE=T default (userin.F90:958-961)


def frcut_argument(fm, fmws, ufric, tb, params: pp.PhysParams):
    """LOG10(FPM4)·FLOGSPRDM1, the value FRCUTINDEX rounds to the cut
    (frcutindex.F90:90-100).  Near a half-integer the cut, and with it
    the stress, jumps by one frequency on a last-bit change of the
    inputs."""
    fpmh = params.tailfactor / tb.fr[0]
    fppm = params.tailfactor_pm * c.G / (sp.FRIC * tb.zpifr[0])
    fm2 = torch.maximum(fmws, fm) * fpmh
    fpm = fppm / torch.clamp(ufric, min=c.EPSMIN)
    return torch.log10(torch.maximum(fm2, fpm)) * tb.flogsprdm1


def frcutindex(fm, fmws, ufric, cicover, tb, params: pp.PhysParams,
               *, cithrsh_tail: float = CITHRSH_TAIL):
    """Last prognostic frequency index (0-based) and RHOWGDFTH weights
    (frcutindex.F90:64-108).

    Returns (mij, rhowgdfth) with mij int64 (npts,) and rhowgdfth
    (nfre, npts).
    """
    nfre = tb.nfre
    # Fortran: MIJ = NINT(LOG10(FPM4)*FLOGSPRDM1)+1, clipped to [1, NFRE]
    mij1 = torch.round(frcut_argument(fm, fmws, ufric, tb, params)
                       ).to(torch.int64) + 1
    mij1 = torch.clamp(mij1, 1, nfre)
    mij1 = torch.where(cicover <= cithrsh_tail, mij1,
                       torch.full_like(mij1, nfre))
    mij = mij1 - 1                               # 0-based

    m_idx = torch.arange(nfre, device=fm.device)[:, None]
    rhowg = const(tb.rhowg_dfim, fm)[:, None]
    w = torch.where(m_idx <= mij[None, :], rhowg, torch.zeros_like(rhowg))
    # halve at the cut itself unless the cut is the last frequency
    half = (m_idx == mij[None, :]) & (mij[None, :] != nfre - 1)
    return mij, torch.where(half, 0.5 * w, w)


def tau_phi_hf(mij, ufric, z0m, fl1, aird, rnfac, coswdif, sinwdif2,
               ust, tb, params: pp.PhysParams,
               *, x0tauhf: float, wtauhf, ltauwshelter: bool,
               llphiwa: bool = True):
    """High-frequency stress TAUHF and energy flux PHIHF
    (tau_phi_hf.F90:73-255).  Under LLGCBZ0 the TAUHF integral stops at
    the gravity-capillary cut-off (zsup = log(ω_gc·√(z0/g)), at most 0);
    PHIHF always integrates up to log 1 = 0.

    ``ust`` is the (possibly sheltered) friction velocity input; returns
    (tauhf, phihf, ust_out) where ust_out is the tail-sheltered u*.
    """
    jtot = tables.JTOT_TAUHF
    wtauhf = [float(w) for w in wtauhf]
    x0g = x0tauhf * c.G

    fr5_mij = const(tb.fr5, fl1)[mij]                # (npts,)
    zpifr_mij = const(tb.zpifr, fl1)[mij]

    xloggz0 = torch.log(c.G * z0m)
    omegacc = torch.maximum(zpifr_mij, x0g / ust)
    sqrtz0og = torch.sqrt(z0m * c.GM1)
    sqrtgz0 = 1.0 / sqrtz0og
    zinf = torch.log(omegacc * sqrtz0og)
    if params.llgcbz0:
        # TAUHF stops at the gravity-capillary cut-off
        # (tau_phi_hf.F90:125-127, 190-193)
        _, _, oms = gc_mod.omegagc(ufric, gc_mod.gc_tables())
        zsup = torch.clamp(torch.log(oms * sqrtz0og), max=0.0)
    else:
        zsup = torch.zeros_like(zinf)                  # log(1)
    consttau = c.ZPI4GM2 * fr5_mij

    # direction sums at the cut frequency (tau_phi_hf.F90:97-125)
    fl1_mij = torch.gather(
        fl1, 1, mij[None, None, :].expand(fl1.shape[0], 1, -1))[:, 0, :]
    cosw = torch.clamp(coswdif, min=0.0)
    fcosw2 = fl1_mij * cosw**2
    f1dcos3 = tb.delth * torch.sum(fcosw2 * cosw, dim=0)
    f1dcos2 = tb.delth * torch.sum(fcosw2, dim=0)

    if params.llnormagam:
        f1dsin2 = tb.delth * torch.sum(fl1_mij * sinwdif2, dim=0)
        f1d = tb.delth * torch.sum(fl1_mij, dim=0)
        confg = params.gamnconst() * fr5_mij * rnfac * sqrtgz0
        const1 = confg * f1dsin2
        const2 = confg * f1d
    else:
        const1 = const2 = torch.zeros_like(ust)

    delz = torch.clamp((zsup - zinf) / (jtot - 1), min=0.0)
    delz_phi = torch.clamp((0.0 - zinf) / (jtot - 1), min=0.0)

    def zbeta_at(j, u, dz):
        y = torch.exp(zinf + j * dz)
        omega = y * sqrtgz0
        cm1 = omega * c.GM1
        zx = u * cm1 + params.zalp
        zlog = torch.clamp(xloggz0 + 2.0 * torch.log(cm1) + pp.XKAPPA / zx,
                           max=0.0)
        return zlog**4 * torch.exp(zlog), y

    def gamnorma(zbeta, u, y):
        znz = zbeta * u * y
        return (1.0 + const1 * znz) / (1.0 + const2 * znz)

    taul0 = ust**2
    if ltauwshelter:
        taul, ust_out, tauhf = taul0, ust, torch.zeros_like(ust)
        for j in range(jtot):
            zbeta, y = zbeta_at(j, ust_out, delz)
            fnc2 = (f1dcos3 * consttau * zbeta * taul * wtauhf[j] * delz
                    * gamnorma(zbeta, ust_out, y))
            taul = torch.clamp(taul - params.tauwshelter * fnc2, min=0.0)
            ust_out = torch.sqrt(taul)
            tauhf = tauhf + fnc2
    else:
        acc = torch.zeros_like(ust)
        for j in range(jtot):
            zbeta, y = zbeta_at(j, ust, delz)
            acc = acc + zbeta * wtauhf[j] * gamnorma(zbeta, ust, y)
        tauhf = f1dcos3 * consttau * taul0 * acc * delz
        ust_out = ust

    phihf = torch.zeros_like(ust)
    if llphiwa:
        constphi = aird * c.ZPI4GM1 * fr5_mij
        # fresh integration from the unsheltered ust
        acc = torch.zeros_like(ust)
        if ltauwshelter:
            taul, ustph = ust**2, ust
            for j in range(jtot):
                zbeta, y = zbeta_at(j, ustph, delz_phi)
                fnc2 = (zbeta * taul * wtauhf[j] * delz_phi
                        * gamnorma(zbeta, ust_out, y))
                taul = torch.clamp(
                    taul - params.tauwshelter * f1dcos3 * consttau * fnc2,
                    min=0.0)
                ustph = torch.sqrt(taul)
                acc = acc + fnc2 / y
            phihf = f1dcos2 * constphi * sqrtz0og * acc
        else:
            for j in range(jtot):
                zbeta, y = zbeta_at(j, ust, delz_phi)
                acc = acc + zbeta * wtauhf[j] * gamnorma(zbeta, ust, y) / y
            phihf = f1dcos2 * constphi * sqrtz0og * ust**2 * acc * delz_phi
    return tauhf, phihf, ust_out


def stresso(fl1, sl, spos, cinv, mij, rhowgdfth,
            wdwave, ufric, z0m, aird, rnfac, coswdif, sinwdif2,
            tb, params: pp.PhysParams,
            *, x0tauhf: float, wtauhf, llphiwa: bool = True):
    """Wave stress τ_w from the positive input + high-frequency tail
    (stresso.F90:63-160).

    Returns (tauw, tauwdir, phiwa).
    """
    sinth = const(tb.sinth, fl1)[:, None, None]
    costh = const(tb.costh, fl1)[:, None, None]
    rhowg_dfim = const(tb.rhowg_dfim, fl1)[:, None]

    phiwa = torch.zeros_like(ufric)
    if llphiwa:
        # negative part over the full spectrum (stresso.F90:71-78)
        phiwa = torch.sum((sl - spos) * rhowg_dfim[None, :, :], dim=(0, 1))

    sumx = torch.sum(spos * sinth, dim=0)            # (nfre, npts)
    sumy = torch.sum(spos * costh, dim=0)
    cm_w = rhowgdfth * cinv
    xstress = torch.sum(cm_w * sumx, dim=0)
    ystress = torch.sum(cm_w * sumy, dim=0)
    if llphiwa:
        phiwa = phiwa + torch.sum(rhowgdfth * torch.sum(spos, dim=0), dim=0)

    aird_floor = torch.clamp(aird, min=1.0)
    xstress = xstress / aird_floor
    ystress = ystress / aird_floor

    # tail contribution start point (stresso.F90:116-135)
    ltauwshelter = not (params.iphys == 0 or params.tauwshelter == 0.0)
    if ltauwshelter:
        taupx = ufric**2 * torch.sin(wdwave) - params.tauwshelter * xstress
        taupy = ufric**2 * torch.cos(wdwave) - params.tauwshelter * ystress
        usdirp = torch.atan2(taupx, taupy)
        ust = (taupx**2 + taupy**2) ** 0.25
    else:
        usdirp = wdwave
        ust = ufric

    tauhf, phihf, _ = tau_phi_hf(
        mij, ufric, z0m, fl1, aird, rnfac, coswdif, sinwdif2, ust,
        tb, params, x0tauhf=x0tauhf, wtauhf=wtauhf,
        ltauwshelter=ltauwshelter, llphiwa=llphiwa)

    xstress = xstress + tauhf * torch.sin(usdirp)
    ystress = ystress + tauhf * torch.cos(usdirp)
    tauw = torch.sqrt(xstress**2 + ystress**2)
    tauwdir = torch.atan2(xstress, ystress)
    if not params.llgcbz0:
        tauw = torch.minimum(tauw, ufric**2 / (1.0 + EPS1))
    if llphiwa:
        phiwa = phiwa + phihf
    return tauw, tauwdir, phiwa
