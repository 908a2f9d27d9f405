"""Wind-input source term S_in.

Port of ``ecwam_tpu/ops/physics/sinput.py``:
  - ``sinput_ard`` (Ardhuin et al. 2010, sinput_ard.F90:88-434): positive
    input with gustiness averaging, tail-stress sheltering carried
    low→high frequency by a sequential frequency loop, the LLNORMAGAM
    growth normalisation, and the negative (swell damping) part;
  - ``sinput_jan`` (Janssen's quasi-linear input of WAM cycle 4, iphys=0,
    sinput_jan.F90:84-280): frequency-parallel, two gusts, the LLNORMAGAM
    normalisation and the negative part.

Layout: fl1 (nang, nfre, npts); per-frequency env (nfre, npts); scalars
(npts,).  Both return (fld, sl, spos, xllws, margin) with fld = ∂S/∂F
diagonal, sl = S_in, spos = positive part only, xllws = windsea mask, and
margin the mask test's distance from its edge: over the gusts, the
largest min(cos − 0.01, −zlog), so that xllws = (margin > 0).  Where
|margin| is tiny a last-bit change of the inputs may flip a mask bin.
"""

from __future__ import annotations

import torch

from wavebench.reference.ecw.core import constants as c
from wavebench.reference.ecw.core import physparams as pp
from wavebench.reference.ecw.ops.physics import tables
from wavebench.reference.ecw.ops.physics import const
from wavebench.reference.ecw.ops.physics.airsea import wsigstar

IDAMPING = 1              # mpuserin.F90:609


def _swellft_interp(zorb):
    """Linear interpolation in the swell friction table
    (sinput_ard.F90:187-194)."""
    table = const(tables.tabu_swellft(), zorb)
    delabm1 = tables.IAB / (tables.ABMAX - tables.ABMIN)
    xi = (torch.log10(torch.clamp(zorb, min=3.0)) - tables.ABMIN) * delabm1
    ind = torch.clamp(xi.to(torch.int64), max=tables.IAB - 1)  # Fortran IND
    deli1 = torch.clamp(xi - ind.to(zorb.dtype), max=1.0)
    deli2 = 1.0 - deli1
    # Fortran SWELLFT(IND) is table[ind-1] (the table drops the unused 0 slot)
    return table[ind - 1] * deli2 + table[ind] * deli1


def sinput_ard(fl1, wavnum, cinv, xk2cg,
               wdwave, wswave, ufric, z0m,
               coswdif, sinwdif2, raorw, wstar, rnfac,
               tb, params: pp.PhysParams,
               *, ngst: int = 2, llsneg: bool = True):
    """Ardhuin wind input (sinput_ard.F90:88-434)."""
    nang, nfre, npts = fl1.shape
    sinth = const(tb.sinth, fl1)[:, None]
    costh = const(tb.costh, fl1)[:, None]
    dfim = const(tb.dfim, fl1)
    zpifr = const(tb.zpifr, fl1)

    avg_gst = 1.0 / ngst
    const1 = params.betamaxoxkappa2
    constn = tb.delth / (pp.XKAPPA * c.ZPI)
    cstrnfac = constn * rnfac / raorw if params.llnormagam else None
    abs_tauwshelter = abs(params.tauwshelter)
    ltauwshelter = abs_tauwshelter != 0.0

    if ngst > 1:
        sig_n = wsigstar(wswave, ufric, z0m, wstar, params)
        ustp0 = torch.stack([ufric * (1.0 + sig_n), ufric * (1.0 - sig_n)])
    else:
        ustp0 = ufric[None, :]

    # ---- negative-input (swell damping) precompute (sinput_ard.F90:122-205)
    if llsneg:
        nu_air = pp.RNU
        fu = abs(pp.SWELLF3)
        fud = pp.SWELLF2
        e1d = torch.sum(fl1, dim=0)                   # (nfre, npts)
        uorbt = 2.0 * torch.sqrt(
            c.EPSMIN + torch.sum((dfim * zpifr**2)[:, None] * e1d, dim=0))
        aorb = 2.0 * torch.sqrt(
            c.EPSMIN + torch.sum(dfim[:, None] * e1d, dim=0))
        re = (4.0 / nu_air) * uorbt * aorb
        z0vis = pp.RNUM / torch.clamp(ufric, min=1.0e-4)
        z0tub = params.z0rat * torch.clamp(z0m, max=params.z0tubmax)
        z0noz = torch.maximum(z0vis, z0tub)
        zorb = aorb / z0noz
        fww = _swellft_interp(zorb)
        temp2 = fww * uorbt
        if pp.SWELLF6 == 1.0:
            re_c = torch.full_like(re, params.swellf4)
        else:
            re_c = params.swellf4 * (2.0 / aorb) ** (1.0 - pp.SWELLF6)
        if params.swellf7 > 0.0:
            smooth = 0.5 * torch.tanh((re - re_c) * params.swellf7m1)
            pturb, pvisc = 0.5 + smooth, 0.5 - smooth
        else:
            pturb = torch.where(re <= re_c, 0.0, 0.5).to(fl1.dtype)
            pvisc = torch.where(re <= re_c, 0.5, 0.0).to(fl1.dtype)
        aird_pvisc = pvisc * raorw

    if ltauwshelter:
        usg2 = ustp0**2
        taux = usg2 * torch.sin(wdwave)[None, :]
        tauy = usg2 * torch.cos(wdwave)[None, :]
        rogoroair = c.G / raorw

    # hoisted per-frequency rows
    zcn_all = torch.log(wavnum * z0m[None, :])       # (nfre, npts)
    cnsn_all = (zpifr * const1)[:, None] * raorw[None, :]
    if llsneg:
        coef_v = -pp.SWELLF * 16.0 * zpifr**2 / c.G
        coef5_v = -pp.SWELLF5 * 2.0 * torch.sqrt(2.0 * nu_air * zpifr)
        dstab1_all = coef5_v[:, None] * aird_pvisc[None, :] * wavnum
        temp1_all = coef_v[:, None] * raorw[None, :]

    xstress = [torch.zeros_like(ufric) for _ in range(ngst)]
    ystress = [torch.zeros_like(ufric) for _ in range(ngst)]
    fld = torch.empty_like(fl1)
    sl = torch.empty_like(fl1)
    spos = torch.empty_like(fl1)
    xllws = torch.empty_like(fl1)
    margin = torch.empty_like(fl1)
    for m in range(nfre):
        fl1_m = fl1[:, m, :]                          # (nang, npts)
        zcn = zcn_all[m]
        cnsn = cnsn_all[m]
        if llsneg:
            dstab1 = dstab1_all[m]
            temp1 = temp1_all[m]
        xllws_m = torch.zeros_like(fl1_m)
        margin_m = torch.full_like(fl1_m, -torch.inf)
        spos_sum = torch.zeros_like(fl1_m)
        fld_sum = torch.zeros_like(fl1_m)
        for igst in range(ngst):
            if ltauwshelter:
                tx = taux[igst] - abs_tauwshelter * xstress[igst]
                ty = tauy[igst] - abs_tauwshelter * ystress[igst]
                ustp = (tx**2 + ty**2) ** 0.25
                constf = rogoroair * cinv[m] * dfim[m]
            else:
                ustp = ustp0[igst]
            um1 = 1.0 / torch.clamp(ustp, min=c.EPSUS)
            ucn = ustp * cinv[m]
            ucnzalpd = pp.XKAPPA / (ucn + params.zalp)
            if ltauwshelter:
                # cos(θ − usdirp) for usdirp = atan2(tx, ty), by the
                # identity (sinθ·τx + cosθ·τy)/|τ|; atan2(0,0)=0 → cosθ
                coslp = torch.where(
                    (tx**2 + ty**2)[None, :] > 0.0,
                    (sinth * tx[None, :] + costh * ty[None, :])
                    * (um1**2)[None, :],
                    costh)
            else:
                coslp = coswdif
            # growth rate (sinput_ard.F90:337-351)
            x = coslp * ucn[None, :]
            zlog = zcn[None, :] + ucnzalpd[None, :] / torch.where(
                coslp > 0.01, coslp, torch.ones_like(coslp))
            active = (coslp > 0.01) & (zlog < 0.0)
            zlog2x = zlog * zlog * x
            gam0 = torch.where(
                active, torch.exp(zlog) * zlog2x * zlog2x * cnsn[None, :],
                torch.zeros_like(zlog))
            xllws_m = torch.maximum(xllws_m, active.to(fl1.dtype))
            margin_m = torch.maximum(margin_m,
                                     torch.minimum(coslp - 0.01, -zlog))
            if params.llnormagam:
                # normalised growth (sinput_ard.F90:352-366)
                sumf = torch.sum(gam0 * fl1_m, dim=0)
                sumfsin2 = torch.sum(gam0 * fl1_m * sinwdif2, dim=0)
                znz = cstrnfac * xk2cg[m] * um1
                gam0 = gam0 * ((1.0 + znz * sumfsin2)
                               / (1.0 + znz * sumf))[None, :]

            if llsneg:
                dstab2 = temp1[None, :] * (
                    temp2[None, :] + (fu + fud * coslp) * ustp[None, :])
                dstab = dstab1[None, :] + pturb[None, :] * dstab2
            else:
                dstab = torch.zeros_like(fl1_m)

            flp = gam0 + dstab
            slp = gam0 * fl1_m
            if ltauwshelter:
                xstress[igst] = xstress[igst] + torch.sum(
                    slp * sinth, dim=0) * constf
                ystress[igst] = ystress[igst] + torch.sum(
                    slp * costh, dim=0) * constf
            spos_sum = spos_sum + slp
            fld_sum = fld_sum + flp

        spos[:, m] = avg_gst * spos_sum
        fld[:, m] = avg_gst * fld_sum
        sl[:, m] = fld[:, m] * fl1_m
        xllws[:, m] = xllws_m
        margin[:, m] = margin_m
    return fld, sl, spos, xllws, margin


def sinput_jan(fl1, wavnum, cinv, xk2cg,
               wdwave, wswave, ufric, z0m,
               coswdif, sinwdif2, raorw, wstar, rnfac,
               tb, params: pp.PhysParams,
               *, ngst: int = 2, llsneg: bool = True):
    """Janssen quasi-linear wind input (sinput_jan.F90:84-280).

    The windsea mask is ``coswdif > 0.01 & zlog < 0`` in either gust;
    ``margin`` is its distance from the edge as in :func:`sinput_ard`."""
    zpifr = const(tb.zpifr, fl1)[:, None]           # (nfre, 1)
    const1 = params.betamaxoxkappa2
    const3 = IDAMPING * 2.0 * pp.XKAPPA / const1
    constn = tb.delth / (pp.XKAPPA * c.ZPI)
    xkappad = 1.0 / pp.XKAPPA

    lz = coswdif > 0.01                              # (nang, npts)
    if ngst > 1:
        sig_n = wsigstar(wswave, ufric, z0m, wstar, params)
        sigdev = torch.stack([1.0 - sig_n, 1.0 + sig_n])
        wsin = (0.5, 0.5)
    else:
        sigdev = torch.ones_like(ufric)[None, :]
        wsin = (1.0,)
    us = ufric[None, :] * sigdev                     # (ngst, npts)
    ustpm1 = 1.0 / torch.clamp(us, min=c.EPSUS)

    ztanhkd = zpifr**2 / (c.G * wavnum)              # (nfre, npts)
    cnsn = zpifr * const1 * ztanhkd * raorw[None, :]
    cstrnfac = constn * rnfac / raorw if params.llnormagam else None
    zcn = torch.log(wavnum * z0m[None, :])
    cosw = torch.where(lz, coswdif, torch.ones_like(coswdif))[:, None, :]

    ufac1 = torch.zeros_like(fl1)
    ufac2 = torch.zeros_like(fl1)
    xllws = torch.zeros_like(fl1)
    margin = torch.full_like(fl1, -torch.inf)
    for igst in range(len(wsin)):
        us_g = us[igst]
        ucn = us_g[None, :] * cinv + params.zalp     # (nfre, npts)
        const3_ucn2 = const3 * ucn**2
        ucnd = 1.0 / ucn
        xvd = 1.0 / (-us_g[None, :] * xkappad * zcn * cinv)

        zlog = zcn[None, :, :] + pp.XKAPPA / cosw * ucnd[None, :, :]
        active = lz[:, None, :] & (zlog < 0.0)
        x = coswdif[:, None, :] * ucn[None, :, :]
        zlog2x = zlog * zlog * x
        gam0 = torch.where(
            active, zlog2x * zlog2x * torch.exp(zlog) * cnsn[None, :, :],
            torch.zeros_like(zlog))
        xllws = torch.maximum(xllws, active.to(fl1.dtype))
        margin = torch.maximum(margin, torch.minimum(
            (coswdif - 0.01)[:, None, :], -zlog))

        if params.llnormagam:
            sumf = torch.sum(gam0 * fl1, dim=0)      # (nfre, npts)
            sumfsin2 = torch.sum(gam0 * fl1 * sinwdif2[:, None, :], dim=0)
            znz = (cstrnfac[None, :] * xk2cg) * ustpm1[igst][None, :]
            gam0 = gam0 * ((1.0 + znz * sumfsin2)
                           / (1.0 + znz * sumf))[None, :, :]

        ufac1 = ufac1 + wsin[igst] * gam0
        if llsneg:
            zbeta = const3_ucn2[None, :, :] * (
                coswdif[:, None, :] - xvd[None, :, :])
            ufac2 = ufac2 + wsin[igst] * zbeta

    fld = ufac1 + ufac2 * cnsn[None, :, :]
    return fld, fld * fl1, ufac1 * fl1, xllws, margin
