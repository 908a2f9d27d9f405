"""Sea-ice wave attenuation (the SDICE dispatcher and its three models).

Port of ``ecwam_tpu/ops/physics/sdice.py``: the common SL/FLD update
(sdice1.F90:125-140 and twins), SDICE1's scattering model with the
tabulated deactivation rates CIDEAC (sdice1.F90:60-140; the table,
built by cigetdeac.F90:60-560, is the package's copy
``data/cideac.npz``), SDICE2's ice-water drag (sdice2.F90:45-70),
SDICE3's empirical h^1.25·f^4.5 model (sdice3.F90:55-95, IMODEL=2, the
cy50r1 LCIWA3 default) and the dispatcher.

All take fl1/fld/sl (nang, nfre, npts) and return (fld, sl, slice_) with
``slice_`` the implicit-factor-modulated pure-ice term.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from wavebench.reference.ecw.core import constants as c
from wavebench.reference.ecw.ops.physics import const

XIMP = 1.0
CDICE = 0.1274 * (c.ZPI / np.sqrt(c.G)) ** 4.5     # sdice3.F90 IMODEL=2
CDICWA = 0.01           # ice-water drag for LCIWA2 (userin.F90:973-975)
ZALPFACB = 1.0          # attenuation scale factor (mpuserin.F90:780)
# SDICE1's floe-size distribution (sdice1.F90:65-100): the fragility, the
# smallest floe diameter (m), the fragmentation factor, and the largest
# diameter A + C·cicover (m)
CIFRGL, CIDMIN, CIFRGMT = 0.955, 20.0, 2.0
CIDMAX_A, CIDMAX_C = 200.0, 300.0
MAXICM = int(np.log(CIDMAX_A / CIDMIN) / np.log(CIFRGMT))

_DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "data", "cideac.npz")


def load_cideac() -> dict:
    """The CIDEAC table (nict periods × nich thicknesses) and its axes."""
    with np.load(_DATA) as z:
        return dict(cideac=z["cideac"], ticmin=float(z["ticmin"]),
                    dtic=float(z["dtic"]), nict=int(z["nict"]),
                    hicmin=float(z["hicmin"]), dhic=float(z["dhic"]),
                    nich=int(z["nich"]))


def _apply(fl1, fld, sl, alp, cgroup, cicover, idelt):
    """Common SL/FLD/SLICE update (sdice1.F90:125-140 and twins)."""
    delt5 = XIMP * idelt
    fldice = -alp * cgroup[None]                 # (nang, nfre, npts) via bc
    slice_ = fl1 * fldice
    sl = sl + cicover[None, None, :] * slice_
    fld = fld + cicover[None, None, :] * fldice
    gtemp1 = torch.clamp(1.0 - delt5 * fldice, min=1.0)
    return fld, sl, slice_ / gtemp1


def floe_dinv(cicover, cithick):
    """1/D, the inverse mean floe diameter of SDICE1 (sdice1.F90:65-100):
    the ratio of MAXICM+1 geometric sums cut at ICM."""
    cidmax = CIDMAX_A + CIDMAX_C * cicover
    icm = torch.clamp(torch.floor(torch.log(cidmax / CIDMIN)
                                  / np.log(CIFRGMT)), max=MAXICM)
    i = torch.arange(MAXICM + 1, dtype=cicover.dtype,
                     device=cicover.device)[:, None]
    active = i <= icm[None, :]
    x = (CIFRGMT**2 * CIFRGL) ** i
    zero = torch.zeros((), dtype=cicover.dtype, device=cicover.device)
    sn = torch.sum(torch.where(active, x * cidmax[None] / CIFRGMT**i, zero),
                   dim=0)
    sd = torch.sum(torch.where(active, x, zero), dim=0)
    return torch.where(cithick > 0.0, sd / sn, torch.full_like(sd, CIDMIN))


def sdice1(fl1, fld, sl, wavnum, cgroup, cicover, cithick, tb, idelt,
           tables=None):
    """Scattering attenuation from tabulated deactivation rates
    (sdice1.F90:60-140): a bilinear lookup in (period, thickness)."""
    tbl = tables or load_cideac()
    cideac = const(tbl["cideac"], fl1)           # (nict, nich)
    nict, nich = tbl["nict"], tbl["nich"]
    dinv = floe_dinv(cicover, cithick)

    tw = 1.0 / const(tb.fr, fl1)                 # (nfre,)
    it = torch.clamp(torch.floor((tw - tbl["ticmin"]) / tbl["dtic"]),
                     0, nict - 1).to(torch.int64)
    it1 = torch.clamp(it + 1, 0, nict - 1)
    wt1 = torch.clamp((tw - (tbl["ticmin"] + it.to(tw.dtype) * tbl["dtic"]))
                      / tbl["dtic"], 0.0, 1.0)
    wt = 1.0 - wt1
    ih = torch.clamp(torch.floor((cithick - tbl["hicmin"]) / tbl["dhic"]),
                     0, nich - 1).to(torch.int64)
    ih1 = torch.clamp(ih + 1, 0, nich - 1)
    wh1 = torch.clamp((cithick - (tbl["hicmin"] + ih.to(tw.dtype)
                                  * tbl["dhic"])) / tbl["dhic"], 0.0, 1.0)
    wh = 1.0 - wh1
    deac = (wt[:, None] * (wh[None] * cideac[it][:, ih]
                           + wh1[None] * cideac[it][:, ih1])
            + wt1[:, None] * (wh[None] * cideac[it1][:, ih]
                              + wh1[None] * cideac[it1][:, ih1]))
    alp = torch.where(cithick[None, :] > 0.0,
                      torch.exp(deac) * dinv[None, :] * ZALPFACB,
                      torch.zeros_like(deac))    # (nfre, npts)
    return _apply(fl1, fld, sl, alp[None], cgroup, cicover, idelt)


def sdice2(fl1, fld, sl, wavnum, cgroup, cicover, tb, idelt,
           cdicwa: float = CDICWA):
    """Turbulent ice-water drag attenuation (sdice2.F90:45-70); α depends
    on each bin's amplitude."""
    dfim = const(tb.dfim, fl1)[None, :, None]
    ewh = 4.0 * torch.sqrt(torch.clamp(fl1 * dfim, min=c.EPSMIN))
    alp = cdicwa * (wavnum**2)[None] * ewh * ZALPFACB
    return _apply(fl1, fld, sl, alp, cgroup, cicover, idelt)


def sdice3(fl1, fld, sl, wavnum, cgroup, cicover, cithick, tb, idelt,
           alpfac=None):
    """Empirical attenuation ~ h^1.25 f^4.5 (sdice3.F90:55-95, IMODEL=2)."""
    fr45 = const(np.asarray(tb.fr) ** 4.5, fl1)
    af = torch.ones_like(cicover) if alpfac is None else alpfac
    alp = (2.0 * CDICE * cithick[None, :] ** 1.25 * fr45[:, None]
           * af[None, :])                                  # (nfre, npts)
    return _apply(fl1, fld, sl, alp[None], cgroup, cicover, idelt)


def sdice(fl1, fld, sl, wavnum, cgroup, cicover, cithick, tb, idelt, *,
          lciwa1=False, lciwa2=False, lciwa3=False, alpfac=None,
          cideac_tables=None):
    """Dispatcher (sdice.F90): the enabled attenuation models in the
    reference's order, each adding to (fld, sl); a later model's
    ``slice_`` replaces an earlier one."""
    slice_ = torch.zeros_like(fl1)
    if lciwa1:
        fld, sl, slice_ = sdice1(fl1, fld, sl, wavnum, cgroup, cicover,
                                 cithick, tb, idelt, tables=cideac_tables)
    if lciwa2:
        fld, sl, slice_ = sdice2(fl1, fld, sl, wavnum, cgroup, cicover,
                                 tb, idelt)
    if lciwa3:
        fld, sl, slice_ = sdice3(fl1, fld, sl, wavnum, cgroup, cicover,
                                 cithick, tb, idelt, alpfac=alpfac)
    return fld, sl, slice_
