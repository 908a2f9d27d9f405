"""Whitecapping dissipation S_ds.

Port of ``ecwam_tpu/ops/physics/sdissip.py``: ``sdissip_ard``, the
saturation-based dissipation of Ardhuin et al. (2010)
(sdissip_ard.F90:70-256; the cumulative-breaking term is compiled out in
the reference, SSDSC3=0, yowphys.F90:140), and ``sdissip_jan``, the WAM
cycle-4 mean-steepness dissipation of iphys=0 (sdissip_jan.F90:50-120).
"""

from __future__ import annotations

import numpy as np
import torch

from wavebench.reference.ecw.core import constants as c
from wavebench.reference.ecw.core import physparams as pp
from wavebench.reference.ecw.ops.physics import const


def saturation_matrix(nang: int, sat_indices, sat_weights) -> np.ndarray:
    """Dense (nang × nang) direction-coupling matrix of the saturation
    half-integral: BTH[k] = Σ_j W[k, j]·F[j] (sdissip_ard.F90:100-115)."""
    wmat = np.zeros((nang, nang))
    for k in range(nang):
        for j in range(sat_indices.shape[1]):
            wmat[k, sat_indices[k, j]] += sat_weights[k, j]
    return wmat


def sdissip_ard(fl1, fld, sl, wavnum, xk2cg, ufric, coswdif, raorw,
                tb, params: pp.PhysParams, sat_indices, sat_weights):
    """Saturation-spectrum dissipation (sdissip_ard.F90:70-256)."""
    if pp.SSDSC3 != 0.0:
        raise ValueError("cumulative breaking term is disabled in the "
                         "reference")
    nang = fl1.shape[0]
    zpifr = const(tb.zpifr, fl1)[:, None]            # (nfre, 1)
    tpiinv = 1.0 / c.ZPI
    tmp03 = 1.0 / (pp.SDSBR * pp.MICHE)

    facsat = wavnum * tpiinv * xk2cg                 # (nfre, npts)
    wmat = const(saturation_matrix(nang, sat_indices, sat_weights), fl1)
    bth = torch.einsum("kj,jmp->kmp", wmat, fl1) * facsat[None, :, :]
    bth0 = torch.amax(bth, dim=0)                    # (nfre, npts)

    ssdsc2_sig = pp.SSDSC2 * zpifr                   # (nfre, 1)
    zcoef = ssdsc2_sig * pp.SSDSC6
    zcoefm1 = ssdsc2_sig * (1.0 - pp.SSDSC6)
    d = (zcoef[None] * torch.clamp(bth0[None] * tmp03 - pp.SSDSC4,
                                   min=0.0) ** pp.IPSAT
         + zcoefm1[None] * torch.clamp(bth * tmp03 - pp.SSDSC4,
                                       min=0.0) ** pp.IPSAT)

    if params.ssdsc5 != 0.0:
        facturb = (2.0 * params.ssdsc5 / c.G) * raorw * ufric**2
        facwtrb = zpifr * wavnum * facturb[None, :]
        d = d - facwtrb[None, :, :] * coswdif[:, None, :]

    return fld + d, sl + d * fl1


def sdissip_jan(fl1, fld, sl, wavnum, emean, f1mean, xkmean,
                tb, params: pp.PhysParams):
    """WAM cycle-4 dissipation (sdissip_jan.F90:50-120) from the mean
    parameters of the step's first FKMEAN."""
    conss = params.cdis * c.ZPI
    sds = conss * f1mean * emean**2 * xkmean**4           # (npts,)
    x = wavnum / xkmean[None, :]                          # (nfre, npts)
    cvis = pp.RNU * params.cdisvis
    temp1 = (sds[None, :] * x * ((1.0 - params.delta_sdis)
                                 + params.delta_sdis * x)
             + cvis * wavnum**2)
    return fld + temp1[None, :, :], sl + temp1[None, :, :] * fl1
