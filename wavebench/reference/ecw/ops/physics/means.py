"""Spectral moment / mean-parameter computations.

Port of ``ecwam_tpu/ops/physics/means.py`` (SEMEAN semean.F90:60-85,
FEMEAN femean.F90:55-110, FEMEANWS femeanws.F90:52-100, FKMEAN
fkmean.F90:60-100, SDEPTHLIM sdepthlim.F90:32-46).  Layout:
``fl1[nang, nfre, npts]``; per-frequency env fields ``(nfre, npts)``;
outputs ``(npts,)``.
"""

from __future__ import annotations

import math

import torch

from wavebench.reference.ecw.core import constants as c
from wavebench.reference.ecw.core import spectral as sp
from wavebench.reference.ecw.ops.physics import const


def semean(fl1, tables, llepsmin: bool = True):
    """Total variance EM (semean.F90:60-85)."""
    dfim = const(tables.dfim, fl1)[:, None]
    temp = torch.sum(fl1, dim=0)                    # (nfre, npts)
    em = torch.sum(dfim * temp, dim=0)
    em = em + sp.WETAIL * tables.fr[-1] * tables.delth * temp[-1]
    if llepsmin:
        em = em + c.EPSMIN
    return em


def femean(fl1, tables):
    """Energy EM and mean frequency FM (femean.F90:55-110).

    Each spectral bin is floored at EPSMIN before summing, and the result
    FM is floored at fr[0] — both reference behaviors.
    """
    dfim = const(tables.dfim, fl1)[:, None]
    dfimofr = const(tables.dfimofr, fl1)[:, None]
    temp = torch.sum(torch.clamp(fl1, min=c.EPSMIN), dim=0)
    em = torch.sum(dfim * temp, dim=0)
    fm = torch.sum(dfimofr * temp, dim=0)
    em = em + sp.WETAIL * tables.fr[-1] * tables.delth * temp[-1]
    fm = fm + sp.FRTAIL * tables.delth * temp[-1]
    return em, torch.clamp(em / fm, min=float(tables.fr[0]))


def femeanws(fl1, xllws, tables):
    """Windsea energy and mean frequency (femeanws.F90:52-100).

    ``xllws`` is the 0/1 windsea mask produced by SINPUT.
    """
    dfim = const(tables.dfim, fl1)[:, None]
    dfimofr = const(tables.dfimofr, fl1)[:, None]
    temp = torch.sum(xllws * fl1, dim=0)
    em = torch.sum(dfim * temp, dim=0) + c.EPSMIN
    fm = torch.sum(dfimofr * temp, dim=0) + c.EPSMIN
    em = em + sp.WETAIL * tables.fr[-1] * tables.delth * temp[-1]
    fm = fm + sp.FRTAIL * tables.delth * temp[-1]
    return em, em / fm


def fkmean(fl1, wavnum, tables):
    """Variance, mean frequencies and mean wavenumbers (fkmean.F90:60-100).

    Returns (em, fm1, f1, ak, xk):
      em   total variance
      fm1  mean frequency based on 1/f weighting   em/∫f⁻¹
      f1   mean frequency based on f weighting     ∫f/em
      ak   mean wavenumber from 1/√k weighting     (em/∫k^-½)²
      xk   mean wavenumber from √k weighting       (∫k^½/em)²
    """
    eps = c.EPSMIN
    dfim = const(tables.dfim, fl1)[:, None]
    dfimofr = const(tables.dfimofr, fl1)[:, None]
    dfimfr = const(tables.dfimfr, fl1)[:, None]

    sqrtk = torch.sqrt(wavnum)                      # (nfre, npts)
    tempa = dfim / sqrtk
    tempx = sqrtk * dfim
    temp2 = torch.sum(fl1, dim=0)                   # (nfre, npts)

    em = eps + torch.sum(dfim * temp2, dim=0)
    fm1 = eps + torch.sum(dfimofr * temp2, dim=0)
    f1 = eps + torch.sum(dfimfr * temp2, dim=0)
    ak = eps + torch.sum(tempa * temp2, dim=0)
    xk = eps + torch.sum(tempx * temp2, dim=0)

    delt25 = sp.WETAIL * tables.fr[-1] * tables.delth
    coefm1 = sp.FRTAIL * tables.delth
    coef1 = sp.WP1TAIL * tables.delth * tables.fr[-1] ** 2
    coefa = coefm1 * math.sqrt(c.G) / c.ZPI
    coefx = coef1 * c.ZPI / math.sqrt(c.G)

    t_last = temp2[-1]
    em = em + delt25 * t_last
    fm1 = em / (fm1 + coefm1 * t_last)
    f1 = (f1 + coef1 * t_last) / em
    ak = (em / (ak + coefa * t_last)) ** 2
    xk = ((xk + coefx * t_last) / em) ** 2
    return em, fm1, f1, ak, xk


def sdepthlim(fl1, emaxdpt, tables):
    """Clip total variance to the depth-limited maximum (sdepthlim.F90:32-46)."""
    em = semean(fl1, tables, llepsmin=True)
    scale = torch.clamp(emaxdpt / em, max=1.0)
    return torch.clamp(fl1 * scale[None, None, :], min=c.EPSMIN)
