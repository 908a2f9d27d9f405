"""Ocean-flux diagnostics: the WNFLUXES equivalent.

Port of ``ecwam_tpu/ops/physics/fluxes.py``: the air→wave and
wave→ocean energy/momentum fluxes from the limited source-term
contribution SSOURCE of the implicit update (wnfluxes.F90:150-340,
called from implsch.F90:399-414 when LCFLX).

Layout: spectra are (nang, nfre, npts); point fields are (npts,).
"""

from __future__ import annotations

import math

import torch

from wavebench.reference.ecw.core import constants as c
from wavebench.reference.ecw.ops.physics import const

# fictitious normalised energy flux under sea ice (wnfluxes.F90:113-114)
PHIOC_ICE = -3.75
PHIAW_ICE = 3.75
# Hersbach 2011 CD(U10) bulk parametrisation (wnfluxes.F90:117-121)
_C1 = 1.03e-3
_C2 = 0.04e-3
_P1 = 1.48
_P2 = -0.21
_CDMAX = 0.003
# Hs limits under sea ice (wnfluxes.F90:120-121)
EFD_MIN = 0.0625
EFD_MAX = 6.25


def ice_constants(params, *, lciwa: bool = False, cithrsh: float = 0.3,
                  ciblock: float = 0.0) -> dict:
    """The scalar constants of the sea-ice adjustment
    (wnfluxes.F90:160-190)."""
    if lciwa:
        zcithrs, cithrsh_inv, zmaxexp = 0.0, 50.0, 20.0
    else:
        zcithrs, cithrsh_inv, zmaxexp = ciblock, 1.0 / max(cithrsh, 0.01), 10.0
    return dict(
        zcithrs=zcithrs, cithrsh_inv=cithrsh_inv, zmaxexp=zmaxexp,
        efd_fac=4.0 * params.egrcrv / c.G**2,
        ffd_fac=(params.egrcrv / params.afcrv) ** (1.0 / params.bfcrv) * c.G)


def wnfluxes(ssource, cinv, rhowgdfth, cicover, phiwa,
             em, f1, wswave, wdwave, ufric, aird,
             tb, params, *,
             licerun: bool = True, lwamrsetci: bool = True,
             lciwa: bool = False, cithrsh: float = 0.3,
             ciblock: float = 0.0):
    """Wave energy/momentum fluxes to the ocean (wnfluxes.F90:150-340).

    ``ssource`` is the implicit-factor-modulated source term (nang, nfre,
    npts); ``rhowgdfth`` the ρw·g·Δf·Δθ trapezoid weights zeroed above the
    prognostic cut (nfre, npts).  Returns a dict of point fields.
    """
    epsus3 = c.EPSUS * math.sqrt(c.EPSUS)
    k = ice_constants(params, lciwa=lciwa, cithrsh=cithrsh, ciblock=ciblock)
    sinth = const(tb.sinth, ssource)[:, None, None]
    costh = const(tb.costh, ssource)[:, None, None]

    # energy/momentum integrals of SSOURCE (wnfluxes.F90:199-221)
    sumt = torch.sum(ssource, dim=0)                      # (nfre, npts)
    sumx = torch.sum(sinth * ssource, dim=0)
    sumy = torch.sum(costh * ssource, dim=0)
    philf = torch.sum(sumt * rhowgdfth, dim=0)            # (npts,)
    cmrho = cinv * rhowgdfth
    xstress = torch.sum(sumx * cmrho, dim=0)
    ystress = torch.sum(sumy * cmrho, dim=0)

    # sea-ice adjusted u*, EM, F1 (wnfluxes.F90:223-259)
    if licerun and lwamrsetci:
        iced = cicover > k["zcithrs"]
        ooval_ice = torch.exp(-torch.clamp(
            (cicover * k["cithrsh_inv"]) ** 4, max=k["zmaxexp"]))
        u10p = torch.clamp(wswave, min=c.EPSU10)
        cd_bulk = torch.clamp((_C1 + _C2 * u10p**_P1) * u10p**_P2,
                              max=_CDMAX)
        cd_wave = (ufric / u10p) ** 2
        cd_ice = ooval_ice * cd_wave + (1.0 - ooval_ice) * cd_bulk
        ustar_ice = torch.clamp(torch.sqrt(cd_ice) * u10p, min=c.EPSUS)
        efd = torch.clamp(k["efd_fac"] * ustar_ice**4, max=EFD_MAX)
        em_oc_ice = torch.clamp(ooval_ice * em + (1.0 - ooval_ice) * efd,
                                min=EFD_MIN)
        ffd = k["ffd_fac"] / ustar_ice
        f1_oc_ice = torch.clamp(ooval_ice * f1 + (1.0 - ooval_ice) * ffd,
                                float(tb.fr[1]), float(tb.fr[-1]))
        ooval = torch.where(iced, ooval_ice, torch.ones_like(ooval_ice))
        ustar = torch.where(iced, ustar_ice, ufric)
        em_oc = torch.where(iced, em_oc_ice, em)
        f1_oc = torch.where(iced, f1_oc_ice, f1)
    else:
        ooval = torch.ones_like(ufric)
        ustar, em_oc, f1_oc = ufric, em, f1

    # total and ocean stress (wnfluxes.F90:261-271)
    tau = aird * torch.clamp(ustar**2, min=c.EPSUS)
    tauxd = tau * torch.sin(wdwave)
    tauyd = tau * torch.cos(wdwave)
    tauocxd = tauxd - ooval * xstress
    tauocyd = tauyd - ooval * ystress
    tauo = torch.sqrt(tauocxd**2 + tauocyd**2)
    tauoc = torch.clamp(tauo / tau, c.TAUOCMIN, c.TAUOCMAX)

    # energy fluxes (wnfluxes.F90:297-313)
    xn = aird * torch.clamp(ustar**3, min=epsus3)
    phiocd = ooval * (philf - phiwa) + (1.0 - ooval) * PHIOC_ICE * xn
    phieps = torch.clamp(phiocd / xn, c.PHIEPSMIN, c.PHIEPSMAX)
    phiocd = phieps * xn
    phiaw = ooval * phiwa / xn + (1.0 - ooval) * PHIAW_ICE

    return dict(
        tauxd=tauxd, tauyd=tauyd, tauocxd=tauocxd, tauocyd=tauocyd,
        tauoc=tauoc, phiocd=phiocd, phieps=phieps, phiaw=phiaw,
        em_oc=em_oc, f1_oc=f1_oc)
