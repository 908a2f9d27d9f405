"""Surface Stokes drift and mean-square strain in sea ice.

Port of ``ecwam_tpu/ops/physics/stokes.py``: STOKESDRIFT (Kenyon 1969
integral + unresolved-tail term, stokesdrift.F90:95-145), CIMSSTRN
(sea-ice flexural strain, cimsstrn.F90:85-125) with the ice-modified
dispersion AKI_ICE (aki_ice.F90), and the STOKESTRN wrapper
(stokestrn.F90:60-90).

Layout: fl1 (nang, nfre, npts); per-frequency env fields (nfre, npts).
"""

from __future__ import annotations

import torch

from wavebench.reference.ecw.core import constants as c
from wavebench.reference.ecw.ops.physics import const
from wavebench.reference.ecw.ops.physics.tail_ice import FLMIN

STMAX = 1.5                  # Stokes magnitude cap (stokesdrift.F90:78)

# sea-ice material constants (aki_ice.F90)
YMICE = 5.5e9                # Young modulus of sea ice
RMUICE = 0.3                 # Poisson ratio
RHOI = 922.5                 # sea-ice density
AKI_MAX = 20.0
NEWTON_ITERS = 25            # fixed-trip replacement of the while loop


def stokes_const(tb) -> float:
    """The f⁻⁵-tail coefficient of the Stokes integral
    (stokesdrift.F90:115-123)."""
    nfre_odd = tb.nfre - 1 + tb.nfre % 2
    return 2.0 * tb.delth * c.ZPI**3 / c.G * tb.fr[nfre_odd - 1] ** 4


def stokesdrift(fl1, stokfac, wswave, wdwave, cicover, tb, *,
                licerun: bool = True, lwamrsetci: bool = True,
                cithrsh: float = 0.3):
    """Surface Stokes drift vector (stokesdrift.F90:95-145).

    ``stokfac`` is the per-(freq, point) depth factor; the integral uses
    Simpson weights over the first NFRE_ODD frequencies plus an analytic
    f⁻⁵-tail contribution.
    """
    nfre_odd = tb.nfre - 1 + tb.nfre % 2
    stfac = stokfac[:nfre_odd] * const(tb.dfim_sim[:nfre_odd], fl1)[:, None]
    sinth = const(tb.sinth, fl1)[:, None]
    costh = const(tb.costh, fl1)[:, None]
    fac3 = stfac[None, :, :] * fl1[:, :nfre_odd]
    ustokes = torch.sum(fac3 * sinth[:, :, None], dim=(0, 1))
    vstokes = torch.sum(fac3 * costh[:, :, None], dim=(0, 1))

    # unresolved-tail contribution (stokesdrift.F90:115-123)
    tail = fl1[:, nfre_odd - 1]                             # (nang, npts)
    cst = stokes_const(tb)
    ustokes = ustokes + cst * torch.sum(sinth * tail, dim=0)
    vstokes = vstokes + cst * torch.sum(costh * tail, dim=0)

    if licerun and lwamrsetci:
        iced = cicover > cithrsh
        fac = 0.016 * wswave * (1.0 - cicover)
        ustokes = torch.where(iced, fac * torch.sin(wdwave), ustokes)
        vstokes = torch.where(iced, fac * torch.cos(wdwave), vstokes)

    return (torch.clamp(ustokes, -STMAX, STMAX),
            torch.clamp(vstokes, -STMAX, STMAX))


def aki_ice(xk, depth, cith):
    """Ice-modified wavenumber: Newton solve of the flexural dispersion
    ω² = (F·k⁵ + g·k) / (ρi/ρw·h·k + coth(kd)) (aki_ice.F90).

    A fixed number of Newton steps with the reference's clipping; points
    with zero ice thickness return ``xk`` unchanged.  Shapes broadcast:
    xk (nfre, npts), depth/cith (npts,).
    """
    ficstf = (YMICE * cith**3 / (12.0 * (1.0 - RMUICE**2))) / c.ROWATER
    rdh = (RHOI / c.ROWATER) * cith
    d = depth[None, :]
    om2 = c.G * xk * torch.tanh(xk * d)
    aki = torch.minimum(xk, (om2 / torch.clamp(ficstf, min=1.0)) ** 0.2)
    for _ in range(NEWTON_ITERS):
        akid = torch.clamp(d * aki, max=50.0)
        sinh2 = torch.sinh(akid) ** 2
        f = ficstf * aki**5 + c.G * aki - om2 * (rdh * aki
                                                 + 1.0 / torch.tanh(akid))
        fp = 5.0 * ficstf * aki**4 + c.G - om2 * (rdh - d / sinh2)
        nxt = aki - f / fp
        aki = torch.where(nxt <= 0.0, torch.full_like(nxt, AKI_MAX),
                          torch.clamp(nxt, max=AKI_MAX))
    return torch.where(cith[None, :] <= 0.0, xk, aki)


def cimsstrn(fl1, wavnum, depth, cithick, tb):
    """Mean-square strain in sea ice (cimsstrn.F90:85-125)."""
    f1lim = FLMIN / tb.delth
    xki = aki_ice(wavnum, depth, cithick)
    e = 0.5 * cithick[None, :] * xki**3 / wavnum        # (nfre, npts)
    sume = torch.sum(fl1, dim=0)                        # (nfre, npts)
    contrib = torch.where(sume > f1lim,
                          e**2 * sume * const(tb.dfim, fl1)[:, None],
                          torch.zeros_like(sume))
    return torch.sum(contrib, dim=0)


def stokestrn(fl1, wavnum, stokfac, depth, wswave, wdwave, cicover,
              cithick, tb, *, licerun: bool = True,
              lwamrsetci: bool = True, cithrsh: float = 0.3,
              lstrn: bool = False):
    """STOKESTRN wrapper: Stokes drift + optional ice strain
    (stokestrn.F90:60-90)."""
    ustokes, vstokes = stokesdrift(
        fl1, stokfac, wswave, wdwave, cicover, tb,
        licerun=licerun, lwamrsetci=lwamrsetci, cithrsh=cithrsh)
    out = dict(ustokes=ustokes, vstokes=vstokes)
    if lstrn:
        out["strnms"] = cimsstrn(fl1, wavnum, depth, cithick, tb)
    return out
