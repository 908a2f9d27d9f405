"""Physics tunables and derived constants.

Copied unchanged from ``ecwam_tpu/core/physparams.py`` (numpy only, no
JAX), with its imports pointed at ``wavebench.reference.ecw``: the port
imports nothing of the JAX package.

Re-derivation of the reference's tunable-parameter system:
  - the parameter registry  yowphys.F90:18-157
  - the per-physics-package value selection  setwavphys.F90:46-204
  - derived wind-input constants             init_x0tauhf.F90:65-69
  - saturation-integral direction weights    init_sdiss_ardh.F90:70-98

Everything is a frozen dataclass built once on host (NumPy/f64); kernels close
over the values and cast to the model dtype.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from wavebench.reference.ecw.core import constants as c

# Fixed parameters (yowphys.F90, PARAMETER declarations)
XKAPPA = 0.40            # von Karman constant
XNLEV = 10.0             # wind reference height (m)
ALPHAMAX = 0.11          # maximum Charnock
ALPHAPMINFAC = 0.1
SWELLF = 0.66            # negative input (Ardhuin 2010) constants
SWELLF2 = -0.018
SWELLF3 = 0.022
SWELLF5 = 1.2
SWELLF6 = 1.0
ABMIN = 0.3
ABMAX = 8.0
SDSBR = 9.0e-4           # saturation threshold Br
ISDSDTH = 80             # half-width (deg) of saturation direction integral
ISB = 2
IPSAT = 2
SSDSC2 = -2.2e-5
SSDSC3 = 0.0
SSDSC4 = 1.0
SSDSC6 = 0.3
MICHE = 1.0
SSDSBRF1 = 0.5
BRKPBCOEF = 28.16
RNU = 1.5e-5             # kinematic air viscosity (runwam.F90:232)
RNUM = 0.11 * RNU        # reduced viscosity for momentum (runwam.F90:233)


@dataclasses.dataclass(frozen=True)
class PhysParams:
    """All tunables selected by ``set_phys_params`` (setwavphys.F90)."""

    iphys: int
    llgcbz0: bool
    llnormagam: bool
    llcapchnk: bool

    zalp: float
    tailfactor: float
    tailfactor_pm: float
    alpha: float                 # minimum Charnock with no waves
    alphamin: float
    alphapmax: float
    chnkmin_u: float
    betamax: float
    tauwshelter: float
    ang_gc_a: float
    ang_gc_b: float
    ang_gc_c: float
    delta_theta_rn: float
    dthrn_a: float
    dthrn_u: float
    rn1_rn: float
    # WAM cycle-4 (Janssen) whitecapping
    cdis: float
    delta_sdis: float
    cdisvis: float
    # Ardhuin swell damping
    z0tubmax: float
    z0rat: float
    swellf4: float
    swellf7: float
    swellf7m1: float
    ssdsc5: float
    # fully-developed-sea empirical curve (yowaltas, setwavphys.F90:103-107,
    # 193-197); used by the WNFLUXES sea-ice branch
    egrcrv: float = 1065.0
    afcrv: float = 2.453e-4
    bfcrv: float = -3.1236

    # Derived wind-input constants (init_x0tauhf.F90:65-69)
    betamaxoxkappa2: float = dataclasses.field(init=False)
    bmaxokap: float = dataclasses.field(init=False)

    def __post_init__(self):
        object.__setattr__(self, "betamaxoxkappa2", self.betamax / XKAPPA**2)
        object.__setattr__(
            self, "bmaxokap",
            self.delta_theta_rn * self.betamaxoxkappa2 / XKAPPA)

    def bmaxokapdth(self, delth: float) -> float:
        return self.bmaxokap * delth

    def gamnconst(self) -> float:
        # init_x0tauhf.F90:69
        return self.bmaxokap * 0.5 * c.ZPI**4 * c.GM1**3


def set_phys_params(
    iphys: int = 1,
    *,
    nang: int = 36,
    llgcbz0: bool = False,
    llnormagam: bool = False,
    llcapchnk: bool = False,
) -> PhysParams:
    """Select tunables for a physics package (setwavphys.F90:46-204)."""
    if nang <= 24:
        ang_gc = (0.40, 0.60, 3.0)
    else:
        ang_gc = (0.35, 0.65, 3.0)

    if iphys == 0:
        # Janssen (WAM cycle 4) wind input physics
        common = dict(
            iphys=0, llgcbz0=llgcbz0, llnormagam=llnormagam,
            llcapchnk=llcapchnk,
            zalp=0.008, tailfactor=2.5, tailfactor_pm=0.0,
            alphamin=0.0001, alphapmax=0.03, tauwshelter=0.0,
            ang_gc_a=ang_gc[0], ang_gc_b=ang_gc[1], ang_gc_c=ang_gc[2],
            delta_theta_rn=0.75, dthrn_a=0.80, dthrn_u=33.0, rn1_rn=0.25,
            # Ardhuin-only knobs: keep iphys=1 defaults; unused when iphys=0
            z0tubmax=0.0005, z0rat=0.04, swellf4=1.5e5, swellf7=3.6e5,
            swellf7m1=1.0 / 3.6e5, ssdsc5=0.0,
            egrcrv=1108.0, afcrv=4.0e-4, bfcrv=-3.0,
        )
        if llgcbz0:
            return PhysParams(
                **common, alpha=0.0055, chnkmin_u=28.0,
                betamax=1.32 if llnormagam else 1.25,
                cdis=-1.3, delta_sdis=0.6, cdisvis=-4.0)
        return PhysParams(
            **common, alpha=0.0065, chnkmin_u=33.0, betamax=1.20,
            cdis=-1.33, delta_sdis=0.5, cdisvis=0.0)

    if iphys == 1:
        # Ardhuin et al. (2010) wind input physics
        common = dict(
            iphys=1, llgcbz0=llgcbz0, llnormagam=llnormagam,
            llcapchnk=llcapchnk,
            zalp=0.008, tailfactor=2.5, tailfactor_pm=3.0,
            ang_gc_a=ang_gc[0], ang_gc_b=ang_gc[1], ang_gc_c=ang_gc[2],
            rn1_rn=0.25, ssdsc5=0.0,
            # cycle-4 dissipation knobs unused for iphys=1
            cdis=-1.33, delta_sdis=0.5, cdisvis=0.0,
        )
        if llgcbz0:
            return PhysParams(
                **common,
                alpha=0.0055, alphamin=0.0001, chnkmin_u=28.0,
                alphapmax=0.03,
                delta_theta_rn=0.75, dthrn_a=0.60, dthrn_u=33.0,
                z0tubmax=0.05, z0rat=0.02, swellf4=1.15e5, swellf7=4.32e5,
                swellf7m1=1.0 / 4.32e5,
                betamax=1.39 if llnormagam else 1.44,
                tauwshelter=0.0 if llnormagam else 0.25)
        if llnormagam:
            return PhysParams(
                **common,
                alpha=0.0065, alphapmax=0.031,
                delta_theta_rn=0.75, dthrn_a=0.60, dthrn_u=200.0,
                z0tubmax=0.0005, z0rat=0.04, swellf4=1.5e5, swellf7=3.6e5,
                swellf7m1=1.0 / 3.6e5,
                betamax=1.39, tauwshelter=0.0,
                alphamin=0.0005, chnkmin_u=30.0)
        return PhysParams(
            **common,
            alpha=0.0065, alphapmax=0.031,
            delta_theta_rn=0.75, dthrn_a=0.60, dthrn_u=200.0,
            z0tubmax=0.0005, z0rat=0.04, swellf4=1.5e5, swellf7=3.6e5,
            swellf7m1=1.0 / 3.6e5,
            betamax=1.40, tauwshelter=0.25,
            alphamin=0.0001, chnkmin_u=33.0)

    raise ValueError(f"unknown physics selection IPHYS={iphys}")


def saturation_weights(nang: int, th: np.ndarray, delth: float):
    """Direction-neighbour indices and weights for the saturation spectrum.

    Re-derivation of init_sdiss_ardh.F90:70-98.  Returns
    ``(nsdsnth, indices[nang, 2*nsdsnth+1], weights[nang, 2*nsdsnth+1])``
    with 0-based direction indices.
    """
    nangd = nang // 2
    nsdsnth = min(int(round(ISDSDTH * c.RAD / delth)), nangd - 1)
    delth_trunc = (th[0] + ISDSDTH * c.RAD) - (th[nsdsnth] - 0.5 * delth)
    delth_trunc = max(0.0, min(delth_trunc, delth))

    n = 2 * nsdsnth + 1
    indices = np.zeros((nang, n), dtype=np.int32)
    weights = np.zeros((nang, n), dtype=np.float64)
    for k in range(nang):
        for off in range(-nsdsnth, nsdsnth + 1):
            j = (k + off) % nang
            col = off + nsdsnth
            indices[k, col] = j
            dloc = delth_trunc if abs(off) == nsdsnth else delth
            weights[k, col] = dloc * math.cos(th[k] - th[j]) ** ISB
    return nsdsnth, indices, weights
