"""Spectral (frequency × direction) discretisation tables.

Copied unchanged from ``ecwam_tpu/core/spectral.py`` (numpy only, no
JAX), with its imports pointed at ``wavebench.reference.ecw``: the port
imports nothing of the JAX package.

Re-derivation, as a single immutable NumPy table object, of the reference's
frequency/direction setup scattered across
mfr.F90:42-49, mfredir.F90:90-135 and
initmdl.F90:435-500.  All tables are computed once on host in float64; kernels
cast to the model dtype when closing over them.

Spectrum conventions (reference mfredir.F90:112-127):
  - frequencies  fr[m] = fr1 * fratio**(m - ifre1),  fratio = 1.1
  - directions   th[k] = (k + 1/2) * 2π/nang   (k = 0..nang-1, clockwise from
    north — the "oceanographic direction the waves travel towards")
  - dfim[m] = trapezoidal band-area weight × direction increment
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from wavebench.reference.ecw.core import constants as c

FRATIO = 1.1                 # yowfred.F90:50
WETAIL = 0.25                # wave-energy tail factor (yowfred.F90:51)
FRTAIL = 0.2                 # frequency tail factor
WP1TAIL = 1.0 / 3.0
WP2TAIL = 0.5
QPTAIL = 2.0 / 9.0
COEF4 = 5.0e-07              # growth-limiter coefficient (yowfred.F90:56)
FRIC = 28.0                  # PM frequency constant (yowfred.F90:81)


@dataclasses.dataclass(frozen=True)
class SpectralTables:
    """Frequency/direction grid and all derived integration weights."""

    nang: int
    nfre: int
    nfre_red: int            # number of frequencies actually advected
    ifre1: int               # 1-based index of the reference frequency
    fr1: float               # reference frequency (Hz)

    # 1-D frequency tables, shape (nfre,)
    fr: np.ndarray           # frequencies (Hz)
    dfim: np.ndarray         # Δf·Δθ trapezoidal weight
    dfimofr: np.ndarray      # dfim / fr
    dfimfr: np.ndarray       # dfim * fr
    dfimfr2: np.ndarray      # dfim * fr²
    dfim_sim: np.ndarray     # Simpson-rule weight
    dfimofr_sim: np.ndarray
    dfimfr_sim: np.ndarray
    dfimfr2_sim: np.ndarray
    dfim_end_l: np.ndarray   # last-interval lower-bound weight
    dfim_end_u: np.ndarray
    rhowg_dfim: np.ndarray   # ρw·g·Δθ·ln(fratio)·fr (energy-flux weight)
    gom: np.ndarray          # deep-water group velocity g/(4πf)
    c_ph: np.ndarray         # deep-water phase velocity g/(2πf)
    zpifr: np.ndarray        # 2π·fr  (angular frequency)
    fr5: np.ndarray          # fr⁵
    frm5: np.ndarray         # fr⁻⁵
    cofrm4: np.ndarray       # COEF4·g/fr⁴ (growth limiter)

    # 1-D direction tables, shape (nang,)
    th: np.ndarray           # directions (radians)
    costh: np.ndarray
    sinth: np.ndarray

    delth: float             # direction increment 2π/nang
    xlogfratio: float        # ln(fratio)
    flogsprdm1: float        # 1/log10(fratio)
    fratio: float

    @property
    def omega(self) -> np.ndarray:
        return self.zpifr


def build_spectral_tables(
    nang: int,
    nfre: int,
    *,
    nfre_red: int | None = None,
    ifre1: int = 3,
    fr1: float = 0.04177248,
) -> SpectralTables:
    """Build all spectral tables.

    Defaults for ``ifre1``/``fr1`` follow the reference operational setup
    (preset.F90:85-87 and ecwam_run_model.sh; fr(1) ≈ 0.03453 Hz for
    ifre1=3, fr1=0.04177248).
    """
    if nfre_red is None:
        nfre_red = nfre
    assert 1 <= ifre1 <= nfre and 0 < nfre_red <= nfre

    # mfr.F90:42-49 — build geometric frequency ladder around index ifre1.
    # Reproduce the reference's sequential multiply/divide (not a power law)
    # so rounding matches bit-for-bit in float64.
    fr = np.empty(nfre, dtype=np.float64)
    fr[ifre1 - 1] = fr1
    for m in range(ifre1 - 2, -1, -1):
        fr[m] = fr[m + 1] / FRATIO
    for m in range(ifre1, nfre):
        fr[m] = FRATIO * fr[m - 1]

    delth = c.ZPI / nang
    k = np.arange(nang, dtype=np.float64)
    th = (k + 0.5) * delth                      # mfredir.F90:112-117

    # Trapezoidal band weights (mfredir.F90:124-131)
    co1 = 0.5 * (FRATIO - 1.0) * delth
    dfim = np.empty(nfre, dtype=np.float64)
    dfim[0] = co1 * fr[0]
    dfim[1:-1] = co1 * (fr[1:-1] + fr[:-2])
    dfim[-1] = co1 * fr[-2]

    xlogfratio = math.log(FRATIO)

    # Simpson weights (initmdl.F90:487-496): fr-weighted composite Simpson
    nfre_odd = nfre - 1 + nfre % 2
    dfim_sim = np.zeros(nfre, dtype=np.float64)
    dfim_sim[0] = delth * xlogfratio * fr[0] / 3.0
    for m in range(1, nfre_odd - 1, 2):
        dfim_sim[m] = 4.0 * delth * xlogfratio * fr[m] / 3.0
        dfim_sim[m + 1] = 2.0 * delth * xlogfratio * fr[m + 1] / 3.0
    dfim_sim[nfre_odd - 1] = delth * xlogfratio * fr[nfre_odd - 1] / 3.0

    # Energy-flux weight (initmdl.F90:479-485)
    rhowg_dfim = c.ROWATER * c.G * delth * xlogfratio * fr
    rhowg_dfim[0] *= 0.5
    rhowg_dfim[-1] *= 0.5

    # Last/first-interval partial weights (initmdl.F90:459-471)
    scdf_l = 0.5 * delth * (FRATIO - 1.0)
    scdf_u = 0.5 * delth * (1.0 - 1.0 / FRATIO)

    return SpectralTables(
        nang=nang,
        nfre=nfre,
        nfre_red=nfre_red,
        ifre1=ifre1,
        fr1=fr1,
        fr=fr,
        dfim=dfim,
        dfimofr=dfim / fr,
        dfimfr=dfim * fr,
        dfimfr2=dfim * fr**2,
        dfim_sim=dfim_sim,
        dfimofr_sim=dfim_sim / fr,
        dfimfr_sim=dfim_sim * fr,
        dfimfr2_sim=dfim_sim * fr**2,
        dfim_end_l=scdf_l * fr,
        dfim_end_u=scdf_u * fr,
        rhowg_dfim=rhowg_dfim,
        gom=c.G / (4.0 * c.PI * fr),
        c_ph=c.G / (c.ZPI * fr),
        zpifr=c.ZPI * fr,
        fr5=fr**5,
        frm5=fr**-5.0,
        cofrm4=COEF4 * c.G / fr**4,
        th=th,
        costh=np.cos(th),
        sinth=np.sin(th),
        delth=delth,
        xlogfratio=xlogfratio,
        flogsprdm1=1.0 / math.log10(FRATIO),
        fratio=FRATIO,
    )
