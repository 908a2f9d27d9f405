"""Precomputed physics lookup tables (host, NumPy/f64).

Copied unchanged from ``ecwam_tpu/ops/physics/tables.py`` (numpy only, no
JAX), with its imports pointed at ``wavebench.reference.ecw``: the port
imports nothing of the JAX package.

  - swell friction factor table      (tabu_swellft.F90:30-52)
  - high-frequency stress integration constants X0TAUHF / WTAUHF
                                     (init_x0tauhf.F90:56-100)

The Kelvin functions ker/kei come from SciPy instead of the reference's own
series implementation (kerkei.F90) — same special functions.
"""

from __future__ import annotations

import math

import numpy as np

from wavebench.reference.ecw.core import constants as c
from wavebench.reference.ecw.core import physparams as pp

IAB = 200                 # table size (yowtabl.F90:25)
ABMIN = 0.3               # log10 range of a/z0 (tabu_swellft.F90)
ABMAX = 8.0
JTOT_TAUHF = 19           # Simpson nodes, must be odd (yowcoup.F90:60)

_swellft_cache: np.ndarray | None = None


def tabu_swellft() -> np.ndarray:
    """Friction factor fw in oscillatory boundary layers vs log10(a_b/z0).

    Entry i (0-based) corresponds to abrlog = ABMIN + (i+1)·Δ, Δ=(ABMAX-ABMIN)/IAB
    (tabu_swellft.F90:30-52, 100 damped fixed-point iterations of Jonsson's
    rough-turbulent friction law with ker/kei).
    """
    global _swellft_cache
    if _swellft_cache is not None:
        return _swellft_cache
    from scipy.special import ker, kei

    kappa = 0.40
    delab = (ABMAX - ABMIN) / IAB
    abrlog = ABMIN + (np.arange(1, IAB + 1)) * delab
    abr = np.power(10.0, abrlog)
    fact = 1.0 / abr / (21.2 * kappa)
    fsubw = np.full(IAB, 0.05)
    dzeta0 = np.zeros(IAB)
    for _ in range(100):
        fsubw_memo = fsubw
        dzeta0_memo = dzeta0
        dzeta0 = fact * fsubw ** (-0.5)
        x = 2.0 * np.sqrt(dzeta0)
        fsubw_new = 0.08 / (ker(x) ** 2 + kei(x) ** 2)
        fsubw = 0.5 * (fsubw_memo + fsubw_new)
        dzeta0 = 0.5 * (dzeta0_memo + dzeta0)
    _swellft_cache = fsubw
    return fsubw


def x0_tauhf(params: pp.PhysParams) -> float:
    """Newton solve for x0: alph·x0²·exp(κ/(x0+zalp)) = 1 (init_x0tauhf.F90:76-85).

    x0 is the lower-limit ratio u*/c for the tail-stress integral.
    """
    if params.llgcbz0 or params.llcapchnk or params.llnormagam:
        alph = params.alphamin
    else:
        alph = params.alpha
    x0 = 0.005
    for _ in range(30):
        ff = math.exp(pp.XKAPPA / (x0 + params.zalp))
        f = alph * x0**2 * ff - 1.0
        if f == 0.0:
            break
        df = alph * ff * (2.0 * x0 - pp.XKAPPA * (x0 / (x0 + params.zalp)) ** 2)
        x0 = x0 - f / df
    return x0


def wtauhf(params: pp.PhysParams) -> np.ndarray:
    """Simpson weights ×BETAMAXOXKAPPA2/3 for the tail integral
    (init_x0tauhf.F90:92-100)."""
    const1 = params.betamaxoxkappa2 / 3.0
    w = np.empty(JTOT_TAUHF)
    w[0] = const1
    w[1:-1:2] = 4.0 * const1
    w[2:-1:2] = 2.0 * const1
    w[-1] = const1
    return w
