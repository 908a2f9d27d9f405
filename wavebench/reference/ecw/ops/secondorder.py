"""Second-order spectral correction for output (Janssen 2009, JFM 637).

Port of ``ecwam_tpu/ops/secondorder.py``.  The reference applies a
canonical-transformation second-order correction to the free-wave
spectrum before computing output integrated parameters (outblock.F90:173,
gated by LSECONDORDER which defaults to true, mpuserin.F90:594).  Three
effects are included (tables_2nd.F90:17-30):

  1. generation of second harmonics        (TA/TB "minus/plus" tables)
  2. quasi-linear self-interaction          (TC_QL)
  3. Stokes frequency-shift correction      (TT_4M/TT_4P)

  - The interaction tables (:func:`build_second_order_tables`,
    :class:`SecondOrderTables`) are a host-side numpy precompute over the
    (depth, direction-difference, f1, f0) grid, copied unchanged from the
    reference (tables_2nd.F90:107-186, second_order_lib.F90).
  - The per-point convolution SECSPOM (secspom.F90:150-280) runs in
    PyTorch on the spectrum's device (outside any Pallas kernel in the
    reference too).  The direction-difference index L = K-K1 makes the
    K1 sum a circular correlation; points that share a depth-table row
    contract with its tables as matrix products (:func:`_secspom_row`),
    with no per-point copy of the tables and no (L, K, M1, M) tensor.
    Points run in sub-chunks of ``chunk`` to bound the memory.
  - The correction is output-side only — it never feeds back into the
    prognostic state, matching the reference call site.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from wavebench.reference.ecw.core import constants as c
from wavebench.reference.ecw.core.dispersion import aki
from wavebench.reference.ecw.ops.physics import means

# reference table-dimension defaults (mpuserin.F90:616-618)
NDEPTH = 74
DEPTHA = 1.0
DEPTHD = 1.1

_DEL_OM8 = 1.0e-8            # A1/A3 resonance regularizer (second_order_lib.F90:1046)
_DEL_OM12 = 1.0e-12          # VMIN/VPLUS regularizer (vmin.F90)
_DEL_OM5 = 1.0e-5            # B3/V2 regularizer (second_order_lib.F90:646)
_GAM_B_J = 0.6               # breaking steepness gate (cal_second_order_spec.F90:96)


def _nint(x):
    """Fortran NINT: round half away from zero."""
    return np.where(x >= 0.0, np.floor(x + 0.5), np.ceil(x - 0.5)).astype(np.int64)


# ---------------------------------------------------------------------------
# vectorized interaction coefficients (second_order_lib.F90), NumPy f64.
# Every function broadcasts over arbitrary-shape wavenumber/direction arrays
# for one scalar table depth ``d``.
# ---------------------------------------------------------------------------

def _omeg(x, d):
    """Finite-depth dispersion ω(k) (second_order_lib.F90:1177-1220)."""
    xk = np.abs(x)
    return np.sqrt(c.G * xk * np.tanh(xk * d))


def _vabs(xi, xj, thi, thj):
    """|k_i + k_j| (second_order_lib.F90:1222-1242)."""
    arg = xi**2 + xj**2 + 2.0 * xi * xj * np.cos(thi - thj)
    return np.sqrt(np.maximum(arg, 0.0))


def _vdir(xi, xj, thi, thj):
    """direction of k_i + k_j (second_order_lib.F90:1244-1263)."""
    y = xj * np.sin(thj - thi)
    x = xi + xj * np.cos(thj - thi)
    out = np.arctan2(y, x) + thi
    return np.where(x == 0.0, 0.0, out)


def _vmin(xi, xj, xk, thi, thj, thk, d):
    """Second-order difference coefficient V⁻ (vmin.F90)."""
    zconst = 1.0 / (4.0 * np.sqrt(2.0))
    oi = _omeg(xi, d) + _DEL_OM12
    oj = _omeg(xj, d) + _DEL_OM12
    ok = _omeg(xk, d) + _DEL_OM12
    qi, qj, qk = oi**2 / c.G, oj**2 / c.G, ok**2 / c.G
    rij = xi * xj * np.cos(thj - thi)
    rik = xi * xk * np.cos(thk - thi)
    rjk = xj * xk * np.cos(thk - thj)
    sqijk = np.sqrt(c.G * ok / (oi * oj))
    sqikj = np.sqrt(c.G * oj / (oi * ok))
    sqjki = np.sqrt(c.G * oi / (oj * ok))
    return zconst * ((rij - qi * qj) * sqijk + (rik - qi * qk) * sqikj
                     + (rjk + qj * qk) * sqjki)


def _vplus(xi, xj, xk, thi, thj, thk, d):
    """Second-order sum coefficient V⁺ (vplus.F90)."""
    zconst = 1.0 / (4.0 * np.sqrt(2.0))
    oi = _omeg(xi, d) + _DEL_OM12
    oj = _omeg(xj, d) + _DEL_OM12
    ok = _omeg(xk, d) + _DEL_OM12
    qi, qj, qk = oi**2 / c.G, oj**2 / c.G, ok**2 / c.G
    rij = xi * xj * np.cos(thj - thi)
    rik = xi * xk * np.cos(thk - thi)
    rjk = xj * xk * np.cos(thk - thj)
    sqijk = np.sqrt(c.G * ok / (oi * oj))
    sqikj = np.sqrt(c.G * oj / (oi * ok))
    sqjki = np.sqrt(c.G * oi / (oj * ok))
    return zconst * ((rij + qi * qj) * sqijk + (rik + qi * qk) * sqikj
                     + (rjk + qj * qk) * sqjki)


def _u(xi, xj, xk, xl, thi, thj, thk, thl, d):
    """Third-order four-wave coefficient U (second_order_lib.F90:195-266)."""
    oi, oj = _omeg(xi, d), _omeg(xj, d)
    ok, ol = _omeg(xk, d), _omeg(xl, d)
    oik = _omeg(_vabs(xi, xk, thi, thk), d)
    ojk = _omeg(_vabs(xj, xk, thj, thk), d)
    oil = _omeg(_vabs(xi, xl, thi, thl), d)
    ojl = _omeg(_vabs(xj, xl, thj, thl), d)
    qi, qj = oi**2 / c.G, oj**2 / c.G
    qik, qjk = oik**2 / c.G, ojk**2 / c.G
    qil, qjl = oil**2 / c.G, ojl**2 / c.G
    sqijkl = np.sqrt(ok * ol / (oi * oj))
    return (1.0 / 16.0) * sqijkl * (2.0 * (xi**2 * qj + xj**2 * qi)
                                    - qi * qj * (qik + qjk + qil + qjl))


def _w1(xi, xj, xk, xl, thi, thj, thk, thl, d):
    """Direct four-wave term of type a2·a3·a4 (second_order_lib.F90:466-520)."""
    pi = c.PI
    w = (-_u(xi, xj, xk, xl, thi - pi, thj, thk, thl, d)
         - _u(xi, xk, xj, xl, thi - pi, thk, thj, thl, d)
         - _u(xi, xl, xj, xk, thi - pi, thl, thj, thk, d)
         + _u(xj, xk, xi, xl, thj, thk, thi - pi, thl, d)
         + _u(xj, xl, xi, xk, thj, thl, thi - pi, thk, d)
         + _u(xk, xl, xi, xj, thk, thl, thi - pi, thj, d))
    return w / 3.0


def _w2(xi, xj, xk, xl, thi, thj, thk, thl, d):
    """Direct four-wave term of type a2*·a3·a4 (second_order_lib.F90:273-323)."""
    pi = c.PI
    return (_u(xi, xj, xk, xl, thi - pi, thj - pi, thk, thl, d)
            + _u(xk, xl, xi, xj, thk, thl, thi - pi, thj - pi, d)
            - _u(xk, xj, xi, xl, thk, thj - pi, thi - pi, thl, d)
            - _u(xi, xk, xj, xl, thi - pi, thk, thj - pi, thl, d)
            - _u(xi, xl, xk, xj, thi - pi, thl, thk, thj - pi, d)
            - _u(xl, xj, xk, xi, thl, thj - pi, thk, thi - pi, d))


def _v2(xi, xj, xk, xl, thi, thj, thk, thl, d):
    """Virtual four-wave term V2 (second_order_lib.F90:330-459)."""
    pi = c.PI
    ri = xi + _DEL_OM5
    rj = xj + _DEL_OM5 / 2.0
    rk = xk + _DEL_OM5 / 3.0
    rl = xl + _DEL_OM5 * (1.0 + 1.0 / 2.0 - 1.0 / 3.0)

    oi, oj = _omeg(ri, d), _omeg(rj, d)
    ok, ol = _omeg(rk, d), _omeg(rl, d)

    rij, thij = _vabs(ri, rj, thi, thj), _vdir(ri, rj, thi, thj)
    rik, thik = _vabs(ri, rk, thi, thk - pi), _vdir(ri, rk, thi, thk - pi)
    # NOTE: the reference evaluates THLI with the *unperturbed* wavenumbers
    # (second_order_lib.F90:405 uses XL,XI while RLI uses RL,RI).
    rli = _vabs(rl, ri, thl, thi - pi)
    thli = _vdir(xl, xi, thl, thi - pi)
    rjl, thjl = _vabs(rj, rl, thj, thl - pi), _vdir(rj, rl, thj, thl - pi)
    rjk, thjk = _vabs(rj, rk, thj, thk - pi), _vdir(rj, rk, thj, thk - pi)
    rkl, thkl = _vabs(rk, rl, thk, thl), _vdir(rk, rl, thk, thl)

    oij, oik = _omeg(rij, d), _omeg(rik, d)
    ojl, ojk = _omeg(rjl, d), _omeg(rjk, d)
    oli, okl = _omeg(rli, d), _omeg(rkl, d)

    xnik = ok + oik - oi
    xnjl = oj + ojl - ol
    xnjk = ok + ojk - oj
    xnil = oi + oli - ol
    ynil = ol + oli - oi
    ynjk = oj + ojk - ok
    ynjl = ol + ojl - oj
    ynik = oi + oik - ok
    znij = oij - oi - oj
    znkl = okl - ok - ol
    zpij = oij + oi + oj
    zpkl = okl + ok + ol

    thlj = thjl - pi
    thil = thli - pi
    thkj = thjk - pi
    thki = thik - pi
    thji = thij - pi
    thlk = thkl - pi

    v2 = (_vmin(ri, rk, rik, thi, thk, thik, d)
          * _vmin(rl, rj, rjl, thl, thj, thlj, d) * (1.0 / xnik + 1.0 / xnjl)
          + _vmin(rj, rk, rjk, thj, thk, thjk, d)
          * _vmin(rl, ri, rli, thl, thi, thli, d) * (1.0 / xnjk + 1.0 / xnil)
          + _vmin(ri, rl, rli, thi, thl, thil, d)
          * _vmin(rk, rj, rjk, thk, thj, thkj, d) * (1.0 / ynil + 1.0 / ynjk)
          + _vmin(rj, rl, rjl, thj, thl, thjl, d)
          * _vmin(rk, ri, rik, thk, thi, thki, d) * (1.0 / ynjl + 1.0 / ynik)
          + _vmin(rij, ri, rj, thij, thi, thj, d)
          * _vmin(rkl, rk, rl, thkl, thk, thl, d) * (1.0 / znij + 1.0 / znkl)
          + _vplus(rij, ri, rj, thji, thi, thj, d)
          * _vplus(rkl, rk, rl, thlk, thk, thl, d) * (1.0 / zpij + 1.0 / zpkl))
    return -v2


def _a1(xi, xj, xk, thi, thj, thk, d):
    """a2·a3 canonical weight A1 (second_order_lib.F90:1012-1062)."""
    oi = _omeg(xi, d) + _DEL_OM8
    oj = _omeg(xj, d) + _DEL_OM8
    ok = _omeg(xk, d) + _DEL_OM8
    return -_vmin(xi, xj, xk, thi, thj, thk, d) / (oi - oj - ok)


def _a2(xi, xj, xk, thi, thj, thk, d):
    """A2 = -2·A1 with swapped arguments (second_order_lib.F90:1069-1111)."""
    return -2.0 * _a1(xk, xj, xi, thk, thj, thi, d)


def _a3(xi, xj, xk, thi, thj, thk, d):
    """a2*·a3* canonical weight A3 (second_order_lib.F90:1118-1168)."""
    oi = _omeg(xi, d) + _DEL_OM8
    oj = _omeg(xj, d) + _DEL_OM8
    ok = _omeg(xk, d) + _DEL_OM8
    return -_vplus(xi, xj, xk, thi, thj, thk, d) / (oi + oj + ok)


def _b2(xi, xj, xk, xl, thi, thj, thk, thl, d):
    """a2*·a3·a4 canonical weight B2 (second_order_lib.F90:912-1005)."""
    pi = c.PI
    rij, thij = _vabs(xi, xj, thi, thj), _vdir(xi, xj, thi, thj)
    rik, thik = _vabs(xi, xk, thi, thk - pi), _vdir(xi, xk, thi, thk - pi)
    rki, thki = _vabs(xk, xi, thk, thi - pi), _vdir(xk, xi, thk, thi - pi)
    ril, thil = _vabs(xi, xl, thi, thl - pi), _vdir(xi, xl, thi, thl - pi)
    rli, thli = _vabs(xl, xi, thl, thi - pi), _vdir(xl, xi, thl, thi - pi)
    rjl, thjl = _vabs(xj, xl, thj, thl - pi), _vdir(xj, xl, thj, thl - pi)
    rlj, thlj = _vabs(xl, xj, thl, thj - pi), _vdir(xl, xj, thl, thj - pi)
    rjk, thjk = _vabs(xj, xk, thj, thk - pi), _vdir(xj, xk, thj, thk - pi)
    rkj, thkj = _vabs(xk, xj, thk, thj - pi), _vdir(xk, xj, thk, thj - pi)
    rkl, thkl = _vabs(xk, xl, thk, thl), _vdir(xk, xl, thk, thl)
    return (_a3(xi, xj, rij, thi, thj, thij - pi, d)
            * _a3(xk, xl, rkl, thk, thl, thkl - pi, d)
            + _a1(xj, xk, rjk, thj, thk, thjk, d)
            * _a1(xl, xi, rli, thl, thi, thli, d)
            + _a1(xj, xl, rjl, thj, thl, thjl, d)
            * _a1(xk, xi, rki, thk, thi, thki, d)
            - _a1(rij, xi, xj, thij, thi, thj, d)
            * _a1(rkl, xk, xl, thkl, thk, thl, d)
            - _a1(xi, xk, rik, thi, thk, thik, d)
            * _a1(xl, xj, rlj, thl, thj, thlj, d)
            - _a1(xi, xl, ril, thi, thl, thil, d)
            * _a1(xk, xj, rkj, thk, thj, thkj, d))


def _b3(xi, xj, xk, xl, thi, thj, thk, thl, d):
    """a2*·a3*·a4 canonical weight B3 (second_order_lib.F90:587-699)."""
    pi = c.PI
    oi = _omeg(xi, d) + _DEL_OM5
    oj = _omeg(xj, d) + _DEL_OM5
    ok = _omeg(xk, d) + _DEL_OM5
    ol = _omeg(xl, d) + _DEL_OM5

    rij, thij = _vabs(xi, xj, thi, thj), _vdir(xi, xj, thi, thj)
    rji, thji = _vabs(xj, xi, thj, thi), _vdir(xj, xi, thj, thi)
    rik, thik = _vabs(xi, xk, thi, thk), _vdir(xi, xk, thi, thk)
    rki, thki = _vabs(xk, xi, thk, thi), _vdir(xk, xi, thk, thi)
    rlj, thlj = _vabs(xl, xj, thl, thj - pi), _vdir(xl, xj, thl, thj - pi)
    rjl, thjl = _vabs(xj, xl, thj, thl - pi), _vdir(xj, xl, thj, thl - pi)
    rjk, thjk = _vabs(xj, xk, thj, thk), _vdir(xj, xk, thj, thk)
    rkj, thkj = _vabs(xk, xj, thk, thj), _vdir(xk, xj, thk, thj)
    rli, thli = _vabs(xl, xi, thl, thi - pi), _vdir(xl, xi, thl, thi - pi)
    ril, thil = _vabs(xi, xl, thi, thl - pi), _vdir(xi, xl, thi, thl - pi)
    rlk, thlk = _vabs(xl, xk, thl, thk - pi), _vdir(xl, xk, thl, thk - pi)
    rkl, thkl = _vabs(xk, xl, thk, thl - pi), _vdir(xk, xl, thk, thl - pi)

    zijkl = oi + oj + ok - ol
    return (-1.0 / zijkl) * (
        2.0 * (_vmin(xl, xi, rli, thl, thi, thli, d)
               * _a1(rjk, xj, xk, thjk, thj, thk, d)
               - _vmin(rij, xi, xj, thij, thi, thj, d)
               * _a1(xl, xk, rlk, thl, thk, thlk, d)
               - _vmin(rik, xi, xk, thik, thi, thk, d)
               * _a1(xl, xj, rlj, thl, thj, thlj, d)
               - _vplus(xj, xi, rji, thj, thi, thji - pi, d)
               * _a1(xk, xl, rkl, thk, thl, thkl, d)
               - _vplus(xk, xi, rki, thk, thi, thki - pi, d)
               * _a1(xj, xl, rjl, thj, thl, thjl, d)
               + _vmin(xi, xl, ril, thi, thl, thil, d)
               * _a3(xj, xk, rjk, thj, thk, thjk - pi, d))
        + 3.0 * _w1(xl, xk, xj, xi, thl, thk, thj, thi, d))


def _coef_a(xi, xj, thi, thj, d):
    """Minus-interaction coefficient A (second_order_lib.F90:15-74)."""
    pi = c.PI
    rk = _vabs(xi, xj, thi, thj)
    thk = _vdir(xi, xj, thi, thj)
    oi, oj, ok = _omeg(xi, d), _omeg(xj, d), _omeg(rk, d)
    fi = np.sqrt(oi / (2.0 * c.G))
    fj = np.sqrt(oj / (2.0 * c.G))
    fk = np.sqrt(ok / (2.0 * c.G))
    return fk / (fi * fj) * (_a1(rk, xi, xj, thk, thi, thj, d)
                             + _a3(rk, xi, xj, thk - pi, thi, thj, d))


def _coef_b(xi, xj, thi, thj, d):
    """Plus-interaction coefficient B (second_order_lib.F90:79-137)."""
    pi = c.PI
    rk = _vabs(xj, xi, thj, thi - pi)
    thk = _vdir(xj, xi, thj, thi - pi)
    oi, oj, ok = _omeg(xi, d), _omeg(xj, d), _omeg(rk, d)
    fi = np.sqrt(oi / (2.0 * c.G))
    fj = np.sqrt(oj / (2.0 * c.G))
    fk = np.sqrt(ok / (2.0 * c.G))
    return 0.5 * fk / (fi * fj) * (_a2(rk, xi, xj, thk, thi, thj, d)
                                   + _a2(rk, xj, xi, thk - pi, thj, thi, d))


def _coef_cql(xk0, xk1, th0, th1, d):
    """Quasi-linear coefficient C_QL (second_order_lib.F90:144-188)."""
    pi = c.PI
    om1 = _omeg(xk1, d)
    f1 = np.sqrt(om1 / (2.0 * c.G))
    return (2.0 / f1**2) * (_b2(xk0, xk1, xk1, xk0, th0, th1, th1, th0, d)
                            + _b3(xk0, xk0, xk1, xk1, th0 - pi, th0, th1, th1, d))


# ---------------------------------------------------------------------------
# table container + construction (secondhh_gen.F90 / tables_2nd.F90)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SecondOrderTables:
    """Precomputed interaction tables on the thinned spectral grid."""

    nang_h: int                  # NANGH = nang // ma
    nfre_h: int                  # NFREH = nfre // mr
    mr: int                      # frequency thinning factor
    ma: int                      # direction thinning factor
    nmax: int                    # extended (thinned) frequency count
    ndepth: int
    deptha: float
    depthd: float

    omega_h: np.ndarray          # (nfre_h,) thinned angular frequencies
    omega_ext: np.ndarray        # (nmax,) incl. diagnostic-tail extension
    dfdth: np.ndarray            # (nfre_h,) Δω·Δθ/2π weight
    thh: np.ndarray              # (nang_h,) thinned directions

    # interaction tables, (ndepth, nang_h, nfre_h, nfre_h):
    ta: np.ndarray               # minus interactions
    tb: np.ndarray               # plus interactions
    tc_ql: np.ndarray            # quasi-linear
    tt_4m: np.ndarray            # Stokes shift (minus side)
    tt_4p: np.ndarray            # Stokes shift (plus side)

    im_p: np.ndarray             # (nfre_h, nfre_h) 0-based ω0+ω1 bin index
    im_m: np.ndarray             # (nfre_h, nfre_h) 0-based ω0-ω1 bin index
    mask_a: np.ndarray           # (nfre_h, nfre_h) bool: ω1 < ω0/2

    # thin/interp maps between the full and the half-resolution grids
    k_half: np.ndarray           # (nang_h,) full-grid direction of half bin
    m_half: np.ndarray           # (nfre_h,) full-grid frequency of half bin
    m0_idx: np.ndarray           # (nfre,) bilinear-interp lower freq bin
    mp_idx: np.ndarray
    d1: np.ndarray               # (nfre,) upper-freq interp weight
    k0_idx: np.ndarray           # (nang,) lower direction bin
    kp_idx: np.ndarray
    d3: np.ndarray               # (nang,) upper-direction interp weight


def build_second_order_tables(tb, *, ndepth: int = NDEPTH,
                              deptha: float = DEPTHA,
                              depthd: float = DEPTHD) -> SecondOrderTables:
    """Build all second-order tables from the spectral tables.

    Re-derives SECONDHH_GEN (secondhh_gen.F90:70-125) + TABLES_2ND
    (tables_2nd.F90:107-186) as one broadcasted NumPy computation per
    depth-table entry; the reference's NFREH=NFRE/2, NANGH=NANG/2
    thinning is kept.
    """
    nang, nfre = tb.nang, tb.nfre
    nfre_h = nfre // 2
    nang_h = nang // 2
    mr = nfre // nfre_h
    ma = nang // nang_h

    frac = tb.fratio - 1.0
    omstart = c.ZPI * tb.fr[0]
    delthh = ma * tb.delth

    # thinned grids (secondhh_gen.F90:88-99): OMEGA(M)=2π·FR(MR·M),
    # THH(K)=TH(MA·K+1 wrapped); 0-based below.
    m_half = (mr * np.arange(1, nfre_h + 1)) - 1
    omega_h = c.ZPI * tb.fr[m_half]
    k_half = (ma * np.arange(1, nang_h + 1)) % nang
    thh = tb.th[k_half]

    co1 = 0.5 * delthh / c.ZPI
    dfdth = np.empty(nfre_h)
    dfdth[0] = co1 * (omega_h[1] - omega_h[0])
    dfdth[1:-1] = co1 * (omega_h[2:] - omega_h[:-2])
    dfdth[-1] = co1 * (omega_h[-1] - omega_h[-2])

    xmr = 1.0 / mr
    nmax = int(1 + xmr * (1 + _nint(
        np.log(2.0 * omega_h[-1] / omstart) / np.log(1.0 + frac))))

    # extended thinned frequency axis (secspom.F90:155-160)
    omega_ext = np.empty(nmax)
    omega_ext[:nfre_h] = omega_h
    m_ext = np.arange(nfre_h + 1, nmax + 1)
    omega_ext[nfre_h:] = omstart * (1.0 + frac) ** (mr * m_ext - 1)

    # broadcast axes: [L, M1, M] with L the direction difference
    th1c = thh[-1]                                 # TH(NANG) in tables_2nd
    th0 = thh[:, None, None]                       # TH(L)
    om1 = omega_h[None, :, None]
    om0 = omega_h[None, None, :]

    mp_h = np.minimum(np.arange(nfre_h) + 1, nfre_h - 1)
    mm_h = np.maximum(np.arange(nfre_h) - 1, 0)
    om0p = omega_h[mp_h][None, None, :]
    om0m = omega_h[mm_h][None, None, :]

    mask_a = (np.abs(om1) < 0.5 * om0)[0]          # (nfre_h, nfre_h)

    # frequency-bin maps (depth-independent, tables_2nd.F90:146-161)
    om2_m = np.where(mask_a, om0[0] - om1[0], 1.0)
    xm2_m = np.log(om2_m / omstart) / np.log(1.0 + frac)
    im_m = np.where(mask_a, _nint(xmr * (xm2_m + 1.0)), 1)
    im_m = np.clip(im_m, 1, nmax) - 1              # → 0-based
    om2_p = om1[0] + om0[0]
    xm2_p = np.log(om2_p / omstart) / np.log(1.0 + frac)
    im_p = np.clip(_nint(xmr * (xm2_p + 1.0)), 1, nmax) - 1

    shape = (ndepth, nang_h, nfre_h, nfre_h)
    ta = np.zeros(shape)
    tb_ = np.zeros(shape)
    tc_ql = np.zeros(shape)
    tt_4m = np.zeros(shape)
    tt_4p = np.zeros(shape)

    for jd in range(ndepth):
        d = deptha * depthd**jd
        tfak = aki(omega_h, np.full_like(omega_h, d))
        xk0 = tfak[None, None, :]
        xk1 = tfak[None, :, None]
        xk0p = tfak[mp_h][None, None, :]
        xk0m = tfak[mm_h][None, None, :]

        # minus interactions: ω2 = ω0-ω1 where ω1 < ω0/2
        xk2_m = np.where(mask_a, aki(np.maximum(om2_m, 1e-10), d), 1.0)
        a_co = _coef_a(xk1, xk2_m[None], th1c, th0, d)
        ta[jd] = np.where(mask_a, dfdth[None, :, None] * a_co**2, 0.0)

        # plus interactions: ω2 = ω0+ω1
        xk2_p = aki(om2_p, d)
        b_co = _coef_b(xk1, xk2_p[None], th1c, th0, d)
        tb_[jd] = dfdth[None, :, None] * b_co**2

        # quasi-linear
        tc_ql[jd] = dfdth[None, :, None] * _coef_cql(xk0, xk1, th0, th1c, d)

        # Stokes frequency shift
        fac = 2.0 * c.G / om1 * dfdth[None, :, None]
        tt_4m[jd] = fac * (_w2(xk0m, xk1, xk1, xk0m, th0, th1c, th1c, th0, d)
                           + _v2(xk0m, xk1, xk1, xk0m, th0, th1c, th1c, th0, d))
        tt_4p[jd] = fac * (_w2(xk0p, xk1, xk1, xk0p, th0, th1c, th1c, th0, d)
                           + _v2(xk0p, xk1, xk1, xk0p, th0, th1c, th1c, th0, d))

    # bilinear interp maps half grid → full grid
    # (cal_second_order_spec.F90:158-185), all static, 0-based
    m0_idx = np.empty(nfre, dtype=np.int64)
    mp_idx = np.empty(nfre, dtype=np.int64)
    d1 = np.empty(nfre)
    for m1b in range(1, nfre + 1):
        m0 = m1b // mr
        if m0 < 1:
            m0, mp, dd1 = 1, 2, 1.0
        elif m0 < nfre_h:
            mp = m0 + 1
            dd1 = ((tb.fr[m1b - 1] - tb.fr[mr * m0 - 1])
                   / (tb.fr[mr * mp - 1] - tb.fr[mr * m0 - 1]))
        else:
            m0 = mp = nfre_h
            dd1 = 0.0
        m0_idx[m1b - 1], mp_idx[m1b - 1], d1[m1b - 1] = m0 - 1, mp - 1, dd1

    k0_idx = np.empty(nang, dtype=np.int64)
    kp_idx = np.empty(nang, dtype=np.int64)
    d3 = np.empty(nang)
    for k1b in range(1, nang + 1):
        xk = float((k1b - 1) // ma)
        k0 = int(xk)
        dd3 = (k1b - 1) / ma - xk
        if k0 < 1:
            k0 += nang_h
        kp = k0 + 1
        if kp > nang_h:
            kp -= nang_h
        k0_idx[k1b - 1], kp_idx[k1b - 1], d3[k1b - 1] = k0 - 1, kp - 1, dd3

    return SecondOrderTables(
        nang_h=nang_h, nfre_h=nfre_h, mr=mr, ma=ma, nmax=nmax,
        ndepth=ndepth, deptha=deptha, depthd=depthd,
        omega_h=omega_h, omega_ext=omega_ext, dfdth=dfdth, thh=thh,
        ta=ta, tb=tb_, tc_ql=tc_ql, tt_4m=tt_4m, tt_4p=tt_4p,
        im_p=im_p, im_m=im_m, mask_a=mask_a,
        k_half=k_half, m_half=m_half,
        m0_idx=m0_idx, mp_idx=mp_idx, d1=d1,
        k0_idx=k0_idx, kp_idx=kp_idx, d3=d3)


# ---------------------------------------------------------------------------
# device-side correction (secspom.F90 + cal_second_order_spec.F90), PyTorch
# ---------------------------------------------------------------------------

# points per SECSPOM sub-chunk: per point the rolled spectrum, the TB/TA
# correlations, the two second factors and the TA circulant product take
# about 12·nang_h·nfre_h² floats (280 KB at 36×36 in float32)
SECSPOM_CHUNK = 16384


def _circulant(ta: np.ndarray, n: int) -> np.ndarray:
    """TA as circulant matrices, (ndepth, nfre_h·nfre_h, n, n):
    C[·, a·m, k, k1] = TA[·, (k-k1-1) mod n, a, m]."""
    k = np.arange(n)
    ll = (k[:, None] - k[None, :] - 1) % n                  # (k, k1)
    c = ta[:, ll]                                 # (nd, k, k1, a, m)
    nd, _, _, na, nm = c.shape
    return c.transpose(0, 3, 4, 1, 2).reshape(nd, na * nm, n, n)


def device_tables(so: SecondOrderTables, like: torch.Tensor) -> dict:
    """The interaction tables as tensors of ``like``'s dtype and device,
    laid out for SECSPOM's matrix products, per depth row: ``tq``
    (ndepth, nang_h·nfre_h, 3·nfre_h) holds TC_QL, TT_4P and TT_4M over
    (L, M1) against (table, M); ``tba`` (ndepth, nfre_h, nang_h,
    2·nfre_h) TB and TA over M1, L against (table, M); ``circ`` TA as
    circulants (:func:`_circulant`); plus the TA mask and the index maps."""
    def t(a, dtype=like.dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=like.device)
    nd, n, nf = so.ndepth, so.nang_h, so.nfre_h
    tq = np.stack([so.tc_ql, so.tt_4p, so.tt_4m], axis=3)  # (nd,l,a,3,m)
    tba = np.stack([so.tb, so.ta], axis=3).transpose(0, 2, 1, 3, 4)
    return dict(
        tq=t(tq.reshape(nd, n * nf, 3 * nf)),
        tba=t(tba.reshape(nd, nf, n, 2 * nf)),
        circ=t(_circulant(so.ta, n)),
        mask=t(so.mask_a), im_p=t(so.im_p, torch.int64),
        im_m=t(so.im_m, torch.int64))


def _secspom_row(f2p, f2h, df2kp, df2km, j: int, tabs: dict):
    """SECSPOM's sum (secspom.F90:190-275) for points sharing depth row
    ``j``: f2p (p, k, nmax), f2h (p, k, m), df2kp/df2km (p, k, m).

    With the direction difference L = K-K1, each table's K1 sum is a
    circular correlation of F2 over K: F2 rolled, F2R[p,k,l,a] =
    F2[p,(k-l-1) mod n,a], contracts with the tables as matrix products.
    The TC_QL and TT_4± terms need only their sum over M1, one product
    over (L, M1); TB and TA keep M1 for their second factors, one product
    per M1; TA's second half correlates F2 at the ω0-ω1 bins over K, one
    circulant product per (M1, M).  Returns (p, k, m)."""
    P, n, nf = f2h.shape
    ll = (torch.arange(n, device=f2h.device)[:, None]
          - torch.arange(n, device=f2h.device)[None, :] - 1) % n   # (k, l)
    f2r = f2h[:, ll, :]                                 # (p, k, l, a)
    g = (f2r.reshape(P * n, n * nf) @ tabs["tq"][j]).reshape(P, n, 3, nf)
    s = torch.bmm(f2r.permute(3, 0, 1, 2).reshape(nf, P * n, n),
                  tabs["tba"][j]).reshape(nf, P, n, 2, nf)   # (a,p,k,2,m)
    del f2r
    f2_p2 = f2p[:, :, tabs["im_p"]]                     # (p, k, a, m)
    f2_m2 = f2p[:, :, tabs["im_m"]]
    mask = tabs["mask"]

    psum = torch.einsum("apkm,pkam->pkm", s[:, :, :, 0], 2.0 * f2_p2)
    psum = psum + g[:, :, 0] * f2h
    psum = psum - g[:, :, 1] * df2kp
    psum = psum + g[:, :, 2] * df2km
    # TA term: Σ TA·(F2[k1,m1]·F2[k,m2m] + F2[k,m1]·F2[k1,m2m])
    psum = psum + torch.einsum("apkm,pkam,am->pkm", s[:, :, :, 1], f2_m2,
                               mask)
    del s, f2_p2
    x = f2_m2.permute(2, 3, 1, 0).reshape(nf * nf, n, P)  # (a·m, k1, p)
    s_ta_m2 = torch.bmm(tabs["circ"][j], x).reshape(nf, nf, n, P)
    return psum + torch.einsum("amkp,pka,am->pkm", s_ta_m2, f2h, mask)


def _secspom_points(f1h, jd, so: SecondOrderTables, tabs: dict):
    """SECSPOM on a block of points: f1h (nang_h, nfre_h, n), jd (n,)
    0-based depth rows; the points are grouped by depth row, each group
    contracting with its row's tables.  Returns (nang_h, nfre_h, n)."""
    nang_h, nfre_h, npts = f1h.shape
    nmax = so.nmax

    # extend with the ω^-5 diagnostic tail (secspom.F90:154-164)
    omrt = torch.as_tensor(
        (so.omega_h[-1] ** 5) / so.omega_ext[nfre_h:] ** 5,
        dtype=f1h.dtype, device=f1h.device)
    tail = omrt[None, :, None] * f1h[:, -1:, :]
    f2p = torch.cat([f1h, tail], dim=1).permute(2, 0, 1)   # (p, k, nmax)

    # df/dω one-sided stencil factors (secspom.F90:176-188)
    mp_h = np.minimum(np.arange(nfre_h) + 1, nmax - 1)
    mm_h = np.maximum(np.arange(nfre_h) - 1, 0)
    delm1 = torch.as_tensor(1.0 / (so.omega_ext[mp_h] - so.omega_ext[mm_h]),
                            dtype=f1h.dtype, device=f1h.device)
    df2kp = f2p[:, :, mp_h] * delm1                    # (p, k, m)
    df2km = f2p[:, :, mm_h] * delm1
    f2h = f2p[:, :, :nfre_h].contiguous()              # (p, k, m)

    rows = torch.unique(jd).tolist()
    if len(rows) == 1:
        psum = _secspom_row(f2p, f2h, df2kp, df2km, rows[0], tabs)
    else:
        psum = torch.empty_like(f2h)
        for j in rows:
            sel = torch.nonzero(jd == j).squeeze(1)
            psum[sel] = _secspom_row(f2p[sel], f2h[sel], df2kp[sel],
                                     df2km[sel], j, tabs)
    return psum.permute(1, 2, 0)                       # (k, m, p)


def depth_rows(depth, akmean, so: SecondOrderTables):
    """Per-point 0-based depth-table row (secspom.F90:40-49)."""
    xd = torch.maximum(1.0 / akmean, depth)
    xd = torch.log(xd / so.deptha) / np.log(so.depthd) + 1.0
    return (torch.clamp(torch.round(xd), 1, so.ndepth) - 1).to(torch.int64)


def secspom(f1h, depth, akmean, so: SecondOrderTables, *,
            tabs: dict | None = None, chunk: int = SECSPOM_CHUNK):
    """Second-order source F3 on the thinned grid (secspom.F90:150-280).

    ``f1h``: (nang_h, nfre_h, npts) thinned spectrum; ``depth``,
    ``akmean``: (npts,).  Returns F3 of the same shape.  ``tabs`` from
    :func:`device_tables` (built here if None); points run in sub-chunks
    of ``chunk``.
    """
    if tabs is None:
        tabs = device_tables(so, f1h)
    jd = depth_rows(depth, akmean, so)
    npts = f1h.shape[2]
    if npts <= chunk:
        return _secspom_points(f1h, jd, so, tabs)
    return torch.cat([_secspom_points(f1h[..., s:s + chunk],
                                      jd[s:s + chunk], so, tabs)
                      for s in range(0, npts, chunk)], dim=2)


def cal_second_order_spec(fl1, wavnum, depth, tb, so: SecondOrderTables,
                          sig: float = 1.0, *, tabs: dict | None = None,
                          chunk: int = SECSPOM_CHUNK):
    """Apply the second-order correction to a spectrum for output.

    Mirrors CAL_SECOND_ORDER_SPEC (cal_second_order_spec.F90:93-190):
    thin the spectrum to the half grid, evaluate SECSPOM, bilinearly
    interpolate the correction back, gate by the breaking-steepness
    criterion, and clamp so the corrected spectrum never drops below
    min(1e-6, F1).  ``sig``=+1 forward, -1 inverse mapping.

    fl1: (nang, nfre, npts); wavnum: (nfre, npts); depth: (npts,).
    """
    emean, _, _, akmean, _ = means.fkmean(fl1, wavnum, tb)
    lo = torch.clamp(fl1, max=1e-6)

    if so.mr == 1 and so.ma == 1:
        f3 = secspom(fl1, depth, akmean, so, tabs=tabs, chunk=chunk)
        return torch.maximum(lo, fl1 + sig * f3)

    # thin (cal_second_order_spec.F90:130-141)
    pf1 = fl1[so.k_half][:, so.m_half]
    pf3 = secspom(pf1, depth, akmean, so, tabs=tabs, chunk=chunk)

    # breaking-steepness gate (cal_second_order_spec.F90:152-158)
    zfac = _GAM_B_J**2 / 16.0
    emaxl = (emean <= zfac * depth**2).to(fl1.dtype)

    # bilinear interpolation back to the full grid (":158-185")
    p_k0 = pf3[so.k0_idx]                    # (nang, nfre_h, npts)
    p_kp = pf3[so.kp_idx]
    d3 = torch.as_tensor(so.d3, dtype=fl1.dtype,
                         device=fl1.device)[:, None, None]
    d4 = 1.0 - d3
    c1 = p_k0[:, so.m0_idx] * d4 + p_kp[:, so.m0_idx] * d3
    c2 = p_kp[:, so.mp_idx] * d3 + p_k0[:, so.mp_idx] * d4
    d1 = torch.as_tensor(so.d1, dtype=fl1.dtype,
                         device=fl1.device)[None, :, None]
    delf = c1 * (1.0 - d1) + c2 * d1

    corr = emaxl[None, None, :] * sig * delf
    return torch.maximum(lo, fl1 + corr)
