"""Freak-wave / extreme-sea-state diagnostics (the KURTOSIS chain).

Port of ``ecwam_tpu/io/extremes.py``, the envelope-statistics output path:
  - peak_ang   L-H spectral width and angular width at the peak
               (peak_ang.F90:74-180)
  - transf_r   narrow-band R transfer function   (transf_r.F90:49-74)
  - transf_bfi shallow-water BFI² transfer       (transf_bfi.F90:53-91)
  - stat_nl    skewness C3 / kurtosis C4 (bound + dynamic NLS part),
               wave-induced mean sea level       (stat_nl.F90:86-180)
  - h_max      expected maximum envelope wave height from the stretched
               exponential distribution          (h_max.F90:90-130)
  - kurtosis   driver producing C3, C4, BFI², QP (Goda peakedness),
               HMAX, TMAX, ETA_M, R, XNSLC, SIG_TH, EPS, XNU
               (kurtosis.F90:250-400)

In the reference these run outside any Pallas kernel, so they are plain
PyTorch here.  All functions take fl1 (nang, nfre, npts) and return
(npts,) tensors; every loop has a fixed trip count and no branch
depends on the data.

Decision edges: ``peak_ang``'s argmax, ``kurtosis``'s ``ff > 0.4·ffmax``
and ``round(1200·om_up)`` and the clips of ``transf_bfi`` and
``stat_nl`` may fall the other way on a last-bit change of the
spectrum; :func:`kurtosis_margins` gives each point's distance from
them.
"""

from __future__ import annotations

import numpy as np
import torch

from wavebench.reference.ecw.core import constants as c
from wavebench.reference.ecw.core import spectral as sp
from wavebench.reference.ecw.ops.physics import const

XKDMIN = 0.75          # min k·d for the freak-wave nonlinear terms (yowshal.F90:23)
BATHYMAX = 998.999
EPS32 = 10.0 * float(np.finfo(np.float32).eps)


def _eps(like):
    """10·ε(float32) as a 0-d tensor of ``like``'s dtype, as the
    reference forms it."""
    return torch.tensor(EPS32, dtype=like.dtype, device=like.device)


def aki_newton(om, depth, n_iter: int = 30):
    """Wave number from ω² = g·k·tanh(kd) — fixed-trip Newton
    (aki.F90:28-47), the reference's ``aki_jax``."""
    akm1 = om**2 / (4.0 * c.G)
    akm2 = om / (2.0 * torch.sqrt(c.G * torch.clamp(depth, min=1e-6)))
    ao = torch.maximum(akm1, akm2)
    deep = depth * ao > c.DKMAX
    ak = ao
    for _ in range(n_iter):
        bo = torch.clamp(depth * ak, max=c.DKMAX)
        th = c.G * ak * torch.tanh(bo)
        sth = torch.sqrt(th)
        ak = ak + (om - sth) * sth * 2.0 / (
            th / ak + c.G * bo / torch.cosh(bo) ** 2)
    return torch.where(deep, om**2 / c.G, ak)


def _group_velocity(x, c0):
    """V_g with the deep (x>DKMAX) and shallow (x→0) limits (transf_r.F90:58-66)."""
    xs = torch.clamp(x, 1e-4, c.DKMAX)
    vg = 0.5 * c0 * (1.0 + 2.0 * xs / torch.sinh(2.0 * xs))
    vg = torch.where(x < 1e-4, c0, vg)
    return torch.where(x > c.DKMAX, 0.5 * c0, vg)


def _moments(fl1, tb, eps):
    """ff = Σ_θ F, and its tail-corrected moments sum0..sum2."""
    ff = torch.sum(fl1, dim=0)                     # (nfre, npts)
    last = ff[-1]
    sum0 = eps + torch.sum(ff * const(tb.dfim, fl1)[:, None], dim=0)
    sum1 = torch.sum(ff * const(tb.dfimfr, fl1)[:, None], dim=0)
    sum2 = torch.sum(ff * const(tb.dfimfr2, fl1)[:, None], dim=0)
    sum0 = sum0 + sp.WETAIL * tb.fr[-1] * tb.delth * last
    sum1 = sum1 + sp.WP1TAIL * tb.delth * tb.fr[-1] ** 2 * last
    sum2 = sum2 + sp.WP2TAIL * tb.delth * tb.fr[-1] ** 3 * last
    return ff, sum0, sum1, sum2


def _peak_window(fl1, tb):
    """Interior 2-D maximum's frequency mmax and the window mmax±nsh
    (peak_ang.F90:133-147)."""
    nang, nfre, npts = fl1.shape
    nsh = 1 + int(np.log(1.5) / np.log(tb.fratio))
    interior = fl1[:, 1:nfre - 1]
    mmax = 1 + torch.argmax(torch.amax(interior, dim=0), dim=0)   # (npts,)
    m_idx = torch.arange(nfre, device=fl1.device)[:, None]
    in_win = ((m_idx >= torch.clamp(mmax - nsh, min=0)[None, :])
              & (m_idx <= torch.clamp(mmax + nsh, max=nfre - 1)[None, :]))
    return mmax, in_win


def peak_ang(fl1, tb):
    """Frequency width XNU and angular width SIG_TH (peak_ang.F90:74-180)."""
    eps = _eps(fl1)
    _, sum0, sum1, sum2 = _moments(fl1, tb, eps)
    xnu = torch.where(
        sum0 > eps,
        torch.sqrt(torch.maximum(eps, sum2 * sum0 / sum1**2 - 1.0)), eps)

    _, in_win = _peak_window(fl1, tb)
    win = torch.where(in_win[None, :, :], fl1, torch.zeros_like(fl1))
    sinth = const(tb.sinth, fl1)[:, None, None]
    costh = const(tb.costh, fl1)[:, None, None]
    sum_s = torch.sum(win * sinth, dim=(0, 1))
    sum_c = eps + torch.sum(win * costh, dim=(0, 1))
    thmean = torch.atan2(sum_s, sum_c)
    th = const(tb.th, fl1)[:, None, None]
    w = win * const(tb.dfim, fl1)[None, :, None]
    sum1w = eps + torch.sum(w, dim=(0, 1))
    sum2w = torch.sum(torch.cos(th - thmean[None, None, :]) * w, dim=(0, 1))
    r1 = sum2w / sum1w
    sig_th = torch.where(
        sum1w > eps, torch.sqrt(torch.clamp(2.0 * (1.0 - r1), min=0.0)),
        torch.zeros_like(r1))
    return xnu, sig_th


def _shallow_terms(xk0, d):
    """k, k·d, tanh, ω, c, cg and the D2OM denominator shared by the
    transfer functions (transf_r.F90:49-66)."""
    xk = torch.maximum(xk0, XKDMIN / torch.clamp(d, min=1e-6))
    x = torch.clamp(xk * d, 1e-4, c.DKMAX)
    t0 = torch.tanh(x)
    t0_sq = t0**2
    om = torch.sqrt(c.G * xk * t0)
    c0 = om / xk
    vg = _group_velocity(x, c0)
    d2om = (t0 - x * (1.0 - t0_sq)) ** 2 + 4.0 * x**2 * t0_sq * (1.0 - t0_sq)
    return xk, x, t0, t0_sq, om, c0, vg, d2om


def _shallow_ok(xk0, d):
    return (d < BATHYMAX) & (d > 0.0) & (xk0 > 0.0) & (xk0 * d <= c.DKMAX)


def transf_r(xk0, d):
    """Narrow-band R transfer function (transf_r.F90:49-74)."""
    _, _, t0, t0_sq, _, c0, vg, d2om = _shallow_terms(xk0, d)
    val = 4.0 * (vg / c0) ** 3 * t0_sq / torch.clamp(d2om, min=1e-12)
    return torch.where(_shallow_ok(xk0, d), val, torch.full_like(val, 0.5))


def _transf_bfi_raw(xk0, d, xnu, sig_th):
    """TRANSF_BFI before its clip to ±4."""
    _, x, t0, t0_sq, _, c0, vg, d2om = _shallow_terms(xk0, d)
    cs_sq = c.G * d
    vg_sq = vg**2
    guard = torch.clamp(cs_sq - vg_sq, min=1e-8)
    xnl_1 = (9.0 * t0_sq**2 - 10.0 * t0_sq + 9.0) / (8.0 * t0_sq * t0)
    xnl_2 = ((2.0 * vg - 0.5 * c0) ** 2 / guard + 1.0) / x
    xnl_4 = 1.0 / (4.0 * t0) * (2.0 * c0 + vg * (1.0 - t0_sq)) ** 2 / guard
    alp = (1.0 - vg_sq / torch.clamp(cs_sq, min=1e-8)) * c0**2 / vg_sq
    zfac = sig_th**2 / torch.clamp(sig_th**2 + alp * xnu**2, min=1e-12)
    t_nl = xnl_1 - xnl_2 + zfac * xnl_4
    return 4.0 * (vg / c0) ** 2 * t_nl * t0 / torch.clamp(d2om, min=1e-12)


def transf_bfi(xk0, d, xnu, sig_th):
    """Shallow-water BFI² transfer function (transf_bfi.F90:53-91)."""
    val = torch.clamp(_transf_bfi_raw(xk0, d, xnu, sig_th), -4.0, 4.0)
    return torch.where(_shallow_ok(xk0, d), val, torch.ones_like(val))


def _stat_nl_raw(xm0, xk0, bf2, xnu, sig_th, depth):
    """STAT_NL's quantities before their clips: (c3, c4, eta_m, r, c4_b,
    c4_dyn) with c3, c4 and r unclipped."""
    eps = _eps(xm0)
    c4_const = 0.9 * c.PI / (3.0 * np.sqrt(3.0))
    zc1 = 4.0 * np.sqrt(3.0) / c.PI
    zc2 = 1.0 / 3.0 + 2.0 * np.sqrt(3.0) / c.PI
    zc3 = 2.0 * np.sqrt(3.0) / c.PI - 4.0 / 3.0

    transf = transf_r(xk0, depth)
    xk, x, t0, t0_sq, om, c0, vg, _ = _shallow_terms(xk0, depth)
    alph = xk / (4.0 * t0_sq * t0) * (3.0 - t0_sq)
    gam = -0.5 * alph**2
    cs_sq = c.G * depth
    vg_sq = vg**2
    guard = torch.clamp(cs_sq - vg_sq, min=1e-8)

    zfac = -0.25 * xk * cs_sq / guard
    delta_1d = zfac * (2.0 * (1.0 - t0_sq) / t0 + 1.0 / x)
    zfac1 = 0.5 * c0 * cs_sq * vg / t0
    xkappa1 = zfac1 * (2.0 * c0 + vg * (1.0 - t0_sq)) / guard
    alpha = (1.0 - vg_sq / torch.clamp(cs_sq, min=1e-8)) * c0**2 / vg_sq
    zfac2 = sig_th**2 / torch.clamp(sig_th**2 + alpha * xnu**2, min=1e-12)
    delta_2d = (0.5 * xk**2 * xkappa1 / (om * torch.clamp(cs_sq, min=1e-8))
                * zfac2)
    delta = delta_1d + delta_2d

    eta_m = 2.0 * xm0 * delta
    c3 = (1.12 * 2.0 * torch.sqrt(torch.clamp(xm0, min=0.0))
          * (alph + 0.9 * delta))
    c4_b = 0.93 * 8.0 * xm0 * (gam + alph**2 + (alph + delta) ** 2)

    r = transf * (sig_th / torch.maximum(xnu, eps)) ** 2
    zr = torch.maximum(torch.clamp(r, 0.0, 16.0), eps)
    xj_hi = -c4_const / zr * (1.0 - zc1 / torch.sqrt(zr) + zc2 / zr
                              + zc3 / zr**2)
    xj_lo = c4_const * (1.0 - zc1 * torch.sqrt(zr) + zc2 * zr + zc3 * zr**2)
    xj = torch.where(zr > 1.0, xj_hi, xj_lo)
    c4_dyn = xj * bf2
    return c3, c4_dyn + c4_b, eta_m, r, c4_b, c4_dyn


def stat_nl(xm0, xk0, bf2, xnu, sig_th, depth):
    """Skewness C3 & kurtosis C4 (bound + dynamic), mean sea level
    (stat_nl.F90:86-180)."""
    c3, c4, eta_m, r, c4_b, c4_dyn = _stat_nl_raw(xm0, xk0, bf2, xnu,
                                                  sig_th, depth)
    c3 = torch.clamp(c3, 0.0, 0.25)
    c4 = torch.clamp(c4, -0.25, 0.25)
    r = torch.clamp(r, 0.0, 16.0)
    valid = (xm0 > _eps(xm0)) & (depth > 0.0) & (xk0 > 0.0)
    zero = torch.zeros_like(xm0)
    return tuple(torch.where(valid, v, zero)
                 for v in (c3, c4, eta_m, r, c4_b, c4_dyn))


def h_max(c3, c4, xnslc):
    """Expected max envelope height / its width from the stretched
    exponential distribution (h_max.F90:90-130). Returns (aa, bb, hmaxn,
    sig_hm)."""
    eps = _eps(c3)
    gam = 0.5772
    twog1 = -2.0 * gam
    g2 = gam**2 + c.PI**2 / 6.0
    eb = 10.0
    ae = 0.5 * eb * (eb - 2.0)
    be = 0.5 * eb * (eb**2 - 6.0 * eb + 6.0)
    emin, emax = 2.0 * 1.0**2, 2.0 * 4.0**2

    dfnorma = c4 * ae + c3**2 * be
    f = torch.log(torch.clamp(1.0 + dfnorma, min=0.1))
    aa = torch.clamp(((eb - f) ** 2 - 2.0 * eb)
                     / torch.maximum(2.0 * f, eps * torch.sign(f) + eps),
                     max=1000.0)
    bb = 2.0 * (1.0 + aa)
    bbm1 = 1.0 / (bb + eps * torch.sign(bb))

    e = torch.full_like(c3, 2.0 * 2.0**2)
    z0 = torch.zeros_like(c3)
    xn = torch.clamp(xnslc, min=1.0)
    for _ in range(5):
        z0 = torch.log(xn * torch.sqrt(0.5 * e))
        e = (g2 - twog1 * (aa + z0) + (2.0 * aa + z0) * z0) * bbm1
        e = torch.clamp(e, emin, emax)
    hmaxn = torch.sqrt(0.5 * e)
    sig_hm = c.PI * hmaxn / (2.0 * np.sqrt(6.0) * (z0 + 0.5 * gam))

    valid = (xnslc > 0.0) & (torch.abs(dfnorma) > eps)
    return (torch.where(valid, aa, torch.zeros_like(aa)),
            torch.where(valid, bb, torch.full_like(bb, 2.0)),
            torch.where(valid, hmaxn, torch.ones_like(hmaxn)),
            torch.where(valid, sig_hm, torch.zeros_like(sig_hm)))


def _kurtosis_parts(fl1, depth, tb):
    """Every intermediate of KURTOSIS (kurtosis.F90:250-400) as a dict."""
    zeps = _eps(fl1)
    zsqeps = torch.sqrt(zeps)
    frmax, frmin = float(tb.fr[-1]), float(tb.fr[0])

    xnu, sig_th = peak_ang(fl1, tb)
    ff, sum0, sum1, sum2 = _moments(fl1, tb, zeps)
    ffmax = torch.amax(ff, dim=0)
    sum6 = (torch.sum(ff * const(tb.dfimofr, fl1)[:, None], dim=0)
            + sp.FRTAIL * tb.delth * ff[-1])

    # Goda peakedness QP over bins above 0.4·max (kurtosis.F90:312-327)
    fac4 = 2.0 * tb.delth * const(tb.dfimfr, fl1)[:, None]
    above = ff > (0.4 * ffmax)[None, :]
    ffa = torch.where(above, ff, torch.zeros_like(ff))
    sum40 = zsqeps + torch.sum(ffa * const(tb.dfim, fl1)[:, None], dim=0)
    sum4 = torch.sum(ffa**2 * fac4, dim=0)

    ok = (sum1 > zsqeps) & (sum0 > zeps)
    zero = torch.zeros_like(sum0)
    f_m = torch.clamp(sum1 / sum0, frmin, frmax)
    qp = torch.where(ok, torch.clamp(sum4 / sum40**2, 0.5, 15.0), zero)
    sig_om = torch.where(ok, (1.0 / np.sqrt(c.PI)) / torch.clamp(qp, min=0.5),
                         zero)

    om_mean = 0.89 * c.ZPI * torch.clamp(sum0 / torch.maximum(sum6, zeps),
                                         frmin, frmax)
    om_mean = torch.where(ok, om_mean,
                          torch.full_like(om_mean, 0.89 * c.ZPI * frmax))
    xkp = torch.where(ok, aki_newton(om_mean, depth), om_mean**2 / c.G)
    eps_st = torch.where(ok, xkp * torch.sqrt(sum0), zero)

    trans = transf_bfi(xkp, depth, xnu, sig_th)
    bf2_raw = 2.0 * trans * (eps_st / torch.maximum(sig_om, zeps)) ** 2
    bf2 = torch.where(ok, torch.clamp(bf2_raw, -5.0, 5.0), zero)

    c3, c4, eta_m, r, _c4b, _c4d = stat_nl(sum0, xkp, bf2, xnu, sig_th,
                                           depth)

    # number of wave groups at the significant level (kurtosis.F90:355-368)
    dur = 1200.0
    om_up = 2.0 * c.ZPI / np.sqrt(c.PI) * xnu * f_m
    xnslc = torch.where(f_m > 0.0, torch.round(dur * om_up), zero)

    _aa, _bb, hmaxn, _sig = h_max(c3, c4, xnslc)
    zeps_h = xnu / (np.sqrt(2.0) * torch.maximum(hmaxn, zeps))
    tmax = (1.0 + 0.5 * zeps_h**2 + 0.75 * zeps_h**4) * (
        sum0 / torch.maximum(sum1, zeps))
    tmax = torch.where((sum1 > zeps) & (hmaxn > zeps), tmax, zero)
    hs = 4.0 * torch.sqrt(torch.clamp(sum0, min=0.0))
    hmax_out = torch.where(sum0 > 0.0, hmaxn * hs, zero)
    xnu_out = torch.where(sum0 > 0.0, xnu, zero)

    return dict(c3=c3, c4=c4, bfi2=bf2, qp=qp, hmax=hmax_out, tmax=tmax,
                eta_m=eta_m, r=r, xnslc=xnslc, sig_th=sig_th, eps=eps_st,
                xnu=xnu_out,
                # for kurtosis_margins
                _ff=ff, _ffmax=ffmax, _dur_om_up=dur * om_up, _trans=trans,
                _bf2=bf2_raw, _sum0=sum0, _xkp=xkp, _xnu=xnu, _depth=depth)


KURTOSIS_KEYS = ("c3", "c4", "bfi2", "qp", "hmax", "tmax", "eta_m", "r",
                 "xnslc", "sig_th", "eps", "xnu")


def kurtosis(fl1, depth, tb):
    """Full freak-wave diagnostic set (kurtosis.F90:250-400).

    Returns dict with c3, c4, bfi2, qp, hmax, tmax, eta_m, r, xnslc,
    sig_th, eps (steepness), xnu — all (npts,)."""
    parts = _kurtosis_parts(fl1, depth, tb)
    return {k: parts[k] for k in KURTOSIS_KEYS}


def _clip_margin(v, lo, hi):
    """Relative distance of ``v`` from the nearer of the bounds of a clip."""
    scale = max(abs(lo), abs(hi))
    return torch.minimum((v - lo).abs(), (v - hi).abs()) / scale


def kurtosis_margins(fl1, depth, tb):
    """Each point's distance from the decision edges of the chain, best
    computed in float64: a point nearer than a small width to an edge may
    take the other branch in float32.  Returns a dict of (npts,):

      ``peak``   PEAK_ANG's interior argmax: (first − second maximum) /
                 first maximum over the interior frequencies;
      ``qp``     the QP threshold ff > 0.4·ffmax: min over bins of
                 |ff − 0.4·ffmax| / ffmax;
      ``xnslc``  round(1200·om_up): distance of 1200·om_up from a tie
                 (x.5), over 1200·om_up (at least 1);
      ``bfi``    the clips of TRANSF_BFI (±4) and of BFI² (±5), relative;
      ``stat``   the clips of C3 (0, 0.25), C4 (±0.25) and R (0, 16),
                 relative.
    """
    p = _kurtosis_parts(fl1, depth, tb)
    nfre = fl1.shape[1]
    fmax = torch.amax(fl1[:, 1:nfre - 1], dim=0)                 # (m, n)
    top2 = torch.topk(fmax, 2, dim=0).values
    peak = (top2[0] - top2[1]) / torch.clamp(top2[0], min=1e-300)
    ffmax = torch.clamp(p["_ffmax"], min=1e-300)
    qp = torch.amin((p["_ff"] - 0.4 * p["_ffmax"]).abs(), dim=0) / ffmax
    x = p["_dur_om_up"]
    xnslc = ((x - torch.floor(x)) - 0.5).abs() / torch.clamp(x, min=1.0)
    bfi = torch.minimum(
        _clip_margin(_transf_bfi_raw(p["_xkp"], p["_depth"], p["_xnu"],
                                     p["sig_th"]), -4.0, 4.0),
        _clip_margin(p["_bf2"], -5.0, 5.0))
    c3, c4, _, r, _, _ = _stat_nl_raw(p["_sum0"], p["_xkp"], p["bfi2"],
                                      p["_xnu"], p["sig_th"], p["_depth"])
    stat = torch.minimum(torch.minimum(_clip_margin(c3, 0.0, 0.25),
                                       _clip_margin(c4, -0.25, 0.25)),
                         _clip_margin(r, 0.0, 16.0))
    return dict(peak=peak, qp=qp, xnslc=xnslc, bfi=bfi, stat=stat)
