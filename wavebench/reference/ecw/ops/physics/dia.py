"""DIA four-wave nonlinear transfer S_nl (the Hasselmann et al. discrete
interaction approximation at λ=0.25).

Port of ``ecwam_tpu/ops/physics/dia.py``.  The host-side tables
(NLWEIGT + INISNONLIN: :class:`DiaTables`, :func:`build_dia_tables`,
:func:`build_dia_projection`) are carried over as numpy; SNONLIN
(snonlin.F90:70-470) is plain PyTorch in the reference's projection
form: gathers over the frequency axis, direction coupling by
``torch.roll`` and the frequency scatter as small matrix products.

Shallow-water enhancement:
  - ISNONLIN=0  depth/mean-wavenumber factor (snonlin.F90:127-136)
  - ISNONLIN=1  TRANSF per-frequency factor  (transf.F90:40-69), the default
  - ISNONLIN=2  TRANSF_SNL, the factor with the spread dependence of
                PEAK_ANG (transf_snl.F90:30-85, peak_ang.F90:60-160)
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from wavebench.reference.ecw.core import constants as c
from wavebench.reference.ecw.core import spectral as sp
from wavebench.reference.ecw.core.dispersion import BATHYMAX
from wavebench.reference.ecw.ops.physics import const

ALAMD = 0.25             # DIA lambda (nlweigt.F90:69)
CON = 3000.0             # numerical constant (nlweigt.F90:70)
ENH_MAX = 10.0
ENH_MIN = 0.1
XKDMIN = 0.75            # minimum kd for TRANSF_SNL (yowshal.F90:23)


def _jafu(cl: float, j: int, ian: int) -> int:
    """Angular index shift (jafu.F90:28-34); 1-based in/out."""
    idph = int(cl)       # Fortran INT truncation toward zero
    ja = j + idph
    if ja <= 0:
        ja = ian + ja - 1
    if ja >= ian:
        ja = ja - ian + 1
    return ja


@dataclasses.dataclass(frozen=True)
class DiaTables:
    """All static DIA tables (indices 0-based unless suffixed _f)."""

    nang: int
    nfre: int
    mfrstlw: int          # Fortran index of lowest extended frequency (≤1)
    mlsthg: int           # Fortran index of highest extended frequency
    kfrh: int
    dal1: float
    dal2: float
    # per-MC (Fortran 1..MLSTHG → python list index mc-1):
    ikp: np.ndarray       # raw Fortran freq indices (may exceed [1, nfre])
    ikp1: np.ndarray
    ikm: np.ndarray
    ikm1: np.ndarray
    af11: np.ndarray
    # clamped gather indices, 0-based in [0, nfre-1]:
    ic: np.ndarray
    ip: np.ndarray
    ip1: np.ndarray
    im: np.ndarray
    im1: np.ndarray
    rnl: np.ndarray       # (25, mlsthg) packed real coefficients
    # direction maps (nang, 2), 0-based:
    k1w: np.ndarray
    k2w: np.ndarray
    k11w: np.ndarray
    k21w: np.ndarray


def build_dia_tables(nang: int, nfre: int, fr: np.ndarray,
                     delth: float, fratio: float = 1.1) -> DiaTables:
    """Host-side NLWEIGT + INISNONLIN (see module docstring)."""
    f1p1 = math.log10(fratio)
    isp = int(math.log10(1.0 + ALAMD) / f1p1 + 0.000001)
    ism = math.floor(math.log10(1.0 - ALAMD) / f1p1 + 0.0000001)
    mfrstlw = 1 + ism
    mlsthg = nfre - ism
    kfrh = -ism + isp + 2

    # ---- angular geometry (nlweigt.F90:100-170)
    xf = ((1.0 + ALAMD) / (1.0 - ALAMD)) ** 4
    costh3 = (1.0 + 2.0 * ALAMD + 2.0 * ALAMD**3) / (1.0 + ALAMD) ** 2
    delphi1 = -180.0 / c.PI * math.acos(costh3)   # reference PI literal
    costh4 = math.sqrt(1.0 - xf + xf * costh3**2)
    delphi2 = 180.0 / c.PI * math.acos(costh4)
    deltha = delth * c.DEG
    cl1 = delphi1 / deltha
    cl2 = delphi2 / deltha

    klp1 = nang + 1
    ja1 = np.zeros((nang + 1, 2), dtype=int)   # 1-based slots 1..nang
    ja2 = np.zeros((nang + 1, 2), dtype=int)
    ic_sign = 1
    for kh in (1, 2):
        klh = nang if kh == 1 else klp1
        for k in range(1, klh + 1):
            ks = k if kh == 1 else klp1 - k + 1
            if ks > nang:
                continue
            ja1[ks, kh - 1] = _jafu(ic_sign * cl1, k, klp1)
            ja2[ks, kh - 1] = _jafu(ic_sign * cl2, k, klp1)
        ic_sign = -1

    cl1 = cl1 - int(cl1)
    cl2 = cl2 - int(cl2)
    acl1, acl2 = abs(cl1), abs(cl2)
    cl11, cl21 = 1.0 - acl1, 1.0 - acl2
    dal1 = 1.0 / (1.0 + ALAMD) ** 4
    dal2 = 1.0 / (1.0 - ALAMD) ** 4

    k1w = np.zeros((nang + 1, 2), dtype=int)
    k2w = np.zeros((nang + 1, 2), dtype=int)
    k11w = np.zeros((nang + 1, 2), dtype=int)
    k21w = np.zeros((nang + 1, 2), dtype=int)
    isg = 1
    for kh in (1, 2):
        cl1h = isg * cl1
        cl2h = isg * cl2
        for k in range(1, nang + 1):
            ks = k if kh == 1 else nang - k + 2
            if k == 1:
                ks = 1
            k1 = ja1[k, kh - 1]
            k1w[ks, kh - 1] = k1
            k11 = k1 - 1 if cl1h < 0.0 else k1 + 1
            if k11 < 1:
                k11 = nang
            if k11 > nang:
                k11 = 1
            k11w[ks, kh - 1] = k11
            k2 = ja2[k, kh - 1]
            k2w[ks, kh - 1] = k2
            k21 = k2 - 1 if cl2h < 0.0 else k2 + 1
            if k21 < 1:
                k21 = nang
            if k21 > nang:
                k21 = 1
            k21w[ks, kh - 1] = k21
        isg = -1

    # ---- extended frequency ladder + interpolation (nlweigt.F90:172-205)
    # frlon over Fortran indices mfrstlw..nfre+kfrh
    def frl_idx(m_f):
        return m_f - mfrstlw

    nfrl = nfre + kfrh - mfrstlw + 1
    frlon = np.zeros(nfrl)
    for m in range(1, nfre + 1):
        frlon[frl_idx(m)] = fr[m - 1]
    for m in range(0, mfrstlw - 1, -1):
        frlon[frl_idx(m)] = frlon[frl_idx(m + 1)] / fratio
    for m in range(nfre + 1, nfre + kfrh + 1):
        frlon[frl_idx(m)] = fratio * frlon[frl_idx(m - 1)]

    nmc_ext = mlsthg - mfrstlw + 1

    def mc_idx(m_f):
        return m_f - mfrstlw

    ikp = np.zeros(nmc_ext, dtype=int)
    ikp1 = np.zeros(nmc_ext, dtype=int)
    ikm = np.zeros(nmc_ext, dtype=int)
    ikm1 = np.zeros(nmc_ext, dtype=int)
    af11 = np.zeros(nmc_ext)
    fklap = np.zeros(nmc_ext)
    fklap1 = np.zeros(nmc_ext)
    fklam = np.zeros(nmc_ext)
    fklam1 = np.zeros(nmc_ext)
    for m in range(mfrstlw, mlsthg + 1):
        i = mc_idx(m)
        frg = frlon[frl_idx(m)]
        af11[i] = CON * frg**11
        flp = frg * (1.0 + ALAMD)
        flm = frg * (1.0 - ALAMD)
        ikp[i] = m + isp
        fkp = frlon[frl_idx(ikp[i])]
        ikp1[i] = ikp[i] + 1
        fklap[i] = (flp - fkp) / (frlon[frl_idx(ikp1[i])] - fkp)
        fklap1[i] = 1.0 - fklap[i]
        ikn = m + ism
        if ikn >= mfrstlw:
            ikm[i] = ikn
            fkm = frlon[frl_idx(ikm[i])]
            ikm1[i] = ikm[i] + 1
            fklam[i] = (flm - fkm) / (frlon[frl_idx(ikm1[i])] - fkm)
            fklam1[i] = 1.0 - fklam[i]
        elif ikn + 1 == mfrstlw:
            ikm[i] = 1
            ikm1[i] = mfrstlw
            fkm = frlon[frl_idx(ikm1[i])] / fratio
            fklam[i] = (flm - fkm) / (frlon[frl_idx(ikm1[i])] - fkm)
            fklam1[i] = 0.0
        else:
            ikm[i] = 1
            ikm1[i] = 1
            fklam[i] = 0.0
            fklam1[i] = 0.0

    frh = np.zeros(kfrh)
    for i in range(1, kfrh + 1):
        m = nfre + i - 1
        frh[i - 1] = (frlon[frl_idx(nfre)] / frlon[frl_idx(m)]) ** 5

    # ---- front-tail reduction factors FTRF (inisnonlin.F90:56-66)
    def epmma(x):
        return math.exp(-min(1.25 * x**4, 50.0)) * x**5

    ftrf = {}                           # Fortran index mfrstlw..1
    alph = 1.0 / epmma(1.0)
    frr = 1.0
    for mc in range(1, mfrstlw - 1, -1):
        ftrf[mc] = alph * epmma(frr)
        frr = frr * fratio

    # ---- clamped indices + 25 packed coefficients (inisnonlin.F90:70-230)
    ic_a = np.zeros(mlsthg, dtype=int)
    ip_a = np.zeros(mlsthg, dtype=int)
    ip1_a = np.zeros(mlsthg, dtype=int)
    im_a = np.zeros(mlsthg, dtype=int)
    im1_a = np.zeros(mlsthg, dtype=int)
    rnl = np.zeros((25, mlsthg))
    for mc in range(1, mlsthg + 1):
        j = mc - 1
        i = mc_idx(mc)
        mp, mp1, mm, mm1 = ikp[i], ikp1[i], ikm[i], ikm1[i]
        ffacp = ffacp1 = ffacm = ffacm1 = ftail = 1.0
        ic = max(mc, 1)
        ip, ip1, im, im1 = mp, mp1, mm, mm1
        if ip < 1:
            ffacp = ftrf[ip]
            ip = 1
        if ip1 < 1:
            ffacp1 = ftrf[ip1]
            ip1 = 1
        if im < mfrstlw:
            ffacm = 0.0
            im = 1
        elif im < 1:
            ffacm = ftrf[im]
            im = 1
        if im1 < mfrstlw:
            ffacm1 = 0.0
            im1 = 1
        elif im1 < 1:
            ffacm1 = ftrf[im1]
            im1 = 1
        if ip1 > nfre:
            itemp = min(ip1 - nfre + 1, kfrh)
            ffacp1 = frh[itemp - 1]
            ip1 = nfre
            if ip > nfre:
                ffacp = frh[ip - nfre]      # FRH(IP-NFRE+1)
                ip = nfre
                if ic > nfre:
                    ftail = frh[ic - nfre]
                    ic = nfre
                    if im1 > nfre:
                        ffacm1 = frh[im1 - nfre]
                        im1 = nfre
        ic_a[j], ip_a[j], ip1_a[j] = ic - 1, ip - 1, ip1 - 1
        im_a[j], im1_a[j] = im - 1, im1 - 1

        fklamp, fklamp1 = fklap[i], fklap1[i]
        gw2 = fklamp1 * ffacp * dal1
        gw1 = gw2 * cl11
        gw2 = gw2 * acl1
        gw4 = fklamp * ffacp1 * dal1
        gw3 = gw4 * cl11
        gw4 = gw4 * acl1
        fklampa = fklamp * cl11
        fklampb = fklamp * acl1
        fklamp2 = fklamp1 * acl1
        fklamp1 = fklamp1 * cl11
        rnl[:, j][0:13] = [
            ftail, gw1, gw2, gw3, gw4, fklampa, fklampb, fklamp2,
            fklamp1, fklampa**2, fklampb**2, fklamp1**2, fklamp2**2]

        fklamm, fklamm1 = fklam[i], fklam1[i]
        gw6 = fklamm1 * ffacm * dal2
        gw5 = gw6 * cl21
        gw6 = gw6 * acl2
        gw8 = fklamm * ffacm1 * dal2
        gw7 = gw8 * cl21
        gw8 = gw8 * acl2
        fklamma = fklamm * cl21
        fklammb = fklamm * acl2
        fklamm2 = fklamm1 * acl2
        fklamm1 = fklamm1 * cl21
        rnl[:, j][13:25] = [
            gw5, gw6, gw7, gw8, fklamma, fklammb, fklamm2, fklamm1,
            fklamma**2, fklammb**2, fklamm1**2, fklamm2**2]

    sel = slice(mc_idx(1), mc_idx(mlsthg) + 1)   # per-MC views for MC≥1
    return DiaTables(
        nang=nang, nfre=nfre, mfrstlw=mfrstlw, mlsthg=mlsthg, kfrh=kfrh,
        dal1=dal1, dal2=dal2,
        ikp=ikp[sel], ikp1=ikp1[sel], ikm=ikm[sel], ikm1=ikm1[sel],
        af11=af11[sel],
        ic=ic_a, ip=ip_a, ip1=ip1_a, im=im_a, im1=im1_a, rnl=rnl,
        k1w=k1w[1:] - 1, k2w=k2w[1:] - 1,
        k11w=k11w[1:] - 1, k21w=k21w[1:] - 1)


@dataclasses.dataclass(frozen=True)
class DiaProjection:
    """Dense frequency-projection formulation of the SNONLIN scatter.

    The nine (direction, frequency) scatter targets of snonlin.F90:168-460
    collapse, per direction-rotation, into matrices W[f, mc] with validity
    (raw Fortran index in [1, NFRE]) and the interpolation weights folded
    in.  The scatter becomes einsum('fm,kmp->kfp', W, value), a small
    matrix product in place of thousands of scatters.
    Shifts: per KH rotation amounts for K1/K11/K2/K21.
    """

    shifts: np.ndarray      # (2, 4): s1, s11, s2, s21 per KH
    wsl_c: np.ndarray       # (nfre, mlsthg) center  (value ad, shift 0)
    wfld_c: np.ndarray      #                      (value delad)
    wsl_k2: np.ndarray      # targets MM/MM1 at rotation K2  (value ad)
    wsl_k21: np.ndarray
    wfld_k2: np.ndarray     # (value delam)
    wfld_k21: np.ndarray
    wsl_k1: np.ndarray      # targets MP/MP1 at rotation K1  (value ad)
    wsl_k11: np.ndarray
    wfld_k1: np.ndarray     # (value delap)
    wfld_k11: np.ndarray


def build_dia_projection(dia: DiaTables) -> DiaProjection:
    nfre, mlsthg = dia.nfre, dia.mlsthg

    def proj(raw_f):
        """P[f, mc] = 1 where clamp-free raw Fortran index raw_f[mc]-1 == f."""
        p = np.zeros((nfre, mlsthg))
        for j in range(mlsthg):
            t = int(raw_f[j])
            if 1 <= t <= nfre:
                p[t - 1, j] = 1.0
        return p

    mc_f = np.arange(1, mlsthg + 1)
    p_c = proj(mc_f)
    p_mm = proj(dia.ikm)
    p_mm1 = proj(dia.ikm1)
    p_mp = proj(dia.ikp)
    p_mp1 = proj(dia.ikp1)
    # low-frequency boundary: scatter to MM is skipped for MC ≤ -MFRSTLW+1
    # (snonlin.F90 "ELSE" branch has no (K2, MM) update); those MCs have
    # raw MM < 1 so proj() already drops them.

    r = dia.rnl
    (fklampa, fklampb, fklamp2, fklamp1) = r[5], r[6], r[7], r[8]
    (fklapa2, fklapb2, fklap12, fklap22) = r[9], r[10], r[11], r[12]
    (fklamma, fklammb, fklamm2, fklamm1) = r[17], r[18], r[19], r[20]
    (fklama2, fklamb2, fklam12, fklam22) = r[21], r[22], r[23], r[24]

    shifts = np.zeros((2, 4), dtype=int)
    for kh in range(2):
        for t, arr in enumerate((dia.k1w, dia.k11w, dia.k2w, dia.k21w)):
            m = arr[:, kh]
            s = int(m[0]) % dia.nang
            if not np.all((np.arange(dia.nang) + s) % dia.nang
                          == m % dia.nang):
                raise ValueError("DIA direction map is not a rotation")
            shifts[kh, t] = s

    out = DiaProjection(
        shifts=shifts,
        wsl_c=-2.0 * p_c,
        wfld_c=-2.0 * p_c,
        wsl_k2=p_mm * fklamm1 + p_mm1 * fklamma,
        wsl_k21=p_mm * fklamm2 + p_mm1 * fklammb,
        wfld_k2=p_mm * fklam12 + p_mm1 * fklama2,
        wfld_k21=p_mm * fklam22 + p_mm1 * fklamb2,
        wsl_k1=p_mp * fklamp1 + p_mp1 * fklampa,
        wsl_k11=p_mp * fklamp2 + p_mp1 * fklampb,
        wfld_k1=p_mp * fklap12 + p_mp1 * fklapa2,
        wfld_k11=p_mp * fklap22 + p_mp1 * fklapb2,
    )
    return out


def transf(xk, depth):
    """Shallow-water nonlinear-transfer enhancement (transf.F90:26-40)."""
    x = xk * depth
    xs = torch.clamp(x, max=c.DKMAX)
    t0 = torch.tanh(xs)
    om = torch.sqrt(c.G * xk * t0)
    c0 = om / xk
    vg = torch.where(xs < 1.0e-4, c0,
                     0.5 * c0 * (1.0 + 2.0 * xs / torch.sinh(2.0 * xs)))
    dvg = (t0 - xs * (1.0 - t0**2)) ** 2 + 4.0 * xs**2 * t0**2 * (1.0 - t0**2)
    xnl1 = (9.0 * t0**4 - 10.0 * t0**2 + 9.0) / (8.0 * t0**3)
    xnl2 = ((2.0 * vg - 0.5 * c0) ** 2 / (c.G * depth - vg**2) + 1.0) / xs
    val = (xnl1 - xnl2) ** 2 / (dvg * t0**8)
    return torch.where((depth < BATHYMAX) & (depth > 0.0) & (x <= c.DKMAX),
                       val, torch.ones_like(val))


def enhancement_xk(dia: DiaTables, tb) -> np.ndarray:
    """Deep-water wavenumbers of the extension range NFRE+1..MLSTHG."""
    next_f = np.arange(dia.nfre + 1, dia.mlsthg + 1)
    return c.GM1 * (tb.zpifr[-1] * tb.fratio ** (next_f - dia.nfre)) ** 2


def peak_window(tb) -> int:
    """NSH, the half-width of PEAK_ANG's frequency window: the frequencies
    within a factor 1.5 of the peak (peak_ang.F90:73)."""
    return 1 + int(math.log(1.5) / math.log(tb.fratio))


def _column_max(fl1):
    """Per point, the direction maxima of the interior frequencies m =
    1..nfre−2 (0-based; Fortran 2..NFRE−1), the peak search range of
    PEAK_ANG: (nfre−2, npts)."""
    return torch.amax(fl1[:, 1:fl1.shape[1] - 1, :], dim=0)


def peak_ang(fl1, tb):
    """Frequency spread ν and directional spread σθ at the peak
    (peak_ang.F90:60-160), the inputs of the ISNONLIN=2 enhancement.

    fl1 (nang, nfre, npts) → (xnu, sig_th), each (npts,).  The peak is the
    first maximum over the interior frequencies (as ``argmax`` takes it).
    1 − r1 = 1 − s2/s1 is accumulated as s1 − s2 = Σ 2·sin²((θ − θm)/2)·F·Δf
    (the same algebra), which keeps narrow spectra free of cancellation.
    """
    dt = fl1.dtype
    nang, nfre, npts = fl1.shape
    zeps = 10.0 * torch.finfo(dt).eps
    nsh = peak_window(tb)

    dfim = const(tb.dfim, fl1)
    temp = torch.sum(fl1, dim=0)                      # (nfre, npts)
    sum0 = zeps + torch.sum(dfim[:, None] * temp, dim=0)
    sum1 = torch.sum(const(tb.dfimfr, fl1)[:, None] * temp, dim=0)
    sum2 = torch.sum(const(tb.dfimfr2, fl1)[:, None] * temp, dim=0)
    t_last = temp[-1]
    sum0 = sum0 + sp.WETAIL * tb.fr[-1] * tb.delth * t_last
    sum1 = sum1 + sp.WP1TAIL * tb.delth * tb.fr[-1] ** 2 * t_last
    sum2 = sum2 + sp.WP2TAIL * tb.delth * tb.fr[-1] ** 3 * t_last
    xnu = torch.where(
        sum0 > zeps,
        torch.sqrt(torch.clamp(sum2 * sum0 / sum1**2 - 1.0, min=zeps)),
        torch.full_like(sum0, zeps))

    # spectral-peak index over m = 1..nfre−2, first on ties
    # (peak_ang.F90:88-103)
    colmax = _column_max(fl1)
    xmax, arg = torch.max(colmax, dim=0)
    mmax = torch.where(xmax > 0.0, arg + 1, torch.ones_like(arg))

    sinth = const(tb.sinth, fl1)[:, None]
    costh = const(tb.costh, fl1)[:, None]
    th = const(tb.th, fl1)[:, None]
    sum_s = torch.zeros_like(xnu)
    sum_c = torch.full_like(xnu, zeps)
    s1 = torch.full_like(xnu, zeps)
    d = torch.full_like(xnu, zeps)                    # s1 − s2
    # the running THMEAN update is sequential in m (peak_ang.F90:134-148)
    for off in range(-nsh, nsh + 1):
        m = mmax + off
        valid = (m >= 0) & (m <= nfre - 1)
        mc = torch.clamp(m, 0, nfre - 1)
        flm = torch.gather(fl1, 1, mc[None, None, :].expand(nang, 1, npts)
                           )[:, 0, :]
        flm = torch.where(valid[None, :], flm, torch.zeros_like(flm))
        dfim_m = torch.where(valid, dfim[mc], torch.zeros_like(xnu))
        sum_s = sum_s + torch.sum(sinth * flm, dim=0)
        sum_c = sum_c + torch.sum(costh * flm, dim=0)
        thmean = torch.atan2(sum_s, sum_c)
        s1 = s1 + torch.sum(flm, dim=0) * dfim_m
        h = torch.sin(0.5 * (th - thmean[None, :]))
        d = d + torch.sum(2.0 * h * h * flm, dim=0) * dfim_m
    sig_th = torch.where(
        s1 > zeps, torch.sqrt(2.0 * torch.clamp(d / s1, min=0.0)),
        torch.zeros_like(s1))
    return xnu, sig_th


def peak_margin(fl1):
    """Per point, the relative gap between the largest and the
    second-largest direction maximum over PEAK_ANG's search range:
    (max − second)/max, +inf where the spectrum there is zero.  Where it
    is tiny, a last-bit change of the spectrum may move the peak."""
    top = torch.topk(_column_max(fl1), 2, dim=0).values
    return torch.where(top[0] > 0.0, (top[0] - top[1]) / top[0],
                       torch.full_like(top[0], torch.inf))


def transf_snl(xk0, depth, xnu, sig_th):
    """Shallow-water SNL enhancement with spread dependence
    (transf_snl.F90:30-85)."""
    x0 = xk0 * depth
    xk = torch.maximum(xk0, XKDMIN / depth)
    x = torch.clamp(xk * depth, max=c.DKMAX)       # guard sinh overflow
    t0 = torch.tanh(x)
    t0sq = t0**2
    om = torch.sqrt(c.G * xk * t0)
    c0 = om / xk
    cs_sq = c.G * depth
    vg = torch.where(x < 1.0e-4, c0,
                     0.5 * c0 * (1.0 + 2.0 * x / torch.sinh(2.0 * x)))
    vg_sq = vg**2
    dvg = (t0 - x * (1.0 - t0sq)) ** 2 + 4.0 * x**2 * t0sq * (1.0 - t0sq)
    xnl1 = (9.0 * t0sq**2 - 10.0 * t0sq + 9.0) / (8.0 * t0sq * t0)
    xnl2 = ((2.0 * vg - 0.5 * c0) ** 2 / (cs_sq - vg_sq) + 1.0) / x
    xnl4 = 1.0 / (4.0 * t0) * (2.0 * c0 + vg * (1.0 - t0sq)) ** 2 / \
        (cs_sq - vg_sq)
    alp = (1.0 - vg_sq / cs_sq) * c0**2 / vg_sq
    zfac = sig_th**2 / (sig_th**2 + alp * xnu**2)
    xnl = xnl1 - xnl2 + zfac * xnl4
    val = torch.clamp(xnl**2 / (dvg * t0sq**4), 0.1, 10.0)
    return torch.where((depth < BATHYMAX) & (depth > 0.0) & (x0 <= c.DKMAX),
                       val, torch.ones_like(val))


def _enhancement(dia: DiaTables, tb, wavnum, depth, akmean, isnonlin: int,
                 fl1=None):
    """ENH(mc, npts) factor (snonlin.F90:123-165), vectorized over MC."""
    npts = depth.shape[0]
    if isnonlin == 0:
        enhfr = torch.clamp(0.75 * depth * akmean, min=0.5)
        enhfr = 1.0 + (5.5 / enhfr) * (1.0 - 0.833 * enhfr) * torch.exp(
            -1.25 * enhfr)
        return enhfr[None, :].expand(dia.mlsthg, npts)
    if isnonlin not in (1, 2):
        raise ValueError(f"unknown ISNONLIN={isnonlin}")
    xk_ext = torch.as_tensor(enhancement_xk(dia, tb), dtype=wavnum.dtype,
                             device=wavnum.device)
    xk = torch.cat([wavnum, xk_ext[:, None].expand(-1, npts)], dim=0)
    if isnonlin == 1:
        return torch.clamp(transf(xk, depth[None, :]), ENH_MIN, ENH_MAX)
    # the spread-dependent enhancement (snonlin.F90:151-165)
    xnu, sig_th = peak_ang(fl1, tb)
    return transf_snl(xk, depth[None, :], xnu[None, :], sig_th[None, :])


def snonlin(fl1, fld, sl, wavnum, depth, akmean, tb, dia: DiaTables,
            *, isnonlin: int = 1):
    """DIA nonlinear transfer, added onto (fld, sl) (snonlin.F90:70-470).

    Projection formulation: all MC at once; gathers are index_select
    over the frequency axis, direction coupling is torch.roll, and the
    frequency scatter is 10 small einsums (see DiaProjection).
    """
    dt, dev = fl1.dtype, fl1.device
    pr = build_dia_projection(dia)
    enh = _enhancement(dia, tb, wavnum, depth, akmean, isnonlin, fl1=fl1)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64), dtype=dt,
                               device=dev)

    def take(idx):
        return torch.index_select(
            fl1, 1, torch.as_tensor(np.asarray(idx), device=dev))

    r = dia.rnl.astype(np.float64)
    ftail = t(r[0])[None, :, None]
    gw = [t(r[i])[None, :, None] for i in (1, 2, 3, 4)]
    gw5678 = [t(r[i])[None, :, None] for i in (13, 14, 15, 16)]

    f_ic = take(dia.ic)                     # (nang, mlsthg, npts)
    f_ip = take(dia.ip)
    f_ip1 = take(dia.ip1)
    f_im = take(dia.im)
    f_im1 = take(dia.im1)

    ftemp = (t(dia.af11)[:, None] * enh)[None, :, :]

    def pj(w, val):
        return torch.einsum("fm,kmp->kfp", t(w), val)

    dsl = torch.zeros_like(fld)
    dfld = torch.zeros_like(fld)
    for kh in range(2):
        s1, s11, s2, s21 = (int(x) for x in pr.shifts[kh])

        def rot(a, s):
            return a if s == 0 else torch.roll(a, -s, dims=0)

        def unrot(a, s):
            return a if s == 0 else torch.roll(a, s, dims=0)

        sap = (gw[0] * rot(f_ip, s1) + gw[1] * rot(f_ip, s11)
               + gw[2] * rot(f_ip1, s1) + gw[3] * rot(f_ip1, s11))
        sam = (gw5678[0] * rot(f_im, s2) + gw5678[1] * rot(f_im, s21)
               + gw5678[2] * rot(f_im1, s2) + gw5678[3] * rot(f_im1, s21))
        fij = f_ic * ftail
        fad1 = fij * (sap + sam)
        fad2 = fad1 - 2.0 * sap * sam
        fad1 = fad1 + fad2
        fcen = ftemp * fij
        ad = fad2 * fcen
        delad = fad1 * ftemp
        delap = (fij - 2.0 * sam) * dia.dal1 * fcen
        delam = (fij - 2.0 * sap) * dia.dal2 * fcen

        dsl = dsl + pj(pr.wsl_c, ad)
        dfld = dfld + pj(pr.wfld_c, delad)
        dsl = dsl + unrot(pj(pr.wsl_k2, ad), s2) + unrot(pj(pr.wsl_k21, ad), s21)
        dfld = dfld + unrot(pj(pr.wfld_k2, delam), s2) \
            + unrot(pj(pr.wfld_k21, delam), s21)
        dsl = dsl + unrot(pj(pr.wsl_k1, ad), s1) + unrot(pj(pr.wsl_k11, ad), s11)
        dfld = dfld + unrot(pj(pr.wfld_k1, delap), s1) \
            + unrot(pj(pr.wfld_k11, delap), s11)

    return fld + dfld, sl + dsl
