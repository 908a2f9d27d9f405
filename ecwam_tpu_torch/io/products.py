"""Derived output parameters: the windsea/swell separation.

Port of the part of ``ecwam_tpu/io/products.py`` that the output-date
physics step runs: SEPWISW (sepwisw.F90:120-300) and what it calls —
mean direction (sthq.F90:40-75), the Simpson-rule periods MWP1/MWP2
(mwp1.F90:55-95, mwp2.F90:48-90) and the directional spread
(wdirspread.F90:98-158, peakfri.F90:84-115, scosfl.F90:90-120).  The rest
of the OUTBS/OUTBLOCK catalog is not ported yet.  In the reference these
run outside any Pallas kernel, so they are plain PyTorch here.

Point-field functions take fl1 (nang, nfre, npts) and return (npts,).
"""

from __future__ import annotations

import numpy as np
import torch

from ecwam_tpu_torch.core import constants as c
from ecwam_tpu_torch.core import spectral as sp
from ecwam_tpu_torch.ops.physics import const
from ecwam_tpu_torch.ops.physics import means as means_mod

OLDWSFC = 1.2       # windsea-threshold wind factor (yowfred.F90:82)
FRIC = 28.0         # friction scaling (yowfred.F90:81)


def mean_direction(fl1, tb):
    """THQ in radians (sthq.F90:40-75)."""
    temp = torch.sum(fl1 * const(tb.dfim, fl1)[None, :, None], dim=1)
    si = torch.sum(const(tb.sinth, fl1)[:, None] * temp, dim=0)
    ci = torch.sum(const(tb.costh, fl1)[:, None] * temp, dim=0)
    ci = torch.where(ci == 0.0, torch.full_like(ci, c.EPSMIN), ci)
    thq = torch.atan2(si, ci)
    return torch.where(thq < 0.0, thq + c.ZPI, thq)


def _simpson_period(fl1, tb, moment_weight, tail_coef, sqrt_out: bool):
    nfre_odd = tb.nfre - 1 + tb.nfre % 2
    temp = torch.sum(fl1[:, :nfre_odd], dim=0)      # (nfre_odd, npts)
    em = torch.sum(const(tb.dfim_sim[:nfre_odd], fl1)[:, None] * temp, dim=0)
    mw = torch.sum(const(moment_weight[:nfre_odd], fl1)[:, None] * temp,
                   dim=0)
    t_last = temp[-1]
    em = em + sp.WETAIL * tb.fr[nfre_odd - 1] * tb.delth * t_last
    mw = mw + tail_coef * t_last
    good = (em > 0.0) & (mw > c.EPSMIN)
    ratio = em / torch.where(good, mw, torch.ones_like(mw))
    if sqrt_out:
        ratio = torch.sqrt(ratio)
    return torch.where(good, torch.clamp(ratio, max=1.0 / tb.fr[0]),
                       torch.zeros_like(ratio))


def mwp1(fl1, tb):
    """Mean period from the f-moment, Simpson rule (mwp1.F90:55-95)."""
    nfre_odd = tb.nfre - 1 + tb.nfre % 2
    coef = sp.WP1TAIL * tb.delth * tb.fr[nfre_odd - 1] ** 2
    return _simpson_period(fl1, tb, tb.dfimfr_sim, coef, sqrt_out=False)


def mwp2(fl1, tb):
    """Mean period from the f²-moment, Simpson rule (mwp2.F90:48-90)."""
    nfre_odd = tb.nfre - 1 + tb.nfre % 2
    coef = sp.WP2TAIL * tb.delth * tb.fr[nfre_odd - 1] ** 3
    return _simpson_period(fl1, tb, tb.dfimfr2_sim, coef, sqrt_out=True)


def _scosfl_at(fl1, m_index, tb):
    """Mean-direction cosine Fourier coefficient at per-point frequency
    index ``m_index`` (scosfl.F90:90-120)."""
    nang = fl1.shape[0]
    fm = torch.gather(fl1, 1, m_index.to(torch.int64)[None, None, :]
                      .expand(nang, 1, -1))[:, 0]
    si = torch.sum(const(tb.sinth, fl1)[:, None] * fm, dim=0)
    ci = torch.sum(const(tb.costh, fl1)[:, None] * fm, dim=0)
    meandir = torch.where((ci == 0.0) & (si == 0.0), torch.zeros_like(ci),
                          torch.atan2(si, ci))
    th = const(tb.th, fl1)[:, None]
    return tb.delth * torch.sum(torch.cos(th - meandir[None, :]) * fm, dim=0)


def wdirspread(fl1, tb):
    """Directional width σ=√(2(1−R1)) at the spectral peak, the LLPEAKF
    form (wdirspread.F90:98-158)."""
    # peak of the 1-D spectrum (peakfri.F90:84-115)
    f1d = torch.sum(fl1, dim=0) * tb.delth        # (nfre, npts)
    epeak, ipeak = torch.max(f1d, dim=0)
    r1 = _scosfl_at(fl1, ipeak, tb)
    pos = epeak > 0.0
    spread = torch.where(
        pos, torch.clamp(r1 / torch.where(pos, epeak, torch.ones_like(epeak)),
                         max=1.0), torch.ones_like(r1))
    return torch.sqrt(2.0 * torch.clamp(1.0 - spread, min=0.0))


def _connect_windsea_boundary(swm, fl1):
    """Topological connection of the windsea low-frequency boundary
    (sepwisw.F90:212-222): scanning from the highest frequency, while no
    two adjacent swell bins were met, a swell bin below a windsea bin with
    no greater energy is re-assigned to windsea."""
    nfre = swm.shape[1]
    new = [swm[:, nfre - 1]]
    stopped = torch.zeros_like(swm[:, 0], dtype=torch.bool)
    cur = swm[:, nfre - 1]
    for m in range(nfre - 1, 0, -1):
        prev = swm[:, m - 1]
        stopped = stopped | ((cur == 1.0) & (prev == 1.0))
        drop = (~stopped) & (cur == 0.0) & (prev == 1.0) & \
            (fl1[:, m] >= fl1[:, m - 1])
        prev = torch.where(drop, torch.zeros_like(prev), prev)
        new.append(prev)
        cur = prev
    return torch.stack(new[::-1], dim=1)


def sepwisw(fl1, xllws, cinv, ufric, wswave, wdwave, tb):
    """Windsea/swell split and both parameter sets (sepwisw.F90:120-300).

    Returns dict with eswell/fswell/thswell/p1swell/p2swell/sprdswell,
    esea/fsea/thwisea/p1sea/p2sea/sprdsea, the swell mask ``swm`` and the
    swell spectrum ``flsw`` (inputs to the train partitioning).
    """
    coef = OLDWSFC * FRIC
    th = const(tb.th, fl1)[:, None]
    coswdif = torch.cos(th - wdwave[None, :])         # (nang, npts)
    xinvwvage = ufric[None, :] * cinv                 # (nfre, npts)
    dircoef = coef * coswdif                          # (nang, npts)

    one, zero = torch.ones_like(fl1), torch.zeros_like(fl1)
    checkta = xinvwvage[None, :, :] * dircoef[:, None, :]
    swm = torch.where((xllws != 0.0) | (checkta >= 1.0), zero, one)

    # consistency check: swell mean freq must stay below windsea's
    # (sepwisw.F90:161-209)
    f_sw = fl1 * swm
    esw, fsw = means_mod.femean(f_sw, tb)
    ese, fse = means_mod.femean(torch.clamp(fl1 - f_sw, min=0.0), tb)
    r = (fsw > 0.96 * fse).to(fl1.dtype)
    dircoef2 = r[None, :] * coef * torch.sign(0.4 + coswdif)
    checkta2 = xinvwvage[None, :, :] * dircoef2[:, None, :]
    swm = torch.where(checkta2 >= 1.0, zero, swm)
    swm = _connect_windsea_boundary(swm, fl1)

    flsw = torch.clamp(fl1, min=c.EPSMIN) * swm
    eswell, fswell = means_mod.femean(flsw, tb)
    thswell = mean_direction(flsw, tb)
    p1swell = mwp1(flsw, tb)
    p2swell = mwp2(flsw, tb)
    sprdswell = wdirspread(flsw, tb)

    # windsea with direction-noise seeding (sepwisw.F90:269-280)
    m_idx = torch.as_tensor(np.arange(tb.nfre) >= tb.nfre // 2,
                            device=fl1.device)[None, :, None]
    noise_zone = m_idx & (coswdif[:, None, :] > 0.8)
    fsea_sp = torch.where(
        noise_zone,
        torch.clamp(fl1 - flsw + c.EPSMIN * coswdif[:, None, :] ** 4,
                    min=0.0),
        torch.clamp(fl1 - flsw, min=0.0))
    esea, fsea = means_mod.femean(fsea_sp, tb)
    thwisea = mean_direction(fsea_sp, tb)
    thwisea = torch.where(esea <= 1.0e-9, wdwave, thwisea)
    p1sea = mwp1(fsea_sp, tb)
    p2sea = mwp2(fsea_sp, tb)
    sprdsea = wdirspread(fsea_sp, tb)

    return dict(eswell=eswell, fswell=fswell, thswell=thswell,
                p1swell=p1swell, p2swell=p2swell, sprdswell=sprdswell,
                esea=esea, fsea=fsea, thwisea=thwisea,
                p1sea=p1sea, p2sea=p2sea, sprdsea=sprdsea,
                swm=swm, flsw=flsw, coswdif=coswdif)
