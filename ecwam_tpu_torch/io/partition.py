"""Swell-train spectral partitioning (SEP3TR / FNDPRT / PARMEAN).

Copied unchanged from ``ecwam_tpu/io/partition.py`` (numpy only, no
JAX): the port imports nothing of the JAX package.

NumPy re-derivation of the reference's 3-train swell partitioning
(sep3tr.F90:140-440, fndprt.F90:120-330,
parmean.F90:85-135).  This runs on host at output cadence only — the
region-growing partition search is inherently iterative mask relaxation,
so it is vectorized over grid points (the per-point (nang, nfre) masks
become boolean arrays (npts, nang, nfre)) rather than jitted.

Deviation from the reference: the reference grows each partition with
in-sweep (Gauss-Seidel) mask updates; here each relaxation sweep is
Jacobi (all updates applied at once).  Both iterate to the same fixed
point; the iteration cap is kept at 25 sweeps like fndprt.F90:265.
"""

from __future__ import annotations

import numpy as np

NPMAX = 20                  # max partitions examined (yowpcons.F90:69)
XNOISELEVEL = 0.005         # sep3tr.F90:108
HSMIN_INTER = 0.05          # sep3tr.F90:110
HSMIN_SLOPE = -0.0017
HALF_SECTOR = 75.0          # degrees around the peak (fndprt.F90:124)
FLMIN = 0.00001             # spectral noise floor (yowice.F90 FLMIN)
EPSMIN = 1.0e-32


def _smooth_directions(flsw):
    """0.1/0.8/0.1 direction smoothing with the windsea mask re-imposed
    (sep3tr.F90:148-163). flsw (npts, nang, nfre)."""
    up = np.roll(flsw, -1, axis=1)
    dn = np.roll(flsw, 1, axis=1)
    sm = 0.10 * (up + dn) + 0.80 * flsw
    return np.where(flsw <= 0.0, 0.0, sm)


def _local_peaks(fl, mij, flnoise):
    """3×3 local maxima of the smoothed swell spectrum with all-positive
    neighbourhood, freq range 2..mij-1 (sep3tr.F90:190-247).

    Returns boolean (npts, nang, nfre)."""
    npts, nang, nfre = fl.shape
    # reference range M=2..MIJ-1 (1-based, sep3tr.F90:208) with our 0-based
    # cut index mij ⇒ 1..mij-1 inclusive
    m_idx = np.arange(nfre)[None, None, :]
    in_range = (m_idx >= 1) & (m_idx < mij[:, None, None])

    neigh = []
    for dk in (-1, 0, 1):
        fk = np.roll(fl, dk, axis=1)
        for dm in (-1, 0, 1):
            if dk == 0 and dm == 0:
                continue
            if dm == -1:
                fm = np.concatenate([fk[:, :, :1], fk[:, :, :-1]], axis=2)
            elif dm == 1:
                fm = np.concatenate([fk[:, :, 1:], fk[:, :, -1:]], axis=2)
            else:
                fm = fk
            neigh.append(fm)
    neigh = np.stack(neigh)                       # (8, npts, nang, nfre)
    all_pos = np.all(neigh > 0.0, axis=0)
    is_max = np.all(fl[None] >= neigh, axis=0)
    above = fl > np.maximum(FLMIN, flnoise[:, None, None])
    return in_range & above & all_pos & is_max


def _neighbor_any(mask, cond):
    """True where any 3×3 neighbour (θ periodic, f clamped) of ``mask``
    satisfies; used for the region-growing sweeps."""
    out = np.zeros_like(mask, dtype=bool)
    for dk in (-1, 0, 1):
        mk = np.roll(mask, dk, axis=1)
        for dm in (-1, 0, 1):
            if dm == -1:
                mm = np.concatenate([mk[:, :, :1], mk[:, :, :-1]], axis=2)
            elif dm == 1:
                mm = np.concatenate([mk[:, :, 1:], mk[:, :, -1:]], axis=2)
            else:
                mm = mk
            out |= mm
    return out & cond


def _grow_partition(fl1, w1, llw3, peak_k, peak_m, active, mij, nang_h):
    """Grow one partition from its peak (fndprt.F90:168-270).

    w1: running exclusion level (npts, nang, nfre) — 1 where the bin is
    already fully claimed.  Returns the partition mask w2 (bool)."""
    npts, nang, nfre = fl1.shape
    k_idx = np.arange(nang)[None, :, None]
    m_idx = np.arange(nfre)[None, None, :]

    # directional sector ±nang_h around the peak (fndprt.F90:124-130)
    dk = (k_idx - peak_k[:, None, None] + nang) % nang
    in_sector = (dk <= nang_h) | (dk >= nang - nang_h)
    in_mrange = m_idx <= mij[:, None, None]

    core = np.zeros((npts, nang, nfre), dtype=bool)      # W2 == 1
    halo = np.zeros((npts, nang, nfre), dtype=bool)      # W2 == 0.5
    # seed: peak bin and its 3×3 box (fndprt.F90:175-186)
    pk = peak_k[:, None, None]
    pm = peak_m[:, None, None]
    ddk = (k_idx - pk + nang) % nang
    seed_box = ((ddk <= 1) | (ddk >= nang - 1)) & (np.abs(m_idx - pm) <= 1)
    halo = seed_box & (w1 <= 0.5)
    core = (k_idx == pk) & (m_idx == pm) & (w1 < 0.25)
    core &= active[:, None, None]
    halo &= active[:, None, None]

    grow_ok = llw3 & in_sector
    for _ in range(25):
        # promote halo bins that are local maxima of the unclaimed region
        # (fndprt.F90:207-238): no free neighbour with higher energy
        neigh_hi = np.zeros_like(core)
        for dki in (-1, 0, 1):
            fk = np.roll(fl1, dki, axis=1)
            hk = np.roll(core | halo, dki, axis=1)
            for dmi in (-1, 0, 1):
                if dmi == -1:
                    fm = np.concatenate([fk[:, :, :1], fk[:, :, :-1]],
                                        axis=2)
                    hm = np.concatenate([hk[:, :, :1], hk[:, :, :-1]],
                                        axis=2)
                elif dmi == 1:
                    fm = np.concatenate([fk[:, :, 1:], fk[:, :, -1:]],
                                        axis=2)
                    hm = np.concatenate([hk[:, :, 1:], hk[:, :, -1:]],
                                        axis=2)
                else:
                    fm, hm = fk, hk
                neigh_hi |= (~hm) & (fm > fl1)
        promote = halo & (~core) & grow_ok & in_mrange & (w1 < 0.5) & \
            (~neigh_hi)
        new_core = core | promote
        # extend halo to free bins adjacent to the core (fndprt.F90:243-262)
        new_halo = _neighbor_any(new_core, grow_ok & (w1 < 1.0)) | halo
        if (new_core == core).all() and (new_halo == halo).all():
            break
        core, halo = new_core, new_halo
    return core & active[:, None, None]


def _parmean(spec_list, dfim, dfimofr, costh, sinth):
    """Energy / mean direction / mean period per partition
    (parmean.F90:95-130). spec_list: list of (npts, nang, nfre)."""
    ene, dire, per = [], [], []
    for spec in spec_list:
        f1d = spec.sum(axis=1)                         # (npts, nfre)
        em = EPSMIN + (f1d * dfim[None, :]).sum(axis=1)
        fm = EPSMIN + (f1d * dfimofr[None, :]).sum(axis=1)
        tempk = (spec * dfim[None, None, :]).sum(axis=2)
        si = (tempk * sinth[None, :]).sum(axis=1)
        ci = (tempk * costh[None, :]).sum(axis=1)
        ci = np.where(ci == 0.0, EPSMIN, ci)
        thq = np.arctan2(si, ci)
        thq = np.where(thq < 0.0, thq + 2.0 * np.pi, thq)
        good = em > EPSMIN
        ene.append(np.where(good, em, 0.0))
        per.append(np.where(good, fm / em, 0.0))
        dire.append(np.where(good, thq, 0.0))
    return (np.stack(ene, 1), np.stack(dire, 1), np.stack(per, 1))


def sep3tr(fl1, mij, sep, wswave, wdwave, tb, *, ntrain: int = 3):
    """Partition the swell spectrum into ``ntrain`` trains
    (sep3tr.F90:140-440).

    fl1 (nang, nfre, npts) device layout; ``sep`` the dict from
    products.sepwisw (host arrays).  Returns dict with emtrain / thtrain /
    pmtrain, each (npts, ntrain).
    """
    fl1 = np.asarray(fl1, np.float64).transpose(2, 0, 1)  # (npts,nang,nfre)
    npts, nang, nfre = fl1.shape
    swm = np.asarray(sep["swm"], np.float64).transpose(2, 0, 1)
    flsw = np.asarray(sep["flsw"], np.float64).transpose(2, 0, 1)
    eswell = np.asarray(sep["eswell"], np.float64)
    fswell = np.asarray(sep["fswell"], np.float64)
    thswell = np.asarray(sep["thswell"], np.float64)
    fsea = np.asarray(sep["fsea"], np.float64)
    coswdif = np.cos(np.asarray(tb.th)[None, :] - wdwave[:, None])

    fl = _smooth_directions(flsw)
    enmax = fl.max(axis=(1, 2))
    flnoise = XNOISELEVEL * enmax

    peaks = _local_peaks(fl, mij, flnoise)
    nang_h = int(round(HALF_SECTOR / 360.0 * nang)) + 1

    # claimed-level map W1: bins below the noise floor start claimed
    # (fndprt.F90:135-150)
    # fndprt's spectrum argument is the smoothed swell FL
    low = fl <= FLMIN
    w1 = low.astype(np.float64)
    llw3 = ~low

    # order peaks by decreasing smoothed energy; take at most NPMAX
    pe = np.where(peaks, fl, -1.0).reshape(npts, -1)
    order = np.argsort(-pe, axis=1)[:, :NPMAX]            # (npts, NPMAX)
    pvalid = np.take_along_axis(pe, order, axis=1) > 0.0
    pk = (order // nfre).astype(np.int64)
    pm = (order % nfre).astype(np.int64)

    spec_list = []
    for ip in range(NPMAX):
        active = pvalid[:, ip]
        if not active.any():
            break
        w2 = _grow_partition(fl, w1, llw3, pk[:, ip], pm[:, ip],
                             active, mij, nang_h)
        w1 = np.minimum(w1 + w2, 1.0)
        spec_list.append(fl * w2)

    npeak = pvalid[:, : len(spec_list)].sum(axis=1).astype(np.int64) \
        if spec_list else np.zeros(npts, np.int64)

    # unassigned wind-sector bins above noise become one extra partition
    # (fndprt.F90:283-309)
    llcosdiff = (coswdif < -0.4)[:, :, None]
    unasgn_extra = llcosdiff & (w1 <= 0.0) & \
        (fl > flnoise[:, None, None])
    has_extra = unasgn_extra.any(axis=(1, 2)) & (npeak < NPMAX)
    if has_extra.any():
        spec_list.append(fl * (unasgn_extra & has_extra[:, None, None]))
        npeak = npeak + has_extra

    if spec_list:
        assigned = np.zeros((npts, nang, nfre), dtype=bool)
        for s in spec_list:
            assigned |= s > 0.0
        sunasgn = np.where(assigned, 0.0, fl)
    else:
        sunasgn = fl.copy()

    dfim = np.asarray(tb.dfim, np.float64)
    dfimofr = np.asarray(tb.dfimofr, np.float64)
    costh = np.asarray(tb.costh, np.float64)
    sinth = np.asarray(tb.sinth, np.float64)

    if spec_list:
        ene, dire, per = _parmean(spec_list, dfim, dfimofr, costh, sinth)
    else:
        ene = np.zeros((npts, 1))
        dire = np.zeros((npts, 1))
        per = np.zeros((npts, 1))

    # total swell energy and unassigned stats (sep3tr.F90:262-300)
    flsw2 = np.maximum(fl1, EPSMIN) * swm
    ett = (flsw2.sum(axis=1) * dfim[None, :]).sum(axis=1)
    sumene = ene.sum(axis=1)
    e_un, d_un, p_un = _parmean([sunasgn], dfim, dfimofr, costh, sinth)
    e_un, d_un, p_un = e_un[:, 0], d_un[:, 0], p_un[:, 0]
    npkna = np.where(e_un > sumene, ntrain, ntrain - 1)

    add_un = (npeak < npkna) & (e_un > 0.0)
    if add_un.any():
        ene = np.concatenate([ene, np.where(add_un, e_un, 0.0)[:, None]], 1)
        dire = np.concatenate([dire, d_un[:, None]], 1)
        per = np.concatenate([per, p_un[:, None]], 1)
        npeak = npeak + add_un

    # drop weak / too-short partitions (sep3tr.F90:317-331)
    hsmin = HSMIN_INTER + HSMIN_SLOPE * per
    thrs = 0.0625 * hsmin**2
    frinvmij = 1.0 / np.asarray(tb.fr)[np.clip(mij, 0, nfre - 1)]
    weak = (ene < thrs) | (per < frinvmij[:, None])
    ene = np.where(weak, 0.0, ene)
    dire = np.where(weak, 0.0, dire)
    per = np.where(weak, 0.0, per)

    npk = (ene > 0.0).sum(axis=1)
    # fallback: total swell as single partition (sep3tr.F90:336-348)
    fallback = (npk <= 0) & (eswell > 0.0) & (fswell < fsea)
    if fallback.any() and ene.shape[1] > 0:
        ene[fallback, 0] = eswell[fallback]
        dire[fallback, 0] = thswell[fallback]
        per[fallback, 0] = 1.0 / np.maximum(fswell[fallback], EPSMIN)

    # sort by energy, take the first ntrain (sep3tr.F90:355-380)
    order = np.argsort(-ene, axis=1)[:, :ntrain]
    emt = np.take_along_axis(ene, order, axis=1)
    tht = np.take_along_axis(dire, order, axis=1)
    pmt = np.take_along_axis(per, order, axis=1)
    if emt.shape[1] < ntrain:
        padn = ntrain - emt.shape[1]
        emt = np.pad(emt, ((0, 0), (0, padn)))
        tht = np.pad(tht, ((0, 0), (0, padn)))
        pmt = np.pad(pmt, ((0, 0), (0, padn)))
    has = emt > 0.0

    # energy conservation: distribute the residual proportionally
    # (sep3tr.F90:389-410)
    sumetr = np.maximum(emt.sum(axis=1), EPSMIN)
    enex = np.where((npeak >= npkna),
                    np.maximum(ett - sumetr, 0.0) / sumetr, 0.0)
    emt = emt * (1.0 + enex[:, None])

    # empty trains: zero energy/period, wind direction (sep3tr.F90:167-178)
    default_dir = np.where(eswell > 0.0, thswell, wdwave)
    emt = np.where(has, emt, 0.0)
    tht = np.where(has, tht, default_dir[:, None])
    pmt = np.where(has, pmt, 0.0)
    return dict(emtrain=emt, thtrain=tht, pmtrain=pmt)
