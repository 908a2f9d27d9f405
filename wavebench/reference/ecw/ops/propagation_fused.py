"""Fused CTU propagation: weights + stencil in one memory pass.

Port of ``ecwam_tpu/ops/propagation_fused.py``.  The host-side builders
(:class:`FusedTables`, :func:`build_fused_tables`, :func:`lane_consts`)
are carried over as numpy; the segment algebra (:func:`segment_advect`)
and the segmented driver (:func:`advect_xla`) are plain PyTorch — the
reference version that the CUDA kernel of
``wavebench.reference.ecw/ops/propagation_cuda.py`` is held against.

Data layout: the "segmented row layout" (SRL).  Each latitude row is
stored as [wrap_w | row sea points | wrap_e | zero pads] padded to a
multiple of S, rows concatenated south→north with an S front pad and a
2S end pad.  Spectra are (nsrl, L) with L = nfre·nang lanes in k-major
order (lane l = k·nfre + m).  There is no 128-lane pad.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from wavebench.reference.ecw.core import constants as c

# obs slot order in the packed obs table
OBS_FIELDS = ("latS", "latN", "lonW", "lonE",
              "corNE", "corSE", "corSW", "corNW")
# grads pack fields (per point, refraction inputs; see propdot.F90:60-150)
GRADS_FIELDS = ("ddphi", "ddlam_dco", "duphi", "dvphi",
                "dulam_dco", "dvlam_dco", "omdd", "unused")


@dataclasses.dataclass(frozen=True)
class FusedTables:
    """Static host-built tables for the fused propagation of one domain."""

    S: int                   # segment size (points), multiple of 8
    EW: int                  # tap window width
    WD: int                  # wrap-copy depth per row side
    nseg: int                # number of body segments
    nsrl: int                # total SRL length incl front/end pads
    body0: int               # SRL position of the first body slot (= S)
    npts: int                # compact sea-point count this was built for
    land_index: int          # index of the zero/land slot in the source
    row_base: np.ndarray     # (ngy,) SRL start of each latitude row
    row_len: np.ndarray      # (ngy,) SRL storage length of each row
    # layout maps
    srl_src: np.ndarray      # (nsrl,) int32 → compact-ext source index
    from_srl: np.ndarray     # (npts,) int32 → SRL position of each point
    valid: np.ndarray        # (nsrl,) f32, 1 for owned sea points
    wrap_pos: np.ndarray     # (nwrap,) int32 SRL positions of wrap slots
    wrap_from: np.ndarray    # (nwrap,) int32 SRL positions they duplicate
    # per-segment window bases (SRL coords of window start)
    dn_base: np.ndarray      # (nseg,) int32
    up_base: np.ndarray      # (nseg,) int32
    # per-point FIR taps over the dn/up windows: position = base + i + e
    taps_dn: np.ndarray      # (nsrl, 3, EW) f32  [latS, corSE, corSW]
    taps_up: np.ndarray      # (nsrl, 3, EW) f32  [latN, corNE, corNW]
    sea_own: np.ndarray      # (nsrl, 2) f32  [west, east] klon is-sea flags
    cgland: np.ndarray       # (nsrl, 2) f32  dropped-tap weight sums [dn, up]
    # per-point geometry (pads benign)
    geom: np.ndarray         # (nsrl, 8) f32 [zdello, cosphm1, tanph,
    #                                         dp_s, dp_n, xdella, 0, 0]
    # obstructions, slot-major (pads 1.0)
    obs: np.ndarray          # (nsrl, 8, nfre_red) f32, OBS_FIELDS order


def _place_candidates(cand, wgt, rs, row_base, row_cnt, kxlt,
                      nland, WD, anchor_ref):
    """SRL positions for candidate block indices, using the periodic
    wrap-copy representation nearest ``anchor_ref``; land dropped.

    Row storage: position ``row_base[r] + q`` holds the row point with
    index ``(q - WD) mod cnt`` for ``q < 2*WD + cnt`` (zero pads after),
    i.e. WD wrap copies on each side."""
    w = np.asarray(wgt, dtype=np.float64) * np.ones(cand.shape[0])
    sea = cand != nland
    cs = np.clip(cand, 0, max(nland - 1, 0))
    r = kxlt[cs]
    cnt = np.maximum(row_cnt[r], 1)
    j = cs - rs[r]
    qm = WD + j
    off = anchor_ref - (row_base[r] + qm)
    t = np.rint(off / cnt).astype(np.int64)
    t_min = -(qm // cnt)
    t_max = (2 * WD + cnt - 1 - qm) // cnt
    t = np.clip(t, t_min, t_max)
    pos = row_base[r] + qm + t * cnt
    pos = np.where(sea, pos, anchor_ref)
    w = np.where(sea, w, 0.0)
    return pos, w, sea


def build_fused_tables(st, kxlt: np.ndarray, nfre_red: int,
                       S: int = 256, max_ew: int = 24,
                       land_index: int | None = None) -> FusedTables:
    """Build the SRL layout + tap tables from an (unpadded) StencilTables.

    ``st`` is ops.propagation.StencilTables over the real sea points;
    ``kxlt`` the per-point latitude row; ``land_index`` the index of the
    zero column in the source array ``srl_src`` gathers from (defaults to
    npts).  Raises ValueError when the grid's row structure needs a tap
    window wider than ``max_ew`` (caller falls back to the dense path).
    """
    npts = st.npts
    nland = st.nland
    if land_index is None:
        land_index = npts
    kxlt = np.asarray(kxlt, dtype=np.int64)
    ngy = int(kxlt.max()) + 2 if npts else 1
    row_cnt = np.bincount(kxlt, minlength=ngy).astype(np.int64)
    rs = np.concatenate([[0], np.cumsum(row_cnt)])   # row start block idx

    # wrap-copy depth: wrapped corner candidates reach up to the zdello
    # ratio of adjacent rows past the row ends (ctuw projections)
    zd_row = np.ones(ngy)
    has_row = row_cnt > 0
    zd_row[kxlt] = np.asarray(st.zdello_pt)
    ratio = np.ones(ngy)
    for k in range(ngy):
        if not has_row[k]:
            continue
        for kn in (k - 1, k + 1):
            if 0 <= kn < ngy and has_row[kn]:
                ratio[k] = max(ratio[k], zd_row[k] / zd_row[kn])
    WD = int(min(max(int(np.ceil(ratio.max())) + 2, 3), 12))

    # --- row placement: each row padded to a multiple of S --------------
    row_len = np.where(row_cnt > 0,
                       ((row_cnt + 2 * WD + S - 1) // S) * S, 0)
    row_base = np.zeros(ngy, dtype=np.int64)
    pos = S                                          # front pad
    for k in range(ngy):
        row_base[k] = pos
        pos += int(row_len[k])
    body_end = pos
    nseg = (body_end - S) // S
    nsrl = body_end + 2 * S                          # end pad

    srl_of_block = row_base[kxlt] + WD + (np.arange(npts) - rs[kxlt])

    # --- srl_src / valid / wraps ---------------------------------------
    srl_src = np.full(nsrl, land_index, dtype=np.int64)
    valid = np.zeros(nsrl, dtype=np.float64)
    srl_src[srl_of_block] = np.arange(npts)
    valid[srl_of_block] = 1.0
    wrap_pos, wrap_from = [], []
    for k in range(ngy):
        cnt = int(row_cnt[k])
        if cnt == 0:
            continue
        for q in list(range(WD)) + list(range(WD + cnt, 2 * WD + cnt)):
            b = rs[k] + (q - WD) % cnt
            srl_src[row_base[k] + q] = b
            wrap_pos.append(row_base[k] + q)
            wrap_from.append(srl_of_block[b])

    # --- per-point tap construction -------------------------------------
    i_seg = (srl_of_block - S) % S                   # index within segment
    seg_of_block = (srl_of_block - S) // S
    wlat = np.asarray(st.wlat, np.float64)
    wcor = np.asarray(st.wcor, np.float64)

    dn_fields = [
        (st.klat[:, 0, 0], wlat[:, 0], st.klat[:, 0, 1], 1.0 - wlat[:, 0]),
        (st.kcor[:, 1, 0], wcor[:, 1], st.kcor[:, 1, 1], 1.0 - wcor[:, 1]),
        (st.kcor[:, 2, 0], wcor[:, 2], st.kcor[:, 2, 1], 1.0 - wcor[:, 2]),
    ]
    up_fields = [
        (st.klat[:, 1, 0], wlat[:, 1], st.klat[:, 1, 1], 1.0 - wlat[:, 1]),
        (st.kcor[:, 0, 0], wcor[:, 0], st.kcor[:, 0, 1], 1.0 - wcor[:, 0]),
        (st.kcor[:, 3, 0], wcor[:, 3], st.kcor[:, 3, 1], 1.0 - wcor[:, 3]),
    ]

    i_row = np.arange(npts) - rs[kxlt]               # index within row

    def build_side(fields, drow):
        # cluster reference: the projected position within the target
        # row's storage (row k+drow), used to pick the nearest of a
        # candidate's canonical/wrap-copy representations
        kt = np.clip(kxlt + drow, 0, ngy - 1)
        tgt_cnt = np.maximum(row_cnt[kt], 1)
        proj = (i_row * tgt_cnt) // np.maximum(row_cnt[kxlt], 1)
        anchor_ref = row_base[kt] + WD + np.minimum(proj, tgt_cnt - 1)
        placed = []
        for cand0, w0, cand1, w1 in fields:
            p0 = _place_candidates(np.asarray(cand0), w0, rs, row_base,
                                   row_cnt, kxlt, nland, WD, anchor_ref)
            p1 = _place_candidates(np.asarray(cand1), w1, rs, row_base,
                                   row_cnt, kxlt, nland, WD, anchor_ref)
            placed.append((p0, p1))
        # window base per segment = min live tap position - i
        big = np.iinfo(np.int64).max
        allpos = [np.where(w != 0.0, p, big)
                  for pair in placed for (p, w, _) in pair]
        pmin = np.minimum.reduce(allpos)
        pmin = np.where(pmin == big, big, pmin - i_seg)
        base = np.full(nseg, big, dtype=np.int64)
        np.minimum.at(base, seg_of_block, pmin)
        base = np.where(base == big, np.arange(nseg) * S + S, base)
        # 8-align the window bases (TPU DMA slice constraint); the
        # residual shifts fold into the tap offsets
        base = np.maximum(base - base % 8, 0)
        ew = 1
        taps = []
        for pair in placed:
            es = []
            for (p, w, _) in pair:
                e = p - (base[seg_of_block] + i_seg)
                e = np.where(w != 0.0, e, 0)
                if (e < 0).any():
                    raise AssertionError("negative tap offset")
                ew = max(ew, int(e.max(initial=0)) + 1)
                es.append((e, w))
            taps.append(es)
        return base, taps, placed, ew

    dn_base, dn_taps, dn_placed, ew_dn = build_side(dn_fields, -1)
    up_base, up_taps, up_placed, ew_up = build_side(up_fields, +1)
    EW = ((max(ew_dn, ew_up, 4) + 3) // 4) * 4
    if EW > max_ew:
        raise ValueError(
            f"fused propagation needs tap window {EW} > {max_ew}; "
            "row structure too irregular for the fused path")

    def tap_tensor(taps_list):
        t = np.zeros((nsrl, 3, EW), dtype=np.float64)
        for f, es in enumerate(taps_list):
            for (e, w) in es:
                # += : candidates may coincide (regular grids)
                np.add.at(t, (srl_of_block, f, e), w)
        return t

    taps_dn = tap_tensor(dn_taps)
    taps_up = tap_tensor(up_taps)

    # dropped-tap (land) weight sums of the latS/latN interpolations: the
    # group-velocity interpolation reads CGROUP at the land slot instead
    # of zero (ctuw.F90 uses the NSUP+1 deep-water value)
    cgland = np.zeros((nsrl, 2), dtype=np.float64)
    for side, placed, w_near in ((0, dn_placed, wlat[:, 0]),
                                 (1, up_placed, wlat[:, 1])):
        (p0, w0, s0), (p1, w1, s1) = placed[0]
        cgland[srl_of_block, side] = (np.where(s0, 0.0, w_near)
                                      + np.where(s1, 0.0, 1.0 - w_near))

    # own-row (klon) flags; verify the structural adjacency assumption
    sea_own = np.zeros((nsrl, 2), dtype=np.float64)
    for ic in range(2):
        kl = np.asarray(st.klon[:, ic])
        expect = srl_of_block + (1 if ic else -1)
        p, w, sea = _place_candidates(kl, 1.0, rs, row_base, row_cnt,
                                      kxlt, nland, WD, expect)
        if not ((~sea) | (p == expect)).all():
            raise AssertionError("klon neighbour not SRL-adjacent")
        sea_own[srl_of_block, ic] = sea.astype(np.float64)

    if (int(dn_base.min()) < 0 or int(up_base.min()) < 0
            or int((dn_base + S + EW).max()) > nsrl
            or int((up_base + S + EW).max()) > nsrl):
        raise AssertionError("window out of SRL bounds")

    # --- geometry (pads benign: zdello=1 avoids 1/0) --------------------
    geom = np.zeros((nsrl, 8), dtype=np.float64)
    geom[:, 0] = 1.0
    geom[:, 1] = 1.0
    geom[srl_of_block, 0] = st.zdello_pt
    geom[srl_of_block, 1] = st.cosphm1_pt
    geom[srl_of_block, 2] = st.tanph_pt
    geom[srl_of_block, 3] = st.dp[:, 0]
    geom[srl_of_block, 4] = st.dp[:, 1]
    geom[:, 5] = st.xdella

    # --- obstructions, slot-major (pads 1.0) ----------------------------
    obs = np.ones((nsrl, 8, nfre_red), dtype=np.float64)
    obs_src = {
        "latS": st.obslat[:, :, 0], "latN": st.obslat[:, :, 1],
        "lonW": st.obslon[:, :, 0], "lonE": st.obslon[:, :, 1],
        "corNE": st.obscor[:, :, 0], "corSE": st.obscor[:, :, 1],
        "corSW": st.obscor[:, :, 2], "corNW": st.obscor[:, :, 3],
    }
    for slot, name in enumerate(OBS_FIELDS):
        obs[srl_of_block, slot, :] = obs_src[name].T[:, :nfre_red]

    return FusedTables(
        S=S, EW=int(EW), WD=int(WD), nseg=int(nseg), nsrl=int(nsrl),
        body0=S, npts=npts, land_index=int(land_index),
        row_base=row_base.astype(np.int64),
        row_len=row_len.astype(np.int64),
        srl_src=srl_src.astype(np.int32),
        from_srl=srl_of_block.astype(np.int32),
        valid=valid,
        wrap_pos=np.asarray(wrap_pos, np.int32),
        wrap_from=np.asarray(wrap_from, np.int32),
        dn_base=dn_base.astype(np.int32), up_base=up_base.astype(np.int32),
        taps_dn=taps_dn, taps_up=taps_up,
        sea_own=sea_own, cgland=cgland, geom=geom, obs=obs)


# ---------------------------------------------------------------------------
# lane constants (k-major order: lane l = k*nfre + m)
# ---------------------------------------------------------------------------

def lane_consts(tb, delpro_per_freq, nfre: int, dtype=np.float64) -> dict:
    """Per-lane constant vectors for the weight algebra over ``nfre``
    frequencies.  ``delpro_per_freq`` is (nfre,): the advection timestep
    per frequency (fast-wave bands use a shorter one,
    propag_wam.F90:247-313).  Returned as numpy; cast at use site."""
    nang = tb.nang
    sinth = np.asarray(tb.sinth, np.float64)
    costh = np.asarray(tb.costh, np.float64)
    kp1 = np.roll(np.arange(nang), -1)
    km1 = np.roll(np.arange(nang), 1)
    dt_f = np.asarray(delpro_per_freq, np.float64)[:, None]
    ones_f = np.ones((nfre, 1))

    def lane(vec_k, vec_f=None):
        # k-major lane order: lane l = k*nfre + m
        a = vec_k[:, None] * ((vec_f if vec_f is not None else ones_f)
                              .reshape(1, nfre))
        return np.ascontiguousarray(a.reshape(-1), dtype)

    delth0_f = 0.25 * dt_f / tb.delth
    fr = np.asarray(tb.fr, np.float64)[:nfre]
    delfr0_f = 0.25 * dt_f / ((tb.fratio - 1.0) * c.ZPI)
    out = dict(
        s=lane(sinth), cth=lane(costh),
        east=lane((sinth >= 0.0).astype(np.float64)),
        north=lane((costh >= 0.0).astype(np.float64)),
        dt=lane(np.ones(nang), dt_f),
        # great-circle turning bases (ctuw.F90:345-420), delth0 folded in
        sp=lane((sinth + sinth[kp1]) / c.R_EARTH, delth0_f),
        sm=lane((sinth + sinth[km1]) / c.R_EARTH, delth0_f),
        # depth-refraction bases (thdd = sd·ddphi − cd·ddlam·dco,
        # propdot.F90:105-118), pair-summed with delth0 folded in
        sd_p=lane(sinth + sinth[kp1], delth0_f),
        cd_p=lane(costh + costh[kp1], delth0_f),
        sd_m=lane(sinth + sinth[km1], delth0_f),
        cd_m=lane(costh + costh[km1], delth0_f),
        # current-refraction bases (thdc, same pair-sum structure)
        ss_p=lane(sinth**2 + sinth[kp1]**2, delth0_f),
        sc_p=lane(sinth * costh + sinth[kp1] * costh[kp1], delth0_f),
        cc_p=lane(costh**2 + costh[kp1]**2, delth0_f),
        ss_m=lane(sinth**2 + sinth[km1]**2, delth0_f),
        sc_m=lane(sinth * costh + sinth[km1] * costh[km1], delth0_f),
        cc_m=lane(costh**2 + costh[km1]**2, delth0_f),
        # σ̇ separable bases (propdot.F90:141-150)
        nf_sc=lane(-sinth * costh), nf_cc=lane(-costh * costh),
        nf_ss=lane(-sinth * sinth),
        # frequency-shift constants (ctuw.F90:430-470)
        dfp=lane(np.ones(nang), delfr0_f / fr[:, None]),
        dfm=lane(np.ones(nang), delfr0_f
                 / fr[np.maximum(np.arange(nfre) - 1, 0), None]),
        m_first=lane(np.ones(nang),
                     (np.arange(nfre) == 0).astype(np.float64)[:, None]),
        m_last=lane(np.ones(nang),
                    (np.arange(nfre) == nfre - 1)
                    .astype(np.float64)[:, None]),
    )
    out["fratio"] = float(tb.fratio)
    return out


# ---------------------------------------------------------------------------
# layout helpers
# ---------------------------------------------------------------------------

def to_lanes(a, nfre: int, nang: int):
    """(nang, nfre_all, npts)[:, :nfre] → (npts, L) k-major lanes."""
    a = a[:, :nfre].permute(2, 0, 1)
    return a.reshape(a.shape[0], nfre * nang)


def from_lanes(a, nfre: int, nang: int):
    """(npts, L) → (nang, nfre, npts)."""
    return a.reshape(a.shape[0], nang, nfre).permute(1, 2, 0)


def roll_k(f, d, nfre):
    """f at direction k+d (d=±1); k-major lanes make the periodic angle
    roll a single whole-width lane roll by ∓nfre."""
    return torch.roll(f, -d * nfre, dims=-1)


def shift_m(f, d, nfre, lc):
    """f at frequency m+d (d=±1), edges clamped (ctuw.F90 MM1/MP1)."""
    if d == +1:
        r = torch.roll(f, -1, dims=-1)
        return lc["m_last"] * f + (1.0 - lc["m_last"]) * r
    r = torch.roll(f, 1, dims=-1)
    return lc["m_first"] * f + (1.0 - lc["m_first"]) * r


# ---------------------------------------------------------------------------
# segment algebra — the fused CTUW+PROPAGS2 update
# ---------------------------------------------------------------------------

def segment_advect(f_own, f_dn_win, f_up_win, f_own_win,
                   cg_own_win, cg_dn_win, cg_up_win,
                   taps_dn, taps_up, sea_own, cgland_w, geom, obs,
                   lc, cg_land_lane, nang, nfre, irefra,
                   uv=None, grads=None, pf=None, with_cfl=False):
    """One (batch of) segment(s) of the fused CTU update.

    Shapes (leading batch dims allowed):
      f_own (..., S, L);  f_dn_win / f_up_win (..., S+EW, L);
      f_own_win (..., S+2, L);  cg_* like f but nfre lanes;
      taps_dn/up (..., S, 3, EW);  sea_own/cgland_w (..., S, 2);
      geom (..., S, 8); obs (..., S, 8, nfre); uv (..., S, 2);
      grads (..., S, 8) refraction gradients (GRADS_FIELDS order,
      current terms pre-clipped and CFL-masked);
      pf (..., S, 3, nfre) per-freq env [omosnh2kd, cg·wavnum, omos·wavnum].
    Returns the updated (..., S, L) spectrum (valid mask NOT applied) and,
    when ``with_cfl``, a (..., S) CFL-violation mask (ctuw.F90:238-300);
    ``with_cfl="stats"`` adds the per-row largest east/west, north/south
    and outflow Courant numbers.
    """
    S = f_own.shape[-2]
    EW = taps_dn.shape[-1]

    def fir(win, taps):
        acc = taps[..., 0:1] * win[..., 0:S, :]
        for e in range(1, EW):
            acc = acc + taps[..., e:e + 1] * win[..., e:e + S, :]
        return acc

    # spectral FIR values
    v_latS = fir(f_dn_win, taps_dn[..., 0, :])
    v_corSE = fir(f_dn_win, taps_dn[..., 1, :])
    v_corSW = fir(f_dn_win, taps_dn[..., 2, :])
    v_latN = fir(f_up_win, taps_up[..., 0, :])
    v_corNE = fir(f_up_win, taps_up[..., 1, :])
    v_corNW = fir(f_up_win, taps_up[..., 2, :])
    sea_w = sea_own[..., 0:1]
    sea_e = sea_own[..., 1:2]
    v_W = sea_w * f_own_win[..., 0:S, :]
    v_E = sea_e * f_own_win[..., 2:S + 2, :]

    # group-velocity values in (..., S, nfre) space
    cg_o = cg_own_win[..., 1:S + 1, :]
    cgl = cg_land_lane
    cg_W = sea_w * cg_own_win[..., 0:S, :] + (1.0 - sea_w) * cgl
    cg_E = sea_e * cg_own_win[..., 2:S + 2, :] + (1.0 - sea_e) * cgl
    cg_S = fir(cg_dn_win, taps_dn[..., 0, :]) + cgland_w[..., 0:1] * cgl
    cg_N = fir(cg_up_win, taps_up[..., 0, :]) + cgland_w[..., 1:2] * cgl

    z = geom[..., 0:1]
    ci = geom[..., 1:2]
    tp = geom[..., 2:3]
    dp_s = geom[..., 3:4]
    dp_n = geom[..., 4:5]
    xdella = geom[..., 5:6]
    cmtodeg = 360.0 / c.CIRC

    def expand(x):
        # k-major lanes: per-(point,freq) fields tile over angle groups
        return x.repeat((1,) * (x.dim() - 1) + (nang,))

    # expanded edge velocities (ctuw.F90:170-230)
    xw = expand(0.5 * (cg_o + cg_W) * ci) * lc["s"]
    xe = expand(0.5 * (cg_o + cg_E) * ci) * lc["s"]
    ys = expand(0.5 * (cg_o + dp_s * cg_S)) * lc["cth"]
    yn = expand(0.5 * (cg_o + dp_n * cg_N)) * lc["cth"]

    have_cur = irefra in (2, 3) and uv is not None
    if have_cur:
        u = uv[..., 0:1]
        v = uv[..., 1:2]

        def updown(cgx, vadd):
            # the current splits each edge's displacement into its
            # upstream and downstream parts
            rel = cgx + vadd
            iss = (torch.sign(rel) == torch.sign(cgx)).to(cgx.dtype)
            ad = torch.abs(lc["dt"] * rel * cmtodeg)
            return ad, ad * iss, ad * (1.0 - iss)
        adx_w, dxup_w, dxdw_w = updown(xw, u * ci)
        adx_e, dxup_e, dxdw_e = updown(xe, u * ci)
        ady_s, dyup_s, dydw_s = updown(ys, v * 0.5 * (1.0 + dp_s))
        ady_n, dyup_n, dydw_n = updown(yn, v * 0.5 * (1.0 + dp_n))
    else:
        # without currents the whole displacement is upstream
        adx_w = dxup_w = torch.abs(lc["dt"] * xw * cmtodeg)
        adx_e = dxup_e = torch.abs(lc["dt"] * xe * cmtodeg)
        ady_s = dyup_s = torch.abs(lc["dt"] * ys * cmtodeg)
        ady_n = dyup_n = torch.abs(lc["dt"] * yn * cmtodeg)
        zero = torch.zeros((), dtype=f_own.dtype, device=f_own.device)
        dxdw_w = dxdw_e = dydw_s = dydw_n = zero
    east = lc["east"]
    north = lc["north"]

    def sel(a, b, m):
        return m * a + (1.0 - m) * b

    dxup_1 = sel(dxup_w, dxup_e, east)
    dxup_2 = sel(dxup_e, dxup_w, east)
    dxdw_1 = sel(dxdw_w, dxdw_e, east)
    dxdw_2 = sel(dxdw_e, dxdw_w, east)
    dyup_1 = sel(dyup_s, dyup_n, north)
    dyup_2 = sel(dyup_n, dyup_s, north)
    dydw_1 = sel(dydw_s, dydw_n, north)
    dydw_2 = sel(dydw_n, dydw_s, north)

    aream1 = 1.0 / (z * xdella)
    dxx = z - dxup_2 - dxdw_1
    dyy = xdella - dyup_2 - dydw_1

    w_jyo1 = dxx * dyup_1 * aream1
    w_jyo2 = dxx * dydw_2 * aream1
    w_latS = sel(w_jyo1, w_jyo2, north)
    w_latN = sel(w_jyo2, w_jyo1, north)
    w_jxo1 = dyy * dxup_1 * aream1
    w_jxo2 = dyy * dxdw_2 * aream1
    w_lonW = sel(w_jxo1, w_jxo2, east)
    w_lonE = sel(w_jxo2, w_jxo1, east)

    wg1 = dxup_1 * dyup_1 * aream1
    wg2 = dxdw_2 * dyup_1 * aream1
    wg3 = dxup_1 * dydw_2 * aream1
    wg4 = dxdw_2 * dydw_2 * aream1
    # physical-corner weights via the quadrant → logical-slot map
    # (ctuwupdt.F90:95-150 JXO/JYO/KCR)
    w_SW = sel(sel(wg1, wg2, east), sel(wg3, wg4, east), north)
    w_SE = sel(sel(wg2, wg1, east), sel(wg4, wg3, east), north)
    w_NW = sel(sel(wg3, wg4, east), sel(wg1, wg2, east), north)
    w_NE = sel(sel(wg4, wg3, east), sel(wg2, wg1, east), north)

    sumwn = (z * (dydw_1 + dyup_2) + xdella * (dxup_2 + dxdw_1)
             - (dxdw_1 + dxup_2) * (dydw_1 + dyup_2)) * aream1

    # --- direction turning (ctuw.F90:345-420) ---------------------------
    cgo_l = expand(cg_o)
    dthp = tp * lc["sp"] * cgo_l
    dthm = tp * lc["sm"] * cgo_l
    if irefra in (1, 3) and grads is not None and pf is not None:
        ddphi = grads[..., 0:1]
        ddlam_dco = grads[..., 1:2]
        drdp = ddphi * lc["sd_p"] - ddlam_dco * lc["cd_p"]
        drdm = ddphi * lc["sd_m"] - ddlam_dco * lc["cd_m"]
        omos_l = expand(pf[..., 0, :])
        dthp = dthp + omos_l * drdp
        dthm = dthm + omos_l * drdm
    if have_cur and grads is not None:
        duphi = grads[..., 2:3]
        dvphi = grads[..., 3:4]
        dulam_dco = grads[..., 4:5]
        dvlam_dco = grads[..., 5:6]
        dthp = dthp + (duphi * lc["ss_p"] + dvphi * lc["sc_p"]
                       - dulam_dco * lc["sc_p"] - dvlam_dco * lc["cc_p"])
        dthm = dthm + (duphi * lc["ss_m"] + dvphi * lc["sc_m"]
                       - dulam_dco * lc["sc_m"] - dvlam_dco * lc["cc_m"])

    wkpmn0 = (dthp + torch.abs(dthp)) + (torch.abs(dthm) - dthm)
    w_km1 = dthm + torch.abs(dthm)
    w_kp1 = -dthp + torch.abs(dthp)
    sumwn = sumwn + wkpmn0

    # --- frequency shifting (current refraction, ctuw.F90:430-470) ------
    wm_terms = None
    if have_cur and grads is not None and pf is not None:
        cgwav = expand(pf[..., 1, :])
        omoswav = expand(pf[..., 2, :])
        duphi = grads[..., 2:3]
        dvphi = grads[..., 3:4]
        dulam_dco = grads[..., 4:5]
        dvlam_dco = grads[..., 5:6]
        omdd = grads[..., 6:7]
        sdot_nf = (duphi * lc["nf_sc"] + dvphi * lc["nf_cc"]
                   + dulam_dco * lc["nf_ss"] + dvlam_dco * lc["nf_sc"])
        sdot = sdot_nf * cgwav + omdd * omoswav
        sd_mp1 = shift_m(sdot, +1, nfre, lc)
        sd_mm1 = shift_m(sdot, -1, nfre, lc)
        dthp_f = (sdot + sd_mp1) * lc["dfp"]
        dthm_f = (sdot + sd_mm1) * lc["dfm"]
        wmpmn0 = (dthp_f + torch.abs(dthp_f)) + (torch.abs(dthm_f) - dthm_f)
        sumwn = sumwn + wmpmn0
        w_mm1 = (dthm_f + torch.abs(dthm_f)) * lc["fratio"]
        w_mp1 = (-dthp_f + torch.abs(dthp_f)) / lc["fratio"]
        wm_terms = (w_mm1, w_mp1)

    # --- assemble (propags2.F90:49-130) ---------------------------------
    ob = [expand(obs[..., slot, :]) for slot in range(8)]
    out = (1.0 - sumwn) * f_own
    out = out + w_latS * ob[0] * v_latS + w_latN * ob[1] * v_latN
    out = out + w_lonW * ob[2] * v_W + w_lonE * ob[3] * v_E
    out = out + (w_NE * ob[4] * v_corNE + w_SE * ob[5] * v_corSE
                 + w_SW * ob[6] * v_corSW + w_NW * ob[7] * v_corNW)
    out = out + w_km1 * roll_k(f_own, -1, nfre)
    out = out + w_kp1 * roll_k(f_own, +1, nfre)
    if wm_terms is not None:
        out = out + wm_terms[0] * shift_m(f_own, -1, nfre, lc)
        out = out + wm_terms[1] * shift_m(f_own, +1, nfre, lc)

    if not with_cfl:
        return out
    bad = ((torch.maximum(adx_w, adx_e) > z)
           | (torch.maximum(ady_s, ady_n) > xdella)
           | (sumwn > 1.0) | (sumwn < 0.0))
    if with_cfl == "stats":
        # CHECKCFL-role diagnostics (checkcfl.F90:74-210): the largest
        # east/west, north/south and total-outflow Courant numbers
        ratio_x = torch.amax(torch.maximum(adx_w, adx_e) / z, dim=-1)
        ratio_y = torch.amax(torch.maximum(ady_s, ady_n) / xdella, dim=-1)
        return out, bad.any(dim=-1), (ratio_x, ratio_y,
                                      torch.amax(sumwn, dim=-1))
    return out, bad.any(dim=-1)


# ---------------------------------------------------------------------------
# plain driver: chunked segment windows via index gathers
# ---------------------------------------------------------------------------

def _windows(arr, bases, width):
    """(nb, width, lanes) windows of ``arr`` at row offsets ``bases``."""
    idx = bases[:, None] + torch.arange(width, device=arr.device)[None, :]
    return arr[idx]


def advect_xla(f_srl, cg_srl, dev, lc, cg_land_lane, *,
               nang: int, nfre: int, irefra: int, S: int, EW: int,
               with_cfl=False, seg_chunk: int = 64):
    """Fused CTU advection over the whole SRL domain (plain PyTorch; the
    name follows the reference's XLA formulation).

    ``dev`` is the table dict from :func:`device_tables` (plus ``grads``
    and ``pf`` for irefra ≥ 1 and ``uv`` for irefra 2/3); ``lc`` the
    lane-constant dict of tensors.  Returns the updated (nsrl, L)
    spectrum with the wrap/pad slots zeroed and, with ``with_cfl``, the
    per-SRL-slot CFL mask (valid slots only); ``with_cfl="stats"`` adds
    the largest east/west, north/south and outflow Courant numbers over
    the valid slots.
    """
    nsrl, L = f_srl.shape
    nseg = (nsrl - 3 * S) // S
    out = torch.zeros_like(f_srl)
    cfl = torch.zeros(nsrl, dtype=torch.bool, device=f_srl.device)
    stats = torch.zeros((3, nsrl), dtype=f_srl.dtype, device=f_srl.device)
    seg_base = S + torch.arange(nseg, device=f_srl.device,
                                dtype=torch.int64) * S
    for s0 in range(0, nseg, seg_chunk):
        s1 = min(nseg, s0 + seg_chunk)
        ns = s1 - s0
        rows = slice(S + s0 * S, S + s1 * S)

        def seg(name, inner):
            return dev[name][rows].reshape((ns, S) + inner)

        def opt(name, inner):
            return seg(name, inner) if name in dev else None

        dn = dev["dn_base"][s0:s1].long()
        up = dev["up_base"][s0:s1].long()
        own = seg_base[s0:s1] - 1
        res = segment_advect(
            f_srl[rows].reshape(ns, S, L),
            _windows(f_srl, dn, S + EW), _windows(f_srl, up, S + EW),
            _windows(f_srl, own, S + 2),
            _windows(cg_srl, own, S + 2), _windows(cg_srl, dn, S + EW),
            _windows(cg_srl, up, S + EW),
            seg("taps_dn", (3, EW)), seg("taps_up", (3, EW)),
            seg("sea_own", (2,)), seg("cgland", (2,)), seg("geom", (8,)),
            seg("obs", (8, nfre)), lc, cg_land_lane, nang, nfre, irefra,
            uv=opt("uv", (2,)), grads=opt("grads", (8,)),
            pf=opt("pf", (3, nfre)), with_cfl=with_cfl)
        valid = dev["valid"][rows]
        if with_cfl:
            cfl[rows] = res[1].reshape(-1) & (valid > 0)
            if with_cfl == "stats":
                stats[:, rows] = torch.stack(res[2]).reshape(3, -1)
            res = res[0]
        out[rows] = res.reshape(ns * S, L) * valid[:, None]
    if not with_cfl:
        return out
    if with_cfl == "stats":
        valid = dev["valid"] > 0
        return out, cfl, tuple(
            torch.where(valid, r, torch.zeros_like(r)).max() for r in stats)
    return out, cfl


def device_tables(ft: FusedTables, dtype, device) -> dict:
    """FusedTables → tensor dict for :func:`advect_xla` and the CUDA
    kernel (static parts only; uv/grads/pf added by the caller)."""
    def i32(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.int32,
                               device=device)

    def flt(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    return dict(
        srl_src=i32(ft.srl_src).long(), from_srl=i32(ft.from_srl).long(),
        valid=flt(ft.valid),
        wrap_pos=i32(ft.wrap_pos).long(), wrap_from=i32(ft.wrap_from).long(),
        dn_base=i32(ft.dn_base), up_base=i32(ft.up_base),
        taps_dn=flt(ft.taps_dn), taps_up=flt(ft.taps_up),
        sea_own=flt(ft.sea_own), cgland=flt(ft.cgland), geom=flt(ft.geom),
        obs=flt(ft.obs))


def refresh_wraps(f_srl, dev):
    """Re-duplicate the row-wrap slots after an advection pass zeroed
    them (the stencil's periodic-longitude reads go through them).
    Updates ``f_srl`` in place (wrap sources are never wrap slots, so
    the gather reads only unmodified rows) and returns it."""
    f_srl[dev["wrap_pos"]] = f_srl[dev["wrap_from"]]
    return f_srl
