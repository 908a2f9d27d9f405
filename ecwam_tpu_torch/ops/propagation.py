"""Great-circle CTU (corner-transport-upstream) advection on the reduced grid.

Port of ``ecwam_tpu/ops/propagation.py``:
  - host numpy, float64: the constructors of the reference's neighbour tables
    and interpolation weights (propconnect.F90:44-950,
    ctuwini.F90:45-125) and GRADI (gradi.F90:60-185);
  - GRADI again in float64 on the tensors' device, on a stencil gathered to
    the rows that need it (:func:`gradi_stencil`, :func:`gradi_rows`), for
    the fused step's hourly current refresh; the host form stays its
    oracle;
  - plain PyTorch on the tensors' device: PROPDOT's refraction rates
    (propdot.F90:60-150), CTUW's weights with the obstruction
    coefficients and the CFL flag (ctuw.F90:90-745) and PROPAGS2's
    weighted gather stencil (propags2.F90:49-130).  In the reference these
    are XLA code outside any Pallas kernel; the dense ``WaveModel`` runs
    them in its ``cached`` and ``otf`` weight modes.

Layout: spectra (nang, nf, npts+1) with the last slot the land point.
The weights are stored slot-major, one contiguous (nang, nf, npts) plane
per slot of one tensor (:data:`SLOTS`), where the reference keeps the
slots innermost ((nang, nf, npts, 4, 2) for the corners): a slot's plane
is then read without striding over the others' values.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ecwam_tpu_torch.core import constants as c
from ecwam_tpu_torch.core.grid import WaveGrid, SeaPointBlock


@dataclasses.dataclass(frozen=True)
class StencilTables:
    """Static propagation stencil for one (sub)domain; all indices 0-based,
    ``nland = npts`` is the land slot."""

    npts: int
    nland: int
    # neighbour indices
    klat: np.ndarray      # (npts, 2, 2)  [ic: 0=south,1=north][icl: 2 candidates]
    klon: np.ndarray      # (npts, 2)     [0=west, 1=east]
    kcor: np.ndarray      # (npts, 4, 2)  physical corners 0=NE,1=SE,2=SW,3=NW
    # interpolation weights (land-adjusted, ctuwini.F90:45-75)
    wlat: np.ndarray      # (npts, 2)
    wlatm1: np.ndarray
    wcor: np.ndarray      # (npts, 4)
    wcorm1: np.ndarray
    dp: np.ndarray        # (npts, 2) cosφ(row±1)/cosφ(row)
    # geometry
    zdello_pt: np.ndarray   # (npts,) lon increment of the point's row (deg)
    xdella: float           # lat increment (deg)
    cosphm1_pt: np.ndarray  # (npts,) 1/cosφ
    tanph_pt: np.ndarray    # (npts,) tanφ (polar-capped, readmdlconf.F90:158)
    # per-direction static selectors (True where sinth>=0 / costh>=0)
    # derived on the fly from tables in ctuw
    # obstruction coefficients (1 = open water)
    obslat: np.ndarray    # (nfre_red, npts, 2)
    obslon: np.ndarray
    obscor: np.ndarray    # (nfre_red, npts, 4) per physical corner


def build_stencil(grid: WaveGrid, blk: SeaPointBlock, nfre_red: int,
                  obstructions=None) -> StencilTables:
    """Build neighbour tables + weights (propconnect.F90 + ctuwini.F90).

    Fully vectorized over the sea-point block (the per-point Python loop
    cost ~75 s at O512 model build; this form is bit-identical — pinned
    during the rewrite on octahedral/regular grids with land — and runs
    in under a second)."""
    npts = blk.nsea
    nland = npts
    ngy = grid.ngy
    nl = np.asarray(grid.nlonrgg, np.int64)
    zd = np.asarray(grid.zdello, np.float64)
    iper = grid.iper
    irgg = grid.irgg
    g2b = blk.grid2blk            # (ngy, ngx) → block index or -1
    ngx = g2b.shape[1]

    i = blk.ixlg.astype(np.int64)
    k = blk.kxlt.astype(np.int64)
    d0 = i * zd[k]
    zk = zd[k]

    def nint(x):
        # Fortran NINT for the x >= -0.5 range used here
        return np.floor(x + 0.5).astype(np.int64)

    def sea_at(iv, kv):
        icl = np.clip(iv, 0, ngx - 1)
        return (iv >= 0) & (iv < nl[kv]) & (g2b[kv, icl] >= 0)

    def blk_at(iv, kv, ok):
        icl = np.clip(iv, 0, ngx - 1)
        return np.where(ok & sea_at(iv, kv), g2b[kv, icl], nland)

    klat = np.full((npts, 2, 2), nland, dtype=np.int64)
    klon = np.full((npts, 2), nland, dtype=np.int64)
    kcor = np.full((npts, 4, 2), nland, dtype=np.int64)
    wlat = np.ones((npts, 2))
    wcor = np.ones((npts, 4))

    # ---- KLAT + WLAT (propconnect.F90:55-135, :680-900)
    for ic in range(2):
        krow = k + (2 * ic - 1)
        inb = (krow >= 0) & (krow < ngy)
        krc = np.clip(krow, 0, ngy - 1)
        xm = d0 / zd[krc]
        imin0 = nint(xm)
        klat[:, ic, 0] = blk_at(imin0, krc, inb)
        if irgg:
            i2 = np.where(xm <= imin0, np.maximum(imin0 - 1, 0),
                          np.minimum(imin0 + 1, nl[krc] - 1))
            klat[:, ic, 1] = blk_at(i2, krc, inb)
        else:
            klat[:, ic, 1] = klat[:, ic, 0]

        if irgg:
            d3 = d0 - 0.5 * zk
            d5 = d0 + 0.5 * zk
            xp = imin0 * zd[krc]
            d4 = xp - 0.5 * zd[krc]
            d6 = xp + 0.5 * zd[krc]
            w_le = np.where((d4 <= d3) | (d6 <= d5), 1.0,
                            np.minimum(1.0, (zk - (d4 - d3)) / zk))
            w_gt = np.where((d4 >= d3) | (d6 >= d5), 1.0,
                            np.minimum(1.0, (zk - (d5 - d6)) / zk))
            wlat[:, ic] = np.where(inb, np.where(d0 <= xp, w_le, w_gt),
                                   1.0)

    # ---- KLON (propconnect.F90:140-170), periodic in lon
    allp = np.ones(npts, bool)
    iw = np.where(i > 0, i - 1, np.where(iper, nl[k] - 1, -1))
    klon[:, 0] = blk_at(iw, k, allp)
    ie = np.where(i < nl[k] - 1, i + 1, np.where(iper, 0, -1))
    klon[:, 1] = blk_at(ie, k, allp)

    # ---- KCOR + WCOR (propconnect.F90:183-375): physical corners
    # 0=NE(k+1,east) 1=SE(k-1,east) 2=SW(k-1,west) 3=NW(k+1,west)
    for icr, (dk, dsign) in enumerate(
            ((1, +1), (-1, +1), (-1, -1), (1, -1))):
        krow = k + dk
        inb = (krow >= 0) & (krow < ngy)
        krc = np.clip(krow, 0, ngy - 1)
        nlr = nl[krc]
        xl = d0 + dsign * zk
        xm = xl / zd[krc]
        imin0 = nint(xm)
        if iper:
            low = imin0 < 0
            imin0 = np.where(low, imin0 + nlr, imin0)
            xm = np.where(low, xm + nlr, xm)
            high = imin0 > nlr - 1
            imin0 = np.where(high, imin0 - nlr, imin0)
            xm = np.where(high, xm - nlr, xm)
        valid0 = (imin0 >= 0) & (imin0 <= nlr - 1)
        kcor[:, icr, 0] = blk_at(imin0, krc, inb & valid0)
        i2 = np.where(xm <= imin0,
                      np.where(imin0 <= 0, nlr - 1, imin0 - 1),
                      np.where(imin0 >= nlr - 1, 0, imin0 + 1))
        kcor[:, icr, 1] = blk_at(i2, krc, inb & valid0)

        if irgg:
            xll = xl - 0.5 * zk
            xlr = xl + 0.5 * zk
            imin0w = nint(xl / zd[krc])          # unwrapped (reference)
            xp = imin0w * zd[krc]
            xpl = xp - 0.5 * zd[krc]
            xpr = xp + 0.5 * zd[krc]
            d1 = np.where((xpl > xll) & (xpr < xlr), zk,
                          np.minimum(xlr, xpr) - np.maximum(xll, xpl))
            wcor[:, icr] = np.where(inb, np.minimum(1.0, d1 / zk), 1.0)

    # ---- land adjustment (ctuwini.F90:45-75)
    for ic in range(2):
        nearest_land = klat[:, ic, 0] == nland
        second_land = klat[:, ic, 1] == nland
        wlat[:, ic] = np.where(
            nearest_land & (wlat[:, ic] <= 0.75), 0.0, wlat[:, ic])
        wlat[:, ic] = np.where(
            ~nearest_land & second_land & (wlat[:, ic] >= 0.5),
            1.0, wlat[:, ic])
    for icr in range(4):
        nearest_land = kcor[:, icr, 0] == nland
        second_land = kcor[:, icr, 1] == nland
        wcor[:, icr] = np.where(
            nearest_land & (wcor[:, icr] <= 0.75), 0.0, wcor[:, icr])
        wcor[:, icr] = np.where(
            ~nearest_land & second_land & (wcor[:, icr] > 0.5),
            1.0, wcor[:, icr])

    # ---- DP metric factor (ctuwini.F90:112-121)
    kxlt = blk.kxlt.astype(int)
    cosph = grid.cosph
    dp = np.ones((npts, 2))
    for ic in range(2):
        kk = np.clip(kxlt + (2 * (ic + 1) - 3), 0, ngy - 1)
        dp[:, ic] = cosph[kk] / cosph[kxlt]

    if obstructions is None:
        obslat = np.ones((nfre_red, npts, 2))
        obslon = np.ones((nfre_red, npts, 2))
        obscor = np.ones((nfre_red, npts, 4))
    else:
        obslat, obslon, obscor = obstructions

    return StencilTables(
        npts=npts, nland=nland,
        klat=klat.astype(np.int32), klon=klon.astype(np.int32),
        kcor=kcor.astype(np.int32),
        wlat=wlat, wlatm1=1.0 - wlat, wcor=wcor, wcorm1=1.0 - wcor,
        dp=dp,
        zdello_pt=zd[kxlt], xdella=grid.xdella,
        cosphm1_pt=1.0 / cosph[kxlt],
        tanph_pt=grid.sinph[kxlt] / cosph[kxlt],
        obslat=obslat, obslon=obslon, obscor=obscor)


CURRENT_GRADIENT_MAX = 1.0e-5    # max current gradient (yowcurr.F90:19)


def gradi(st, depth_ext, u_ext, v_ext, irefra: int):
    """Depth/current gradients on the sea-point block (gradi.F90:60-185).

    Centred differences over the KLAT/KLON neighbours with the reference's
    land fallbacks; current gradients additionally treat (u,v)==(0,0)
    points as land and are clipped to CURRENT_GRADIENT_MAX·cosφ.
    Returns dict of (npts,) float64 arrays ddphi/ddlam/duphi/dulam/
    dvphi/dvlam.
    """
    depth_ext = np.asarray(depth_ext, np.float64)
    u_ext = np.asarray(u_ext, np.float64)
    v_ext = np.asarray(v_ext, np.float64)
    npts = st.klon.shape[0]
    nland = depth_ext.shape[0] - 1      # land slot trails the ext layout
    oneo2delphi = 0.5 / (st.xdella * c.CIRC / 360.0)
    dellam2 = 2.0 * np.asarray(st.zdello_pt, np.float64) * (c.CIRC / 360.0)
    zero = np.zeros(npts)

    def land(idx, treat_zero_as_land):
        lnd = idx == nland
        if treat_zero_as_land:
            lnd = lnd | ((u_ext[idx] == 0.0) & (v_ext[idx] == 0.0))
        return lnd

    def merid_grad(f_ext, treat_zero_as_land=False):
        ipp, ipp2 = st.klat[:, 1, 0], st.klat[:, 1, 1]
        ipm, ipm2 = st.klat[:, 0, 0], st.klat[:, 0, 1]
        wp = np.asarray(st.wlat[:, 1], np.float64)
        wm = np.asarray(st.wlat[:, 0], np.float64)
        lpp, lpp2, lpm, lpm2 = (land(i, treat_zero_as_land)
                                for i in (ipp, ipp2, ipm, ipm2))
        all4 = ~(lpp | lpp2 | lpm | lpm2)
        prim = ~(lpp | lpm)
        sec = ~(lpp2 | lpm2)
        fp = np.where(all4, wp * f_ext[ipp] + (1.0 - wp) * f_ext[ipp2],
                      np.where(prim, f_ext[ipp], f_ext[ipp2]))
        fm = np.where(all4, wm * f_ext[ipm] + (1.0 - wm) * f_ext[ipm2],
                      np.where(prim, f_ext[ipm], f_ext[ipm2]))
        ok = all4 | prim | sec
        return np.where(ok, (fp - fm) * oneo2delphi, zero)

    def zonal_grad(f_ext, treat_zero_as_land=False):
        ilp, ilm = st.klon[:, 1], st.klon[:, 0]
        ok = ~(land(ilp, treat_zero_as_land) | land(ilm, treat_zero_as_land))
        return np.where(ok, (f_ext[ilp] - f_ext[ilm]) / dellam2, zero)

    out = dict(ddphi=zero, ddlam=zero, duphi=zero, dulam=zero,
               dvphi=zero, dvlam=zero)
    if irefra in (1, 3):
        out["ddphi"] = merid_grad(depth_ext)
        out["ddlam"] = zonal_grad(depth_ext)
    if irefra in (2, 3):
        cgmax = CURRENT_GRADIENT_MAX / np.asarray(st.cosphm1_pt, np.float64)

        def clip(g):
            return np.sign(g) * np.minimum(np.abs(g), cgmax)
        out["duphi"] = clip(merid_grad(u_ext, True))
        out["dvphi"] = clip(merid_grad(v_ext, True))
        out["dulam"] = clip(zonal_grad(u_ext, True))
        out["dvlam"] = clip(zonal_grad(v_ext, True))
    return out


# GRADI's neighbours of a row, in the order of GradiStencil.idx: the two
# northern and two southern candidates (klat), then east and west (klon)
_PP, _PP2, _PM, _PM2, _LP, _LM = range(6)


@dataclasses.dataclass
class GradiStencil:
    """:func:`gradi`'s static inputs for the current gradients, gathered
    to a set of rows, as tensors on one device, for :func:`gradi_rows`.
    A row is a point of the (npts+1) ext layout; a row at the land slot
    has land for every neighbour, so its gradients are 0."""

    idx: torch.Tensor      # (6, nrows) int32 neighbours, land slot = nland
    land: torch.Tensor     # (6, nrows) bool: the neighbour is the land slot
    wp: torch.Tensor       # (nrows,) float64 northern/southern weights
    wm: torch.Tensor
    dellam2: torch.Tensor  # (nrows,) float64 2·Δλ of the row in metres
    cgmax: torch.Tensor    # (nrows,) float64 CURRENT_GRADIENT_MAX·cosφ
    dco: torch.Tensor      # (nrows,) float64 1/cosφ (ICASE=1 spherical)
    oneo2delphi: float


def gradi_stencil(st, rows, device) -> GradiStencil:
    """GRADI's stencil (:class:`StencilTables` ``st``) gathered on the host
    to ``rows`` (indices into the (npts+1) ext layout) and moved to
    ``device``; the float64 factors are formed here as :func:`gradi`
    forms them, so that :func:`gradi_rows` repeats its arithmetic."""
    rows = np.asarray(rows, np.int64)
    nland = st.klon.shape[0]

    def ext(a, land):
        a = np.asarray(a)
        return np.concatenate([a, np.full((1,) + a.shape[1:], land,
                                          a.dtype)])[rows]
    klat, klon = ext(st.klat, nland), ext(st.klon, nland)
    idx = np.stack([klat[:, 1, 0], klat[:, 1, 1], klat[:, 0, 0],
                    klat[:, 0, 1], klon[:, 1], klon[:, 0]]).astype(np.int32)
    wlat = ext(np.asarray(st.wlat, np.float64), 0.0)
    cosphm1 = ext(np.asarray(st.cosphm1_pt, np.float64), 1.0)
    zdello = ext(np.asarray(st.zdello_pt, np.float64), 1.0)

    def f64(a):
        return torch.as_tensor(a, dtype=torch.float64, device=device)
    return GradiStencil(
        idx=torch.as_tensor(idx, device=device),
        land=torch.as_tensor(idx == nland, device=device),
        wp=f64(wlat[:, 1]), wm=f64(wlat[:, 0]),
        dellam2=f64(2.0 * zdello * (c.CIRC / 360.0)),
        cgmax=f64(CURRENT_GRADIENT_MAX / cosphm1), dco=f64(cosphm1),
        oneo2delphi=0.5 / (st.xdella * c.CIRC / 360.0))


def gradi_rows(gs: GradiStencil, u_ext, v_ext) -> dict:
    """:func:`gradi`'s current gradients (irefra 2/3) at the rows of
    ``gs``, on their device: the same float64 operations in the same
    order, so the results equal the host's to the bit.  ``u_ext``/``v_ext``
    are (npts+1,) float64 tensors on that device, the land slot last.
    Returns duphi/dulam/dvphi/dvlam, (nrows,) float64."""
    un, vn = u_ext[gs.idx], v_ext[gs.idx]
    # a neighbour without current, (u, v) == (0, 0), counts as land
    land = gs.land | ((un == 0.0) & (vn == 0.0))
    lpp, lpp2, lpm, lpm2 = land[_PP], land[_PP2], land[_PM], land[_PM2]
    all4 = ~(lpp | lpp2 | lpm | lpm2)
    prim = ~(lpp | lpm)
    merid_ok = all4 | prim | ~(lpp2 | lpm2)
    zonal_ok = ~(land[_LP] | land[_LM])
    zero = un.new_zeros(())

    def clip(g):
        return torch.sign(g) * torch.minimum(torch.abs(g), gs.cgmax)

    def merid_grad(fn):
        def side(w, i, i2):
            return torch.where(all4, w * fn[i] + (1.0 - w) * fn[i2],
                               torch.where(prim, fn[i], fn[i2]))
        fp = side(gs.wp, _PP, _PP2)
        fm = side(gs.wm, _PM, _PM2)
        return clip(torch.where(merid_ok, (fp - fm) * gs.oneo2delphi, zero))

    def zonal_grad(fn):
        return clip(torch.where(zonal_ok, (fn[_LP] - fn[_LM]) / gs.dellam2,
                                zero))
    return dict(duphi=merid_grad(un), dvphi=merid_grad(vn),
                dulam=zonal_grad(un), dvlam=zonal_grad(vn))


# the weight planes, in order: 1 - the total outflow's complement
# (sumwn), the 2 longitude neighbours (ic), the 2×2 latitude candidates
# (ic, icl), the 4×2 corner candidates (logical corner slot icr, icl),
# direction turning from k−1 and k+1, and with σ̇ (irefra 2/3) frequency
# shifting from m−1 and m+1
SLOTS = dict(sumwn=(0, 1), wlon=(1, 3), wlat=(3, 7), wcor=(7, 15),
             wkpm=(15, 17), wmpm=(17, 19))


def n_slots(irefra: int) -> int:
    """Weight planes per (direction, frequency, point): 17, or 19 with
    frequency shifting (irefra 2/3)."""
    return 19 if irefra in (2, 3) else 17


def propdot(st, tb, wavnum_ext, cgroup_ext, omosnh2kd_ext,
            depth_ext, u_ext, v_ext, irefra: int):
    """Refraction rates θ̇_depth, θ̇_current and σ̇ (propdot.F90:60-150).

    ``st`` is the (numpy) StencilTables, the ``*_ext`` arguments tensors
    over (nfre_red, npts+1) or (npts+1,).  The gradients (:func:`gradi`)
    are taken on the host in float64.  Returns (thdd, thdc, sdot): thdd/
    thdc (nang, npts) or None, sdot (nang, nfre_red, npts) or None.
    """
    dt, dev = cgroup_ext.dtype, cgroup_ext.device
    npts = st.klon.shape[0]

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=dev)
    host = {k: v.detach().cpu().numpy().astype(np.float64)
            for k, v in (("d", depth_ext), ("u", u_ext), ("v", v_ext))}
    g = {k: t(v) for k, v in gradi(st, host["d"], host["u"], host["v"],
                                    irefra).items()}
    dco = t(st.cosphm1_pt)[None, :]                 # ICASE=1 spherical
    sd = t(tb.sinth)[:, None]
    cd = t(tb.costh)[:, None]

    thdd = thdc = sdot = None
    if irefra in (1, 3):
        thdd = sd * g["ddphi"][None] - cd * g["ddlam"][None] * dco
    if irefra in (2, 3):
        if irefra == 3:
            omdd = (v_ext[:npts] * g["ddphi"]
                    + u_ext[:npts] * g["ddlam"] * dco[0])
        else:
            omdd = torch.zeros_like(g["ddphi"])
        ss, sc, cc = sd * sd, sd * cd, cd * cd
        sdot_nf = (-sc * g["duphi"][None] - cc * g["dvphi"][None]
                   - (ss * g["dulam"][None] + sc * g["dvlam"][None]) * dco)
        thdc = (ss * g["duphi"][None] + sc * g["dvphi"][None]
                - (sc * g["dulam"][None] + cc * g["dvlam"][None]) * dco)
        cg_own = cgroup_ext[:, :npts]                  # (nfre_red, npts)
        sdot = ((sdot_nf[:, None, :] * cg_own[None]
                 + omdd[None, None, :] * omosnh2kd_ext[:, :npts][None])
                * wavnum_ext[:, :npts][None])
    return thdd, thdc, sdot


def _dir_selectors(tb):
    """JXO/JYO/KCR selectors as boolean masks (ctuwupdt.F90:95-150).

    Returns (east, north, kcr) with east/north (nang,) booleans and kcr
    (nang, 4) int: logical corner slot → physical corner index, using the
    physical ordering 0=NE, 1=SE, 2=SW, 3=NW.
    """
    east = np.asarray(tb.sinth) >= 0.0
    north = np.asarray(tb.costh) >= 0.0
    # reference 1-based physical corners: 1=NE, 2=SE, 3=SW, 4=NW
    kcr = np.zeros((tb.nang, 4), dtype=np.int32)
    for k in range(tb.nang):
        if north[k] and east[k]:
            kcr[k] = (2, 1, 3, 0)       # SW, SE, NW, NE
        elif north[k] and not east[k]:
            kcr[k] = (1, 2, 0, 3)       # SE, SW, NE, NW
        elif not north[k] and east[k]:
            kcr[k] = (3, 0, 2, 1)       # NW, NE, SW, SE
        else:
            kcr[k] = (0, 3, 1, 2)       # NE, NW, SE, SW
    return east, north, kcr


def stencil_tensors(st, dtype, device) -> dict:
    """The stencil's tables as tensors: neighbour indices int64, weights,
    geometry and obstruction coefficients in ``dtype``, on ``device``."""
    def f(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    def i(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.int64,
                               device=device)
    return dict(klat=i(st.klat), klon=i(st.klon), kcor=i(st.kcor),
                wlat=f(st.wlat), wcor=f(st.wcor), dp=f(st.dp),
                zdello_pt=f(st.zdello_pt), cosphm1_pt=f(st.cosphm1_pt),
                tanph_pt=f(st.tanph_pt), obslat=f(st.obslat),
                obslon=f(st.obslon), obscor=f(st.obscor),
                xdella=float(st.xdella))


def weight_views(w: torch.Tensor, mstart: int, mend: int, cflfail) -> dict:
    """The weights dict over the planes ``w`` (n_slots, nang, nf, npts):
    a view per slot group of :data:`SLOTS`, and the window and CFL mask."""
    out = {k: (w[a] if b == a + 1 else w[a:b]) if b <= w.shape[0] else None
           for k, (a, b) in SLOTS.items()}
    out.update(w=w, cflfail=cflfail, mstart=mstart, mend=mend)
    return out


def ctuw_weights(delpro: float, st: dict, tb, cgroup_ext,
                 omosnh2kd_ext=None, u_ext=None, v_ext=None, *,
                 irefra: int = 0, thdd=None, thdc=None, sdot=None,
                 mstart: int = 0, mend: int | None = None, out=None):
    """CTU weights on the sphere (ctuw.F90:90-745, ICASE=1 spherical).

    ``st`` holds the stencil's tensors (:func:`stencil_tensors`),
    ``cgroup_ext`` is (nfre_red, npts+1).  Returns the weights over the
    frequency window [mstart, mend) as :func:`weight_views` of one
    (n_slots, nang, nf, npts) tensor — written into ``out`` if given —
    and the CFL violation mask ``cflfail`` (npts,) bool.  The arithmetic
    is the reference's, term for term.
    """
    dt, dev = cgroup_ext.dtype, cgroup_ext.device
    nf_all = cgroup_ext.shape[0]
    npts = st["klon"].shape[0]
    if mend is None:
        mend = nf_all
    nf = mend - mstart
    nang = tb.nang

    def tc(a):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=dev)
    cg = cgroup_ext[mstart:mend]                       # (nf, npts_ext)
    sinth = tc(tb.sinth)[:, None, None]
    costh = tc(tb.costh)[:, None, None]
    east, north, kcr = _dir_selectors(tb)
    east_b = torch.as_tensor(east, device=dev)[:, None, None]
    north_b = torch.as_tensor(north, device=dev)[:, None, None]

    cosphm1 = st["cosphm1_pt"][None, :]
    zdello = st["zdello_pt"][None, None, :]
    xdella = st["xdella"]
    cmtodeg = 360.0 / c.CIRC
    wlat, dp = st["wlat"], st["dp"]
    klon, klat = st["klon"], st["klat"]

    have_cur = irefra in (2, 3) and u_ext is not None

    # per-(ic) edge velocities → |displacement| split up/down stream
    adxp, dxup, dxdw, adyp, dyup, dydw = [], [], [], [], [], []
    cg_own = cg[:, :npts]
    for ic in range(2):
        cg_lon = cg[:, klon[:, ic]]                    # (nf, npts)
        cgx = 0.5 * (cg_own + cg_lon) * sinth * cosphm1[None]
        cgyp = (wlat[None, :, ic] * cg[:, klat[:, ic, 0]]
                + (1.0 - wlat[None, :, ic]) * cg[:, klat[:, ic, 1]])
        cgy = 0.5 * (cg_own + dp[None, :, ic] * cgyp) * costh
        if have_cur:
            uu = u_ext[None, None, :npts] * cosphm1[None]
            urel = cgx + uu
            issu = (torch.sign(urel) == torch.sign(cgx)).to(dt)
            vv = (v_ext[None, None, :npts]
                  * 0.5 * (1.0 + dp[:, ic][None, None, :]))
            vrel = cgy + vv
            issv = (torch.sign(vrel) == torch.sign(cgy)).to(dt)
        else:
            urel, issu = cgx, 1.0
            vrel, issv = cgy, 1.0
        adx = torch.abs(delpro * urel * cmtodeg)
        ady = torch.abs(delpro * vrel * cmtodeg)
        adxp.append(adx)
        adyp.append(ady)
        dxup.append(adx * issu)
        dxdw.append(adx * (1.0 - issu))
        dyup.append(ady * issv)
        dydw.append(ady * (1.0 - issv))

    def sel(pair, cond):
        """pair[0] where cond (per direction) else pair[1]."""
        return torch.where(cond, pair[0], pair[1])

    # jxo(k,1)=ic0 for east, ic1 for west; jxo(k,2) the other
    dxup_1 = sel(dxup, east_b)       # upstream-x slot
    dxup_2 = sel(dxup, ~east_b)
    dxdw_1 = sel(dxdw, east_b)
    dxdw_2 = sel(dxdw, ~east_b)
    dyup_1 = sel(dyup, north_b)
    dyup_2 = sel(dyup, ~north_b)
    dydw_1 = sel(dydw, north_b)
    dydw_2 = sel(dydw, ~north_b)

    dxx = zdello - dxup_2 - dxdw_1
    dyy = xdella - dyup_2 - dydw_1
    aream1 = 1.0 / (zdello * xdella)

    if out is None:
        out = torch.empty((n_slots(irefra), nang, nf, npts), dtype=dt,
                          device=dev)
    w = weight_views(out, mstart, mend, None)

    # latitude weights: slot ic receives weight iff it is jyo(k,1)/jyo(k,2)
    # weight(jyo(k,1)) = dxx*dyup(jyo1); weight(jyo(k,2)) = dxx*dydw(jyo2)
    w_jyo1 = dxx * dyup_1 * aream1
    w_jyo2 = dxx * dydw_2 * aream1
    w_lat_ic = (torch.where(north_b, w_jyo1, w_jyo2),   # ic=0 south slot
                torch.where(north_b, w_jyo2, w_jyo1))
    obslat = st["obslat"][mstart:mend]
    for ic in range(2):
        w["wlat"][2 * ic] = (w_lat_ic[ic] * wlat[None, :, ic]
                             * obslat[None, :, :, ic])
        w["wlat"][2 * ic + 1] = (w_lat_ic[ic] * (1.0 - wlat[None, :, ic])
                                 * obslat[None, :, :, ic])

    # longitude weights
    w_jxo1 = dyy * dxup_1 * aream1
    w_jxo2 = dyy * dxdw_2 * aream1
    obslon = st["obslon"][mstart:mend]
    w["wlon"][0] = torch.where(east_b, w_jxo1, w_jxo2) * obslon[None, :, :, 0]
    w["wlon"][1] = torch.where(east_b, w_jxo2, w_jxo1) * obslon[None, :, :, 1]

    # corner weights (logical slots 1..4 → physical via kcr)
    wgt = [dxup_1 * dyup_1 * aream1,
           dxdw_2 * dyup_1 * aream1,
           dxup_1 * dydw_2 * aream1,
           dxdw_2 * dydw_2 * aream1]
    kcr_t = torch.as_tensor(kcr, dtype=torch.int64, device=dev)
    wcor_k = st["wcor"].T[kcr_t]                       # (nang, 4, npts)
    obscor_k = st["obscor"][mstart:mend].permute(2, 0, 1)[kcr_t]
    for icr in range(4):                               # (nang, 4, nf, npts)
        w["wcor"][2 * icr] = (wgt[icr] * wcor_k[:, icr, None, :]
                              * obscor_k[:, icr])
        w["wcor"][2 * icr + 1] = (wgt[icr] * (1.0 - wcor_k[:, icr, None, :])
                                  * obscor_k[:, icr])

    sumwn = (zdello * (dydw_1 + dyup_2) + xdella * (dxup_2 + dxdw_1)
             - (dxdw_1 + dxup_2) * (dydw_1 + dyup_2)) * aream1

    # ---- direction (great-circle turning) weights (ctuw.F90:345-420)
    delth0 = 0.25 * delpro / tb.delth
    sinth_v = np.asarray(tb.sinth)
    kp1 = np.roll(np.arange(nang), -1)
    km1 = np.roll(np.arange(nang), 1)
    sp = tc(delth0 * (sinth_v + sinth_v[kp1]) / c.R_EARTH)[:, None, None]
    sm = tc(delth0 * (sinth_v + sinth_v[km1]) / c.R_EARTH)[:, None, None]
    tanph = st["tanph_pt"][None, None, :]
    drgp = tanph * sp
    drgm = tanph * sm

    dthp = drgp * cg_own[None]
    dthm = drgm * cg_own[None]
    kp1_t = torch.as_tensor(kp1, device=dev)
    km1_t = torch.as_tensor(km1, device=dev)
    if irefra in (1, 3) and thdd is not None:
        drdp = (thdd[:, None, :] + thdd[kp1_t][:, None, :]) * delth0
        drdm = (thdd[:, None, :] + thdd[km1_t][:, None, :]) * delth0
        omos_own = omosnh2kd_ext[mstart:mend, :npts]
        dthp = dthp + omos_own[None] * drdp
        dthm = dthm + omos_own[None] * drdm
    if irefra in (2, 3) and thdc is not None:
        dthp = dthp + (thdc[:, None, :] + thdc[kp1_t][:, None, :]) * delth0
        dthm = dthm + (thdc[:, None, :] + thdc[km1_t][:, None, :]) * delth0

    wkpmn0 = (dthp + torch.abs(dthp)) + (torch.abs(dthm) - dthm)
    w["wkpm"][0] = dthm + torch.abs(dthm)     # inflow from k-1
    w["wkpm"][1] = -dthp + torch.abs(dthp)    # inflow from k+1
    sumwn = sumwn + wkpmn0

    if w["wmpm"] is not None and sdot is None:
        w["wmpm"].zero_()
    elif w["wmpm"] is not None:
        delfr0 = 0.25 * delpro / ((tb.fratio - 1.0) * c.ZPI)
        fr = np.asarray(tb.fr)
        m_idx = np.arange(mstart, mend)
        mp1 = np.minimum(nf_all - 1, m_idx + 1)
        mm1 = np.maximum(0, m_idx - 1)
        dfp = tc(delfr0 / fr[m_idx])[None, :, None]
        dfm = tc(delfr0 / fr[mm1])[None, :, None]
        sd = sdot                                  # (nang, nf_all, npts)
        m_t, mp1_t, mm1_t = (torch.as_tensor(a, device=dev)
                             for a in (m_idx, mp1, mm1))
        dthp_f = (sd[:, m_t] + sd[:, mp1_t]) * dfp
        dthm_f = (sd[:, m_t] + sd[:, mm1_t]) * dfm
        wmpmn0 = (dthp_f + torch.abs(dthp_f)) + (torch.abs(dthm_f) - dthm_f)
        w["wmpm"][0] = (dthm_f + torch.abs(dthm_f)) * tb.fratio   # from m-1
        w["wmpm"][1] = (-dthp_f + torch.abs(dthp_f)) / tb.fratio  # from m+1
        sumwn = sumwn + wmpmn0
    w["sumwn"].copy_(sumwn)

    # ---- CFL check (ctuw.F90:238-300,560-690)
    cfl_x = torch.maximum(adxp[0], adxp[1]) > zdello
    cfl_y = torch.maximum(adyp[0], adyp[1]) > xdella
    bad = cfl_x | cfl_y | (sumwn > 1.0) | (sumwn < 0.0)
    w["cflfail"] = torch.any(bad.reshape(-1, npts), dim=0)
    return w


def weights_from_numpy(ref: dict, dtype=torch.float64, device="cpu") -> dict:
    """The reference's ``ctuw_weights`` dict, as numpy arrays (sumwn
    (nang, nf, n), wlonn (…, 2), wlatn (…, 2, 2), wcorn (…, 4, 2), wkpmn
    (…, 2), wmpmn (…, 2) or None, cflfail), in this module's slot-major
    layout (:func:`weight_views`) on ``device``."""
    planes = [np.asarray(ref["sumwn"])[None]]
    planes += [np.moveaxis(np.asarray(ref[k]).reshape(
        np.asarray(ref[k]).shape[:3] + (-1,)), -1, 0)
        for k in ("wlonn", "wlatn", "wcorn", "wkpmn")]
    if ref.get("wmpmn") is not None:
        planes.append(np.moveaxis(np.asarray(ref["wmpmn"]), -1, 0))
    w = torch.as_tensor(np.concatenate(planes), dtype=dtype, device=device)
    return weight_views(w, int(ref["mstart"]), int(ref["mend"]),
                        torch.as_tensor(np.array(ref["cflfail"]),
                                        device=device))


def propags2(f1_ext, weights: dict, st: dict, tb, *, out=None):
    """CTU stencil update (propags2.F90:49-130, general branch).

    ``f1_ext`` is (nang, nf, npts+1) over the same frequency window the
    weights were built for, ``st`` the stencil's tensors.  Returns (nang,
    nf, npts), written into ``out`` if given (any strides).  The terms
    accumulate in place, in the reference's order, through one gather
    buffer, so that no term allocates a field of its own."""
    nang, nf, _ = f1_ext.shape
    npts = st["klon"].shape[0]
    _, _, kcr = _dir_selectors(tb)

    f1 = f1_ext[:, :, :npts]
    if out is None:
        out = torch.empty((nang, nf, npts), dtype=f1_ext.dtype,
                          device=f1_ext.device)
    buf = torch.empty((nang, nf, npts), dtype=f1_ext.dtype,
                      device=f1_ext.device)
    torch.mul(buf.copy_(weights["sumwn"]).neg_().add_(1.0), f1, out=out)
    # longitudes
    for ic in range(2):
        torch.index_select(f1_ext, 2, st["klon"][:, ic], out=buf)
        out.addcmul_(weights["wlon"][ic], buf)
    # latitudes (2 candidates)
    for ic in range(2):
        for icl in range(2):
            torch.index_select(f1_ext, 2, st["klat"][:, ic, icl], out=buf)
            out.addcmul_(weights["wlat"][2 * ic + icl], buf)
    # corners: logical slot icr gathers physical corner kcr[k, icr]
    kcr_t = torch.as_tensor(kcr, dtype=torch.int64, device=f1_ext.device)
    for icr in range(4):
        for icl in range(2):
            idx = st["kcor"][:, kcr_t[:, icr], icl].T     # (nang, npts)
            torch.gather(f1_ext, 2, idx[:, None, :].expand(nang, nf, npts),
                         out=buf)
            out.addcmul_(weights["wcor"][2 * icr + icl], buf)
    # direction turning: f1 rolled by +1 (from k−1) and −1 (from k+1)
    buf[1:].copy_(f1[:-1])
    buf[:1].copy_(f1[-1:])
    out.addcmul_(weights["wkpm"][0], buf)
    buf[:-1].copy_(f1[1:])
    buf[-1:].copy_(f1[:1])
    out.addcmul_(weights["wkpm"][1], buf)
    # frequency shifting (current refraction)
    if weights.get("wmpm") is not None:
        buf[:, 1:].copy_(f1[:, :-1])
        buf[:, :1].copy_(f1[:, :1])
        out.addcmul_(weights["wmpm"][0], buf)
        buf[:, :-1].copy_(f1[:, 1:])
        buf[:, -1:].copy_(f1[:, -1:])
        out.addcmul_(weights["wmpm"][1], buf)
    return out
