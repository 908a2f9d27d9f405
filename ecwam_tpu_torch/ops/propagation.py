"""Great-circle CTU stencil tables (host side) and depth gradients.

Carried over from ``ecwam_tpu/ops/propagation.py``: the numpy builders
of the reference's neighbour tables and interpolation weights
(propconnect.F90:44-950, ctuwini.F90:45-125) and GRADI
(gradi.F90:60-185) for depth refraction.  All host numpy, float64.
"""

from __future__ import annotations

import dataclasses

import numpy as np

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
