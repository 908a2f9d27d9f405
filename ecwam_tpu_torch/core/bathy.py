"""Bathymetry construction and sub-grid obstruction coefficients.

Copied unchanged from ``ecwam_tpu/core/bathy.py`` (numpy only, no
JAX), with its imports pointed at ``ecwam_tpu_torch``: the port
imports nothing of the JAX package.

Host-side (NumPy) re-derivation of the reference preprocessor chain that
the model cannot run without on real-world grids:

  - create_wam_bathymetry_ETOPO1.F90:560-680   cell-mean depth from a
    high-resolution elevation data set with separate land/sea/shallow
    averaging and land-centre detection
  - create_wam_bathymetry_ETOPO1.F90:860-900   per-frequency blocking
    thresholds from the finite-depth dispersion relation (k·d ≥ XKDMAX)
  - create_wam_bathymetry_ETOPO1.F90:900-1230  N-S / E-W / corner
    obstruction factors: the fraction of sub-grid transport lines through
    a cell face blocked by land or fully-blocking submerged features,
    with the sea-land-sea switch heuristic and IREINF reinforcement
  - mubuf.F90:90-220 + getbobstrct.F90:400-460 packing of the factors as
    per-(point, frequency, direction) tables consumed by CTUW
    (ctuw.F90:700-730)

The reference scans each sub-grid line with per-point Fortran loops; here
every (latitude row, frequency, direction) pass is vectorized over the
full longitude axis with prefix sums, which reproduces the same counts.
Elevation convention follows ETOPO1: metres above sea level, > 0 land,
≤ 0 sea floor; the model-grid convention on output follows mblock.F90
(positive water depth, land marked −999).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ecwam_tpu_torch.core import constants as c
from ecwam_tpu_torch.core import dispersion
from ecwam_tpu_torch.core.grid import WaveGrid

# Tuning constants (create_wam_bathymetry_ETOPO1.F90:110-145)
XKDMAX = 1.5
ALPR_DEEP = 0.025
PSHALLOWTRHS = 0.8
PLANDTRHS = 0.3
XKEXTHRS_DEEP = 100.0
ISWTHRS = 200
PENHCOR = 1.0
NOOBSTRT = 1000
NDPT = 1000
RMIN_DEPTH = -0.3
RMIN_DEPTH_SMOOTH = RMIN_DEPTH - 0.01


@dataclasses.dataclass(frozen=True)
class TopoData:
    """Global high-resolution elevation grid (ETOPO1-like layout).

    ``elev[j, i]`` is the elevation (m) at latitude 90 − j/invres and
    longitude −180 + i/invres; rows descend north → south and columns
    span the full globe, exactly the index convention of
    create_wam_bathymetry_ETOPO1.F90:920-950.
    """

    invres: int              # samples per degree
    elev: np.ndarray         # (ilat, ilon) int/float elevation (m)

    def __post_init__(self):
        ilat = 180 * self.invres + 1
        ilon = 360 * self.invres + 1
        if self.elev.shape != (ilat, ilon):
            raise ValueError(
                f"elev must be ({ilat}, {ilon}) for invres={self.invres}, "
                f"got {self.elev.shape}")

    @property
    def ilat(self) -> int:
        return self.elev.shape[0]

    @property
    def ilon(self) -> int:
        return self.elev.shape[1]

    def lat_index(self, lat) -> np.ndarray:
        """Nearest row index (0-based) for latitude(s)."""
        j = np.rint((90.0 - np.asarray(lat)) * self.invres).astype(int)
        return np.clip(j, 0, self.ilat - 1)

    def lon_index(self, lon) -> np.ndarray:
        """Nearest column index (0-based) for longitude(s) in [-180,180]."""
        i = np.rint((np.asarray(lon) + 180.0) * self.invres).astype(int)
        return np.clip(i, 0, self.ilon - 1)


def load_topo(path: str) -> TopoData:
    """Load a TopoData from an .npz with fields ``invres`` and ``elev``."""
    with np.load(path) as z:
        return TopoData(invres=int(z["invres"]), elev=np.asarray(z["elev"]))


def save_topo(path: str, topo: TopoData) -> None:
    np.savez_compressed(path, invres=topo.invres,
                        elev=topo.elev.astype(np.int32))


def synthetic_topo(invres: int = 4, *, base_depth: float = -4000.0,
                   polar_land: float = 3.0,
                   features: list | None = None) -> TopoData:
    """Synthetic global test bathymetry: deep ocean + polar caps + features.

    ``features`` is a list of dicts:
      {"kind": "land"|"shoal", "lon": (w, e), "lat": (s, n),
       "elev": value}   — a rectangular block set to ``elev``.
    """
    ilat = 180 * invres + 1
    ilon = 360 * invres + 1
    elev = np.full((ilat, ilon), base_depth, dtype=np.float64)
    lat = 90.0 - np.arange(ilat) / invres
    lon = -180.0 + np.arange(ilon) / invres
    elev[np.abs(lat) > 90.0 - polar_land, :] = 500.0
    for f in features or ():
        w, e = f["lon"]
        s, n = f["lat"]
        lm = (lon >= w) & (lon <= e)
        la = (lat >= s) & (lat <= n)
        elev[np.ix_(la, lm)] = f["elev"]
    return TopoData(invres=invres, elev=elev)


# ---------------------------------------------------------------------------
# cell-mean depth (create_wam_bathymetry_ETOPO1.F90:560-680)
# ---------------------------------------------------------------------------

def _window_strip(topo: TopoData, j0: int, j1: int) -> np.ndarray:
    """Rows j0..j1 clipped to the grid (reference skips out-of-range JJ)."""
    j0c, j1c = max(j0, 0), min(j1, topo.ilat - 1)
    return topo.elev[j0c:j1c + 1]


def _cell_col_ranges(grid: WaveGrid, topo: TopoData, k: int,
                     halfwidth: float | None = None):
    """Per-cell (ilonl, ilonr) sample-column ranges for row k (inclusive,
    may wrap: ilonl > ilonr means crossing the dateline)."""
    nl = int(grid.nlonrgg[k])
    zd = grid.zdello[k]
    hw = 0.5 * zd if halfwidth is None else halfwidth
    xlon = grid.amowep + np.arange(nl) * zd
    lonl = xlon - hw
    lonr = xlon + hw
    # map into [-180, 180] like the reference (XLON>180 → −360)
    lonl = np.where(lonl > 180.0, lonl - 360.0, lonl)
    lonr = np.where(lonr > 180.0, lonr - 360.0, lonr)
    il = np.rint((lonl + 180.0) * topo.invres).astype(int)
    ir = np.rint((lonr + 180.0) * topo.invres).astype(int)
    n = topo.ilon
    return il % (n - 1), ir % (n - 1)


def wam_depth(topo: TopoData, grid: WaveGrid, *,
              ratioland_threshold: float | None = None,
              ratioshallow_threshold: float | None = None):
    """Cell-mean model depth + land/shallow fractions.

    Returns (wamdepth, percentland, percentshallow), each (ngy, ngx);
    wamdepth follows the reference sign convention here (negative = sea).
    """
    if ratioland_threshold is None:
        ratioland_threshold = 0.5 if grid.xdella < 0.2 else 0.6
    if ratioshallow_threshold is None:
        ratioshallow_threshold = 1.0 if grid.xdella < 0.2 else 0.3

    ngy, ngx = grid.ngy, grid.ngx
    wamdepth = np.full((ngy, ngx), 999.0)
    pland = np.zeros((ngy, ngx))
    pshal = np.zeros((ngy, ngx))

    invres = topo.invres
    njm = int(0.5 * grid.xdella * invres)
    njp = int(np.rint(0.5 * grid.xdella * invres))
    smooth_extra = 1 if grid.xdella < 0.125 else 0
    njm += smooth_extra
    njp += smooth_extra
    nlandcentrepm = max(invres // 8, 0)
    nlandcentremax = (2 * nlandcentrepm + 1) ** 2

    lats = grid.lats
    n = topo.ilon - 1                  # periodic period in columns

    for k in range(ngy):
        jc = int(topo.lat_index(lats[k]))
        strip = _window_strip(topo, jc - njm, jc + njp)   # (nr, ilon)
        cstrip = strip[:, :n]                             # drop dup column
        is_sea = cstrip <= 0.0
        sea_val = np.where(is_sea, np.maximum(cstrip, -999.0), 0.0)
        is_shal = is_sea & (cstrip > -500.0)
        shal_val = np.where(is_shal, cstrip, 0.0)
        land_val = np.where(~is_sea, cstrip, 0.0)

        # prefix sums over columns for windowed sums with wraparound
        def psum(a):
            s = np.concatenate([[0.0], np.cumsum(a.sum(axis=0))])
            return s

        ps_sea_n = psum(is_sea.astype(float))
        ps_sea_v = psum(sea_val)
        ps_shal_n = psum(is_shal.astype(float))
        ps_shal_v = psum(shal_val)
        ps_land_n = psum((~is_sea).astype(float))
        ps_land_v = psum(land_val)

        nim = int(0.5 * grid.zdello[k] * invres) + smooth_extra
        nip = int(np.rint(0.5 * grid.zdello[k] * invres)) + smooth_extra
        nl = int(grid.nlonrgg[k])
        xlon = grid.amowep + np.arange(nl) * grid.zdello[k]
        xlon = np.where(xlon > 180.0, xlon - 360.0, xlon)
        ic = np.searchsorted(
            -180.0 + np.arange(n) / invres, xlon, side="right") - 1
        ic = np.clip(ic, 0, n - 1)

        def wsum(ps, lo, hi):
            """Windowed sum over columns [lo, hi] with periodic wrap."""
            lo = np.asarray(lo)
            hi = np.asarray(hi)
            width = hi - lo + 1
            lo_m = lo % n
            hi_m = lo_m + width - 1
            wrap = hi_m >= n
            base = ps[np.minimum(hi_m, n - 1) + 1] - ps[lo_m]
            extra = np.where(wrap, ps[np.maximum(hi_m - n, -1) + 1], 0.0)
            return base + extra

        lo = ic - nim
        hi = ic + nip
        nsea = wsum(ps_sea_n, lo, hi)
        sea = wsum(ps_sea_v, lo, hi)
        nseash = wsum(ps_shal_n, lo, hi)
        seash = wsum(ps_shal_v, lo, hi)
        nland = wsum(ps_land_n, lo, hi)
        xland = wsum(ps_land_v, lo, hi)

        # land centre count over ±nlandcentrepm (row-restricted to strip)
        jl = int(topo.lat_index(lats[k]))
        cj0 = max(jl - nlandcentrepm, 0)
        cj1 = min(jl + nlandcentrepm, topo.ilat - 1)
        centre = topo.elev[cj0:cj1 + 1, :n] > 0.0
        ps_centre = np.concatenate([[0.0],
                                    np.cumsum(centre.sum(axis=0))])
        nlandcentre = wsum(ps_centre, ic - nlandcentrepm,
                           ic + nlandcentrepm)

        plk = nland / np.maximum(nland + nsea, 1.0)
        psk = nseash / np.maximum(nsea, 1.0)
        land_cell = (plk > ratioland_threshold) | \
            (nlandcentre >= nlandcentremax)
        depth_land = xland / np.maximum(nland, 1.0)
        depth_shal = seash / np.maximum(nseash, 1.0)
        depth_sea = sea / np.maximum(nsea, 1.0)
        use_shal = psk >= ratioshallow_threshold
        d = np.where(use_shal, depth_shal, depth_sea)
        d = np.where(use_shal & (plk < 0.10), np.minimum(d, -1.0), d)
        d = np.where(land_cell, depth_land, d)

        wamdepth[k, :nl] = d
        pland[k, :nl] = plk
        pshal[k, :nl] = psk

    # reset-to-land rules (create_wam_bathymetry_ETOPO1.F90:663-676)
    sea = wamdepth < 0.0
    shallow_reset = (wamdepth > RMIN_DEPTH) & sea
    wamdepth = np.where(shallow_reset, -wamdepth, wamdepth)
    smooth = (wamdepth > RMIN_DEPTH_SMOOTH) & (wamdepth < RMIN_DEPTH)
    wamdepth = np.where(smooth, RMIN_DEPTH, wamdepth)
    return wamdepth, pland, pshal


# ---------------------------------------------------------------------------
# obstruction factors
# ---------------------------------------------------------------------------

def _line_counts(strip, ib_col, ith_col, excl_col, pshal_col, pland_col,
                 ireinf: int):
    """Blocking count per sub-grid line (vectorized over lines).

    ``strip`` is (nr, ncols): each column is one transport line with nr
    samples along the propagation direction.  Implements the per-line
    tally of create_wam_bathymetry_ETOPO1.F90:958-1025: partial blocking
    per sample, full/reinforced blocking for land with a sea-land-sea
    switch, pseudo-land rules for submerged features.

    Returns (counts (ncols,), nblock_line (ncols,) bool).
    """
    nr = strip.shape[0]
    land = strip >= ib_col[None, :]
    partial = (strip >= ith_col[None, :]) & excl_col[None, :]
    base = (land | partial).sum(axis=0)

    lland = land.any(axis=0)
    lreal = (strip > 0.0).any(axis=0)
    ntrans = (land[1:] != land[:-1]).sum(axis=0) if nr > 1 else \
        np.zeros(strip.shape[1], dtype=int)

    counts = base.astype(np.int64)
    nblock = np.zeros(strip.shape[1], dtype=bool)

    # real land: blocked if the line returns to its initial state after a
    # change (sea-land-sea / land-sea-land); uniform land blocks plainly
    real = lland & lreal
    blocked = real & (ntrans >= 2)
    uniform = real & (ntrans == 0)
    counts = np.where(blocked, ireinf * nr, counts)
    counts = np.where(uniform, nr, counts)
    nblock |= blocked

    # pseudo land (submerged blocking only)
    pseudo = lland & ~lreal
    counts = np.where(pseudo & (pshal_col > PSHALLOWTRHS), nr, counts)
    reinforced = pseudo & (pshal_col <= PSHALLOWTRHS) & \
        (pland_col < PLANDTRHS)
    counts = np.where(reinforced, ireinf * nr, counts)
    counts = np.where(pseudo & (pshal_col <= PSHALLOWTRHS)
                      & (pland_col >= PLANDTRHS), 0, counts)
    nblock |= reinforced
    return counts, nblock


def _reduce_cells(counts, nblock, nr, col_cell, ncells, ireinf):
    """Aggregate line counts into per-cell obstruction factors."""
    nobst = np.bincount(col_cell, weights=counts, minlength=ncells)
    nblk = np.bincount(col_cell, weights=nblock.astype(float),
                       minlength=ncells)
    ncols = np.bincount(col_cell, minlength=ncells)
    ntot = nr * ncols + (ireinf - 1) * nblk * nr
    with np.errstate(invalid="ignore", divide="ignore"):
        ob = np.rint((1.0 - nobst / np.maximum(ntot, 1.0)) * NOOBSTRT)
    return np.maximum(ob, 0.0) / NOOBSTRT


def _columns_of_cells(grid: WaveGrid, topo: TopoData, k: int,
                      lon_off_l: float, lon_off_r: float):
    """Sub-grid column index array + owning-cell map for row k.

    Each cell spans [xlon+lon_off_l·zd, xlon+lon_off_r·zd]; returns
    (cols (ncol_total,), col_cell (ncol_total,)) with periodic wrap.
    """
    nl = int(grid.nlonrgg[k])
    zd = grid.zdello[k]
    n = topo.ilon - 1
    xlon = grid.amowep + np.arange(nl) * zd
    lonl = xlon + lon_off_l * zd
    lonr = xlon + lon_off_r * zd
    lonl = np.where(lonl > 180.0, lonl - 360.0, lonl)
    lonr = np.where(lonr > 180.0, lonr - 360.0, lonr)
    il = np.rint((lonl + 180.0) * topo.invres).astype(int) % n
    ir = np.rint((lonr + 180.0) * topo.invres).astype(int) % n
    width = (ir - il) % n + 1
    cols = (il[:, None] + np.arange(width.max())[None, :]) % n
    mask = np.arange(width.max())[None, :] < width[:, None]
    col_cell = np.broadcast_to(np.arange(nl)[:, None], cols.shape)[mask]
    return cols[mask], col_cell


def obstructions(topo: TopoData, grid: WaveGrid, wamdepth, pland, pshal,
                 fr: np.ndarray, nfre_red: int):
    """Per-frequency/direction obstruction factors in [0, 1].

    Returns dict with ``kobslat``/``kobslon`` (nfre_red, ngy, ngx, 2) and
    ``kobscor`` (nfre_red, ngy, ngx, 4); 1 = open water.  Factor order
    matches the wam_subgrid_2 layout consumed by CTUW: lat IS=1 south→
    north, IS=2 north→south; lon IS=1 west→east, IS=2 east→west; corners
    IS=1 NE←SW … IS=4 NW→SE (create_wam_bathymetry_ETOPO1.F90:1836-1850).
    """
    ngy, ngx = grid.ngy, grid.ngx
    invres = topo.invres
    res = 1.0 / invres
    n = topo.ilon - 1

    if grid.xdella < 2.0 / 60.0:
        shape = (nfre_red, ngy, ngx)
        return dict(kobslat=np.ones(shape + (2,)),
                    kobslon=np.ones(shape + (2,)),
                    kobscor=np.ones(shape + (4,)))

    if grid.xdella <= 0.1:
        ireinf = 4
    elif grid.xdella <= 0.35:
        ireinf = 2
    else:
        ireinf = 1

    kobslat = np.ones((nfre_red, ngy, ngx, 2))
    kobslon = np.ones((nfre_red, ngy, ngx, 2))
    kobscor = np.ones((nfre_red, ngy, ngx, 4))

    lats = grid.lats
    sea2d = wamdepth < 0.0

    # wavenumber lookup for integer depths 1..NDPT per frequency
    dpt = np.arange(1, NDPT + 1, dtype=np.float64)
    for m in range(nfre_red):
        om = c.ZPI * fr[m]
        xk = dispersion.aki(np.full(NDPT, om), dpt)

        # per-cell thresholds (create_wam_bathymetry_ETOPO1.F90:875-890)
        di = np.clip(-np.rint(wamdepth).astype(int), 1, NDPT)
        xx = XKDMAX / xk[di - 1]
        ithr = np.rint(-xx)
        rr = np.maximum(
            (ISWTHRS - np.abs(np.rint(wamdepth))) / ISWTHRS, 0.0)
        xkexthrs = XKEXTHRS_DEEP * (1.0 + rr)
        alpr = np.maximum(ALPR_DEEP * (1.0 - rr), 0.0)
        rexcl = np.maximum(xkexthrs * ithr, -998.0)
        excl = wamdepth < rexcl
        iblock = np.trunc(-alpr * xx)
        # land cells: nothing to compute (factors stay 1, unused)
        ithr = np.where(sea2d, ithr, 1.0)
        iblock = np.where(sea2d, iblock, 1.0)
        excl = excl & sea2d

        def row_tables(k):
            nl = int(grid.nlonrgg[k])
            cell_of_col = None
            return nl

        # ---- N-S transport (kobslat) + corners share lat strips
        for k in range(ngy):
            nl = int(grid.nlonrgg[k])
            if not sea2d[k, :nl].any():
                continue

            def lat_strip(kt, kb, stept, stepb):
                latt = (lats[kt] if 0 <= kt < ngy else
                        lats[k] + (kt - k) * grid.xdella) + stept
                latb = (lats[kb] if 0 <= kb < ngy else
                        lats[k] + (kb - k) * grid.xdella) + stepb
                jt = int(np.clip(np.rint((90.0 - latt) * invres), 0,
                                 topo.ilat - 1))
                jb = int(np.clip(np.rint((90.0 - latb) * invres), 0,
                                 topo.ilat - 1))
                jt, jb = min(jt, jb), max(jt, jb)
                return topo.elev[jt:jb + 1, :n]

            def run_pass(strip_rows, cols, col_cell, transpose=False):
                """counts over lines; lines along rows (transpose=False:
                lines run N-S within columns) or along lon."""
                sub = strip_rows[:, cols]                 # (nr, ncol)
                ibc = iblock[k, col_cell]
                itc = ithr[k, col_cell]
                exc = excl[k, col_cell]
                psc = pshal[k, col_cell]
                plc = pland[k, col_cell]
                cnt, nb = _line_counts(sub, ibc, itc, exc, psc, plc,
                                       ireinf)
                nr = sub.shape[0]
                return _reduce_cells(cnt, nb, nr, col_cell, nl, ireinf)

            # kobslat: IS=1 (KT=k, KB=k-1, strip own-centre−res … below
            # centre), IS=2 (KT=k+1, KB=k)
            cols, col_cell = _columns_of_cells(grid, topo, k, -0.5, 0.5)
            for is_, (kt, kb, st_, sb_) in enumerate(
                    [(k, k - 1, -res, 0.0), (k + 1, k, 0.0, res)]):
                strip = lat_strip(kt, kb, st_, sb_)
                ob = run_pass(strip, cols, col_cell)
                kobslat[m, k, :nl, is_] = np.where(sea2d[k, :nl], ob, 1.0)

            # corners: 4 diagonal quadrants = geometric mean of a lat pass
            # and a lon pass over the quadrant strip
            corner_spec = [
                # (kt, kb, stept, stepb, lon_off_l, lon_off_r)
                (k + 1, k, 0.0, res, 0.0, 1.0),     # IS=1 NE-SW
                (k, k - 1, -res, 0.0, 0.0, 1.0),    # IS=2 SE-NW
                (k, k - 1, -res, 0.0, -1.0, 0.0),   # IS=3 SW-NE
                (k + 1, k, 0.0, res, -1.0, 0.0),    # IS=4 NW-SE
            ]
            for is_, (kt, kb, st_, sb_, ol, orr) in enumerate(corner_spec):
                strip = lat_strip(kt, kb, st_, sb_)
                ccols, ccell = _columns_of_cells(grid, topo, k, ol, orr)
                ob_ns = run_pass(strip, ccols, ccell)
                # second pass: lines along longitude (transpose the strip
                # so each line is one latitude row)
                sub = strip[:, ccols]                    # (nr, ncol)
                # group columns by cell; per cell scan rows as lines
                ob_ew = np.ones(nl)
                for cell in np.unique(ccell):
                    block = sub[:, ccell == cell]        # (nr, w)
                    ibv = np.full(block.shape[0], iblock[k, cell])
                    itv = np.full(block.shape[0], ithr[k, cell])
                    exv = np.full(block.shape[0], excl[k, cell])
                    psv = np.full(block.shape[0], pshal[k, cell])
                    plv = np.full(block.shape[0], pland[k, cell])
                    cnt, nb = _line_counts(block.T, ibv, itv, exv, psv,
                                           plv, ireinf)
                    w = block.shape[1]
                    ntot = w * block.shape[0] + \
                        (ireinf - 1) * nb.sum() * w
                    ob = max(np.rint(
                        (1.0 - cnt.sum() / max(ntot, 1)) * NOOBSTRT), 0.0)
                    ob_ew[cell] = ob / NOOBSTRT
                comb = PENHCOR * np.sqrt(ob_ns * ob_ew)
                comb = np.minimum(comb, 1.0)
                kobscor[m, k, :nl, is_] = np.where(sea2d[k, :nl], comb, 1.0)

            # kobslon: strip = lon band from neighbour centre to own
            # centre; lines run along longitude within the cell's own
            # latitude band (±xdella/2)
            latt = lats[k] + 0.5 * grid.xdella
            latb = lats[k] - 0.5 * grid.xdella
            jt = int(np.clip(np.rint((90.0 - latt) * invres), 0,
                             topo.ilat - 1))
            jb = int(np.clip(np.rint((90.0 - latb) * invres), 0,
                             topo.ilat - 1))
            jt, jb = min(jt, jb), max(jt, jb)
            band = topo.elev[jt:jb + 1, :n]              # (nrows, n)
            for is_, (ol, orr) in enumerate([(-1.0, 0.0), (0.0, 1.0)]):
                # shrink by one sample off the own-centre edge like the
                # reference (XLONR=centre−res / XLONL=centre+res)
                lcols, lcell = _columns_of_cells(
                    grid, topo, k, ol + (0 if is_ else 0.0), orr)
                sub = band[:, lcols]
                ob_row = np.ones(nl)
                for cell in np.unique(lcell):
                    block = sub[:, lcell == cell]        # (nrows, w)
                    nrl = block.shape[0]
                    ibv = np.full(nrl, iblock[k, cell])
                    itv = np.full(nrl, ithr[k, cell])
                    exv = np.full(nrl, excl[k, cell])
                    psv = np.full(nrl, pshal[k, cell])
                    plv = np.full(nrl, pland[k, cell])
                    cnt, nb = _line_counts(block.T, ibv, itv, exv, psv,
                                           plv, ireinf)
                    w = block.shape[1]
                    ntot = nrl * w + (ireinf - 1) * nb.sum() * w
                    ob = max(np.rint(
                        (1.0 - cnt.sum() / max(ntot, 1)) * NOOBSTRT), 0.0)
                    ob_row[cell] = ob / NOOBSTRT
                kobslon[m, k, :nl, is_] = np.where(sea2d[k, :nl],
                                                   ob_row, 1.0)

    return dict(kobslat=kobslat, kobslon=kobslon, kobscor=kobscor)


def make_bathymetry(topo: TopoData, grid: WaveGrid, fr: np.ndarray,
                    nfre_red: int):
    """Full preprocessor: topo → (model bathymetry, obstruction tables).

    Returns (bathy, obs) where ``bathy`` is (ngy, ngx) water depth in the
    model convention (positive = sea depth m, −999 = land; mblock.F90
    selects sea via BATHY > −990) and ``obs`` is the dict from
    :func:`obstructions` on the full grid.
    """
    wamdepth, pland, pshal = wam_depth(topo, grid)
    obs = obstructions(topo, grid, wamdepth, pland, pshal, fr, nfre_red)
    bathy = np.where(wamdepth < 0.0, np.minimum(-wamdepth, 999.0), -999.0)
    # unused slots of reduced rows → land
    cols = np.arange(grid.ngx)[None, :]
    bathy = np.where(cols < grid.nlonrgg[:, None], bathy, -999.0)
    return bathy, obs


def obstructions_to_block(obs: dict, blk) -> tuple:
    """Map grid obstruction tables to the sea-point block.

    Returns (obslat, obslon, obscor) shaped (nfre_red, npts, 2|4) as
    consumed by ops.propagation.build_stencil_tables.
    """
    kx, ix = blk.kxlt, blk.ixlg
    obslat = obs["kobslat"][:, kx, ix, :]
    obslon = obs["kobslon"][:, kx, ix, :]
    obscor = obs["kobscor"][:, kx, ix, :]
    return obslat, obslon, obscor


def combine_bathy_lakes(topo: TopoData, lakes: "TopoData | np.ndarray",
                        *, min_lake_depth: float = 1.0) -> TopoData:
    """Merge lake depths into a land topography
    (combine_bathy_laked.F90:60-300 role): where the lake data set marks
    water (negative elevation ≤ −min_lake_depth) over land in ``topo``,
    carve the lake in.
    """
    lelev = lakes.elev if isinstance(lakes, TopoData) else np.asarray(lakes)
    if lelev.shape != topo.elev.shape:
        raise ValueError("lake grid must match the topo grid")
    land = topo.elev > 0.0
    lake = lelev <= -min_lake_depth
    elev = np.where(land & lake, lelev, topo.elev)
    return TopoData(invres=topo.invres, elev=elev)
