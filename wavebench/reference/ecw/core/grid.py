"""Reduced (octahedral) Gaussian wave grid and the 1-D sea-point block.

Copied unchanged from ``ecwam_tpu/core/grid.py`` (numpy only, no
JAX), with its imports pointed at ``wavebench.reference.ecw``: the port
imports nothing of the JAX package.

Host-side re-derivation of the reference's grid machinery:
  - octahedral grid catalog            share/ecwam/scripts/ecwam_grids.py:42-114
  - reduced-grid row setup             src/programs/preproc.F90:293-316
  - sea-point blocking (land removal)  src/ecwam/mgrid.F90:33-63, mblock.F90:79-90
  - metric terms (cosph, dellam, ...)  src/ecwam/readmdlconf.F90:136-165

The block ordering is latitude-major, south → north, west → east within a
row — exactly the reference's BLK2GLO layout, which makes a 1-D
latitude-band sharding contiguous.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from wavebench.reference.ecw.core import constants as c

XLATMAX = 87.5           # polar singularity cap (readmdlconf.F90:52)

# First Gaussian latitude per octahedral resolution N
# (ecwam_grids.py:42-65; computed with atlas-gaussian-latitudes)
FIRST_GAUSSIAN_LAT = {
    16: 85.760587120444, 24: 87.159094555863, 32: 87.863798839233,
    48: 88.572168514007, 64: 88.927735352296, 80: 89.141519426461,
    96: 89.284227532514, 128: 89.462821568577, 160: 89.570089550607,
    200: 89.655964246870, 256: 89.731148618413, 320: 89.784876907219,
    400: 89.827874645894, 512: 89.865508687700, 576: 89.880445682778,
    640: 89.892396445590, 800: 89.913910432567, 1024: 89.932737928460,
    1280: 89.946187715666, 1600: 89.956948491058, 2000: 89.965557716640,
    4000: 89.982777782041, 8000: 89.991388621915,
}


@dataclasses.dataclass(frozen=True)
class WaveGrid:
    """Geometry of the (possibly reduced) lat-lon wave grid.

    Row index ``k`` runs south → north (k=0 at amosop), matching the
    reference's internal convention (mblock.F90:79-90).
    """

    name: str
    ngx: int                  # max points per row
    ngy: int                  # number of latitude rows
    nlonrgg: np.ndarray       # (ngy,) points per row
    amowep: float             # west  (deg)
    amoeap: float             # east  (deg)
    amosop: float             # south (deg)
    amonop: float             # north (deg)
    xdella: float             # latitude increment (deg)
    zdello: np.ndarray        # (ngy,) longitude increment per row (deg)
    iper: bool                # periodic in longitude
    irgg: bool                # reduced grid

    # metric terms (readmdlconf.F90:136-165)
    delphi: float             # latitude increment (m)
    dellam: np.ndarray        # (ngy,) longitude increment at equator (m)
    sinph: np.ndarray         # (ngy,) sin(lat), capped at ±XLATMAX
    cosph: np.ndarray         # (ngy,) cos(lat), capped

    @property
    def lats(self) -> np.ndarray:
        return self.amosop + np.arange(self.ngy) * self.xdella

    def lons(self, k: int) -> np.ndarray:
        return self.amowep + np.arange(self.nlonrgg[k]) * self.zdello[k]


def _metrics(ngy, amosop, xdella, zdello):
    lats = amosop + np.arange(ngy) * xdella
    xlat = lats * c.RAD
    sinph = np.sin(xlat)
    cosph = np.cos(xlat)
    cosphmin = np.cos(XLATMAX * c.RAD)
    polar = cosph <= cosphmin
    cosph = np.where(polar, np.cos(XLATMAX * c.RAD), cosph)
    sinph = np.where(polar, np.sign(sinph) * np.sin(XLATMAX * c.RAD), sinph)
    delphi = xdella * c.CIRC / 360.0
    dellam = zdello * c.CIRC / 360.0
    return delphi, dellam, sinph, cosph


def octahedral_grid(n: int) -> WaveGrid:
    """Octahedral reduced Gaussian grid O<n> (ecwam_grids.py:68-114).

    The wave model approximates the Gaussian latitudes as equally spaced
    between ±lat0 (ecwam_grids.py "dlat"); rows have 20+4j points from the
    poles inwards.
    """
    if n not in FIRST_GAUSSIAN_LAT:
        raise ValueError(f"no first-latitude entry for O{n}")
    lat0 = FIRST_GAUSSIAN_LAT[n]
    ngy = 2 * n
    # south→north ordering: southernmost row is the outermost (20 points)
    pl_north_to_south = np.concatenate([
        20 + 4 * np.arange(n),                 # pole → equator
        (20 + 4 * np.arange(n))[::-1],         # equator → pole
    ])
    nlonrgg = pl_north_to_south[::-1].copy()   # flip to south→north
    ngx = int(nlonrgg.max())
    xdella = 2.0 * lat0 / (ngy - 1)
    zdello = 360.0 / nlonrgg.astype(np.float64)
    delphi, dellam, sinph, cosph = _metrics(ngy, -lat0, xdella, zdello)
    return WaveGrid(
        name=f"O{n}", ngx=ngx, ngy=ngy, nlonrgg=nlonrgg.astype(np.int32),
        amowep=0.0, amoeap=360.0 - 360.0 / ngx, amosop=-lat0, amonop=lat0,
        xdella=xdella, zdello=zdello, iper=True, irgg=True,
        delphi=delphi, dellam=dellam, sinph=sinph, cosph=cosph)


def regular_grid(
    xdella: float,
    *,
    amosop: float = -90.0,
    amonop: float = 90.0,
    amowep: float = 0.0,
    reduced: bool = True,
    name: str = "regular",
) -> WaveGrid:
    """Regular/reduced lat-lon grid built from an increment.

    Follows the aqua-planet path of preproc (preproc.F90:293-316 +
    uiprep.F90:355-380): global periodic grid, rows reduced by cos(lat) and
    rounded to even when ``reduced``.
    """
    ngy = int((amonop - amosop) / xdella) + 1
    ngx = int(round(360.0 / xdella))
    lats = amosop + np.arange(ngy) * xdella
    if reduced:
        nl = np.maximum(np.rint(ngx * np.cos(lats * c.RAD)).astype(int), 2)
        nl = nl + (nl % 2)                     # round odd up to even
    else:
        nl = np.full(ngy, ngx, dtype=int)
    zdello = 360.0 / nl.astype(np.float64)
    delphi, dellam, sinph, cosph = _metrics(ngy, amosop, xdella, zdello)
    return WaveGrid(
        name=name, ngx=ngx, ngy=ngy, nlonrgg=nl.astype(np.int32),
        amowep=amowep, amoeap=amowep + 360.0 - 360.0 / ngx,
        amosop=amosop, amonop=amonop,
        xdella=xdella, zdello=zdello, iper=True, irgg=reduced,
        delphi=delphi, dellam=dellam, sinph=sinph, cosph=cosph)


@dataclasses.dataclass(frozen=True)
class SeaPointBlock:
    """The 1-D block of sea points (land removed), south→north row-major.

    Equivalent of BLK2GLO (mblock.F90:79-90): ``ixlg``/``kxlt`` map block
    index → (row position, latitude row), both 0-based here.
    """

    nsea: int
    ixlg: np.ndarray          # (nsea,) 0-based lon index within the row
    kxlt: np.ndarray          # (nsea,) 0-based lat row (south→north)
    depth: np.ndarray         # (nsea,) water depth (m)
    grid2blk: np.ndarray      # (ngy, ngx) block index or -1 for land/unused

    @property
    def row_start(self) -> np.ndarray:
        """First block index of each latitude row (searchable via kxlt)."""
        return np.searchsorted(self.kxlt, np.arange(self.grid2blk.shape[0]))


def build_sea_point_block(grid: WaveGrid, bathy: np.ndarray) -> SeaPointBlock:
    """Select sea points from a (ngy, ngx) bathymetry field.

    ``bathy[k, i]`` is water depth (m) at row k (south→north), point i; land
    is marked by values ≤ -990 (mblock.F90:82: sea iff BATHY > -990).
    """
    assert bathy.shape == (grid.ngy, grid.ngx)
    cols = np.arange(grid.ngx)[None, :]
    in_row = cols < grid.nlonrgg[:, None]
    sea = (bathy > -990.0) & in_row
    kxlt, ixlg = np.nonzero(sea)              # row-major → lat-major order
    grid2blk = np.full((grid.ngy, grid.ngx), -1, dtype=np.int64)
    grid2blk[kxlt, ixlg] = np.arange(kxlt.size)
    return SeaPointBlock(
        nsea=int(kxlt.size),
        ixlg=ixlg.astype(np.int32),
        kxlt=kxlt.astype(np.int32),
        depth=bathy[kxlt, ixlg].astype(np.float64),
        grid2blk=grid2blk,
    )


def aqua_bathymetry(grid: WaveGrid, depth: float = 999.0) -> np.ndarray:
    """Aqua-planet bathymetry: deep everywhere, land at polar rows.

    preproc.F90 LAQUA branch: BATHY=BATHYMAX, first/last latitude set to
    land so the propagation stencil has a boundary.
    """
    b = np.full((grid.ngy, grid.ngx), depth, dtype=np.float64)
    for k in range(grid.ngy):
        b[k, grid.nlonrgg[k]:] = -999.0        # unused slots in reduced rows
    b[0, :] = -999.0
    b[-1, :] = -999.0
    return b
