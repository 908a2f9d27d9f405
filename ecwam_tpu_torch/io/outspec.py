"""2-D spectra output — the OUTSPEC/OUTWSPEC path — and point output
(MCOUT/OUTWPSP).

Copied from ``ecwam_tpu/io/outspec.py`` (numpy only, no JAX), with its
imports pointed at ``ecwam_tpu_torch`` (the port imports nothing of the
JAX package); the code is unchanged.

The reference GRIB-encodes the full spectrum as parameter 251, one message
per (direction, frequency) bin (outwspec.F90:236-250),
usable both as product output and as a GRIB restart (LGRIBOUT,
wamodel.F90:422-453).  Here each bin rides the native GRIB1 codec with the
bin indices packed into the level field (GRIB1 has no spectral template;
the reference uses an ECMWF local definition for the same purpose).

Point output selects the nearest sea points to requested (lat, lon)
positions at init (mcout.F90 role) and appends their full spectra per
output date (outwpsp.F90 role) to an .npz journal.
"""

from __future__ import annotations

import os

import numpy as np

from ecwam_tpu_torch.io import grib, gribout

SPEC_PARAM = 251
SPEC_TABLE = 140


def _level(ik: int, im: int) -> int:
    """Pack direction/frequency indices (1-based) into the 16-bit GRIB1
    level slot: level = 100·(ik+1) + (im+1); nang, nfre ≤ 99."""
    return 100 * (ik + 1) + (im + 1)


def write_spectra(path: str, fl1, blk, grid, date14: str,
                  *, bits: int = 16):
    """Append one GRIB message per spectral bin. fl1 (nang, nfre, n_real)."""
    fl1 = np.asarray(fl1)
    nang, nfre = fl1.shape[0], fl1.shape[1]
    pl = np.asarray(grid.nlonrgg[::-1], np.int64)
    lats = np.asarray(grid.lats)
    base = dict(
        table2_version=SPEC_TABLE, param=SPEC_PARAM, centre=98,
        grid_type=0, ni=-1, nj=grid.ngy,
        lat1=int(round(lats[-1] * 1000)), lon1=0,
        lat2=int(round(lats[0] * 1000)),
        lon2=int(round((360.0 - grid.zdello.min()) * 1000)),
        dj=int(round(grid.xdella * 1000)),
        data_date=int(date14[:8]), data_time=int(date14[8:12]),
        bits_per_value=bits)
    with open(path, "ab") as f:
        for ik in range(nang):
            for im in range(nfre):
                flat = gribout.block_to_grid(fl1[ik, im], blk, grid)
                meta = dict(base, level=_level(ik, im), level_type=99)
                f.write(grib.encode_message(flat, meta, pl=pl,
                                            use_bitmap=True))


def read_spectra(path: str, blk, grid, *, nang: int, nfre: int):
    """Decode a spectra file back to (nang, nfre, n_real) — the GRIB
    restart read path (outspec as restart, wamodel.F90:422-453)."""
    msgs = grib.read_messages(path)
    n_real = len(blk.ixlg)
    fl1 = np.zeros((nang, nfre, n_real))
    date14 = None
    for m in msgs:
        if m.meta["param"] != SPEC_PARAM:
            continue
        lvl = m.meta["level"]
        ik, im = divmod(lvl, 100)
        ik -= 1
        im -= 1
        if not (0 <= ik < nang and 0 <= im < nfre):
            continue
        rows = gribout.read_field_grid(m, grid)
        for j in range(grid.ngy):
            sel = blk.kxlt == j
            fl1[ik, im, sel] = rows[j][blk.ixlg[sel]]
        date14 = m.date14
    fl1 = np.where(fl1 == grib.MISSING, 0.0, fl1)
    return fl1, date14


# ---------------------------------------------------------------------------
# point output (mcout.F90 + outwpsp.F90)
# ---------------------------------------------------------------------------

class PointOutput:
    """Nearest-sea-point spectra journal.

    positions: iterable of (lat, lon) degrees.  Selection happens once at
    construction (MCOUT); ``append`` records the spectra of those points
    at one date (OUTWPSP) and ``write``/``load`` round-trip the journal.
    """

    def __init__(self, positions, blk, grid):
        self.positions = [(float(a), float(o)) for a, o in positions]
        lats = np.asarray(grid.lats)[blk.kxlt]
        zdello = np.asarray(grid.zdello)[blk.kxlt]
        lons = blk.ixlg * zdello
        self.indices = []
        for plat, plon in self.positions:
            dlon = np.mod(lons - plon + 180.0, 360.0) - 180.0
            d2 = (lats - plat) ** 2 + (np.cos(np.radians(plat)) * dlon) ** 2
            self.indices.append(int(np.argmin(d2)))
        self.dates: list[str] = []
        self.spectra: list[np.ndarray] = []

    def append(self, date14: str, fl1):
        """fl1 (nang, nfre, n_real) → record (npoints, nang, nfre)."""
        fl1 = np.asarray(fl1)
        self.dates.append(date14)
        self.spectra.append(
            np.stack([fl1[:, :, i] for i in self.indices]))

    def write(self, fn: str):
        np.savez_compressed(
            fn,
            positions=np.asarray(self.positions),
            indices=np.asarray(self.indices),
            dates=np.asarray(self.dates),
            spectra=np.asarray(self.spectra))
        return fn


def load_points(fn: str) -> dict:
    with np.load(fn) as z:
        return dict(positions=z["positions"], indices=z["indices"],
                    dates=[str(d) for d in z["dates"]],
                    spectra=z["spectra"])
