"""GRIB product output — the OUTWINT→OUTINT→WGRIBENOUT path.

Copied from ``ecwam_tpu/io/gribout.py`` (numpy only, no JAX), with its
imports pointed at ``ecwam_tpu_torch`` (the port imports nothing of the
JAX package) and one change: :func:`block_to_grid` scatters all rows in
one step instead of one row at a time (the same values; at O320 0.31 s
a field became a few ms, for 61 fields an output date).

Encodes integrated-parameter fields on the wave grid into GRIB1 messages
via the native codec, with the reference's paramId registry
(src/ecwam/mpcrtbl.F90:93-320 DEFINE_PARAMETER calls) and
a land bitmap (missing sea mask), reduced-grid PL from NLONRGG.
"""

from __future__ import annotations

import numpy as np

from ecwam_tpu_torch.io import grib

# name → ECMWF paramId (table*1000 + parameter), mpcrtbl.F90:93-320
PARAM_IDS = {
    "swh": 140229, "mwd": 140230, "mwp": 140232, "ustar": 140084,
    "dwi": 140249, "pp1d": 140231, "cdww": 140233,
    "tauw_over_ust2": 140083, "msqs": 140244, "mss": 140244,
    "wind": 140245, "shww": 140234, "shts": 140237, "mdww": 140235,
    "mdts": 140238, "mpww": 140236, "mpts": 140239,
    "mwp1": 140220, "mwp2": 140221, "mp1": 140220, "mp2": 140221,
    "wdw": 140222, "p1ww": 140223, "p1ps": 140226, "p2ww": 140224,
    "p2ps": 140227, "dwww": 140225, "dwps": 140228,
    "wsk": 140252, "bfi": 140253, "wsp": 140254, "wmb": 140219,
    "hmax": 140218, "tmax": 140217, "ust": 140215, "vst": 140216,
    "ocu": 262140, "vcu": 262139,
    "phioc": 140212, "phiaw": 140211, "tauoc": 140214,
    "u10": 165165, "v10": 165166,   # (table 128 in practice: 165/166)
}


def block_to_grid(values, blk, grid, missing=grib.MISSING):
    """Scatter a sea-point block field onto the (reduced) lat-lon rows —
    the MAKEGRID role (makegrid.F90:10).  Returns flat row-major values
    (south→north per the block, flipped to GRIB north→south scan)."""
    n = np.asarray(grid.nlonrgg, np.int64)
    # GRIB scan mode 0: north → south, so row k starts after rows > k
    start = int(n.sum()) - np.cumsum(n)
    flat = np.full(int(n.sum()), missing)
    flat[start[blk.kxlt] + np.asarray(blk.ixlg)] = np.asarray(values,
                                                             np.float64)
    return flat


def encode_field(name: str, values_block, blk, grid, date14: str,
                 edition: int = 1) -> bytes:
    """GRIB edition 1 or 2 (wgribencode.F90 IGRIB_EDITION selection)."""
    pid = PARAM_IDS.get(name, 140080)
    table, param = divmod(pid, 1000)
    flat = block_to_grid(values_block, blk, grid)
    pl = np.asarray(grid.nlonrgg[::-1], np.int64)
    lats = np.asarray(grid.lats)
    meta = dict(
        table2_version=table, param=param, centre=98,
        grid_type=0, ni=-1, nj=grid.ngy,
        lat1=int(round(lats[-1] * 1000)), lon1=0,
        lat2=int(round(lats[0] * 1000)),
        lon2=int(round((360.0 - grid.zdello.min()) * 1000)),
        dj=int(round(grid.xdella * 1000)),
        data_date=int(date14[:8]), data_time=int(date14[8:12]),
        bits_per_value=16)
    return grib.encode_message(flat, meta, pl=pl, use_bitmap=True,
                               edition=edition)


def write_fields(path: str, fields: dict, blk, grid, date14: str,
                 edition: int = 1):
    """fields: name → (n_real,) values.  Appends one message per field."""
    with open(path, "ab") as f:
        for name, vals in fields.items():
            f.write(encode_field(name, vals, blk, grid, date14,
                                 edition=edition))


def read_field_grid(msg: grib.GribMessage, grid):
    """Inverse of block_to_grid for test round-trips: returns per-row list
    south→north."""
    pl = msg.pl
    rows = []
    off = 0
    for n in pl:
        rows.append(msg.values[off: off + int(n)])
        off += int(n)
    return rows[::-1]
