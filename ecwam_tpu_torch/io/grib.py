"""GRIB file I/O over the native C++ codecs (ecwam_tpu_torch/native/grib{1,2}.cc).

Copied unchanged from ``ecwam_tpu/io/grib.py`` (numpy only, no
JAX), with its imports pointed at ``ecwam_tpu_torch``: the port
imports nothing of the JAX package.

Plays the role eccodes plays for the reference (readwind.F90 forcing
ingest, wgribencode.F90 product output, edition 1 or 2 per parameter).
Message metadata mirrors the GRIB1 PDS/GDS fields the wave model uses;
the edition-2 codec reuses the same 32-slot meta ABI (see grib2.cc) so
readers are edition-agnostic.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np

from ecwam_tpu_torch import native

MISSING = -9.0e9

_META_KEYS = (
    "total_len", "table2_version", "centre", "generating_process",
    "grid_id", "param", "level_type", "level", "data_date", "data_time",
    "unit_of_time", "p1", "p2", "time_range", "grid_type", "ni", "nj",
    "lat1", "lon1", "lat2", "lon2", "di", "dj", "scan_mode", "n_values",
    "has_bitmap", "n_pl", "decimal_scale", "binary_scale",
    "bits_per_value", "sub_centre", "reserved")


def _lib():
    lib = native.load("grib1")
    lib.g1_next.restype = ctypes.c_int
    lib.g1_next.argtypes = [ctypes.c_char_p, ctypes.c_long,
                            ctypes.POINTER(ctypes.c_long),
                            ctypes.POINTER(ctypes.c_long)]
    lib.g1_info.restype = ctypes.c_int
    lib.g1_values.restype = ctypes.c_int
    lib.g1_encode.restype = ctypes.c_long
    return lib


def _lib2():
    lib = native.load("grib2")
    lib.g2_next.restype = ctypes.c_int
    lib.g2_next.argtypes = [ctypes.c_char_p, ctypes.c_long,
                            ctypes.POINTER(ctypes.c_long),
                            ctypes.POINTER(ctypes.c_long)]
    lib.g2_info.restype = ctypes.c_int
    lib.g2_values.restype = ctypes.c_int
    lib.g2_encode.restype = ctypes.c_long
    return lib


@dataclasses.dataclass
class GribMessage:
    meta: dict
    values: np.ndarray           # flat, MISSING where bitmapped out
    pl: np.ndarray | None = None  # reduced-grid row lengths
    edition: int = 1

    @property
    def lats(self) -> np.ndarray:
        m = self.meta
        nj = m["nj"]
        if nj <= 1:
            return np.array([m["lat1"] / 1000.0])
        return np.linspace(m["lat1"] / 1000.0, m["lat2"] / 1000.0, nj)

    @property
    def lons(self) -> np.ndarray:
        m = self.meta
        ni = m["ni"]
        if ni is None or ni < 0:
            raise ValueError("reduced grid has no single lon axis")
        return np.linspace(m["lon1"] / 1000.0, m["lon2"] / 1000.0, ni)

    def grid_values(self) -> np.ndarray:
        """(nj, ni) array for regular grids."""
        m = self.meta
        return self.values.reshape(m["nj"], m["ni"])

    @property
    def date14(self) -> str:
        return f"{self.meta['data_date']:08d}{self.meta['data_time']:04d}00"


# ECMWF paramId → GRIB2 (discipline, parameterCategory, parameterNumber)
# for the WMO-defined ocean-wave parameters (code table 4.2, discipline 10
# category 0); parameters without a WMO entry use the local concordance
# below (category 193 = ECMWF-local, number = paramId − 140000), which the
# decoder inverts, so our own files round-trip exactly.
PARAMID_GRIB2 = {
    140229: (10, 0, 3),    # swh: sig. height of combined wind waves+swell
    140230: (10, 0, 14),   # mwd: mean direction of combined waves
    140232: (10, 0, 15),   # mwp: mean period of combined waves
    140234: (10, 0, 5),    # shww: sig. height of wind waves
    140235: (10, 0, 4),    # mdww: direction of wind waves
    140236: (10, 0, 6),    # mpww: mean period of wind waves
    140237: (10, 0, 8),    # shts: sig. height of total swell
    140238: (10, 0, 7),    # mdts: direction of swell waves
    140239: (10, 0, 9),    # mpts: mean period of total swell
    140231: (10, 0, 34),   # pp1d: peak wave period
    140252: (10, 0, 43),   # wsk: kurtosis of the sea-surface elevation
    140253: (10, 0, 44),   # bfi: Benjamin-Feir index
    140218: (10, 0, 24),   # hmax: maximum individual wave height
    140217: (10, 0, 23),   # tmax: period of the maximum wave
    140215: (10, 0, 21),   # ust: u-component of Stokes drift
    140216: (10, 0, 22),   # vst: v-component of Stokes drift
    165165: (0, 2, 2),     # u10: 10 m zonal wind
    165166: (0, 2, 3),     # v10: 10 m meridional wind
}
_GRIB2_PARAMID = {v: k for k, v in PARAMID_GRIB2.items()}


def paramid_to_grib2(pid: int):
    """(discipline, category, number) for an ECMWF paramId.

    Parameters without a WMO 4.2 entry use the local disciplines 192
    (carrying the GRIB1 table in the category octet — lossless for any
    table ≤ 255) and 193 (the 262xxx ocean range)."""
    if pid in PARAMID_GRIB2:
        return PARAMID_GRIB2[pid]
    table, param = divmod(pid, 1000)
    if 0 <= table <= 255 and 0 <= param <= 255:
        return (192, table, param)
    if 262000 <= pid < 262256:
        return (193, 0, pid - 262000)
    raise ValueError(f"no GRIB2 concordance for paramId {pid}")


def grib2_to_paramid(discipline: int, category: int, number: int) -> int:
    key = (discipline, category, number)
    if key in _GRIB2_PARAMID:
        return _GRIB2_PARAMID[key]
    if discipline == 192:
        return category * 1000 + number
    if discipline == 193:
        return 262000 + number
    return discipline * 1000000 + category * 1000 + number


def _decode_one(msg: bytes, edition: int) -> GribMessage:
    lib = _lib() if edition == 1 else _lib2()
    info = lib.g1_info if edition == 1 else lib.g2_info
    values = lib.g1_values if edition == 1 else lib.g2_values
    meta = (ctypes.c_int64 * 32)()
    pl = (ctypes.c_int64 * 8192)()
    rc = info(msg, len(msg), meta, pl, 8192)
    if rc != 0:
        raise ValueError(f"grib{edition} decode failed rc={rc}")
    md = {k: int(meta[i]) for i, k in enumerate(_META_KEYS)}
    if edition == 2:
        # ABI slots: grid_id = discipline, param = category*1000 + number;
        # restore the GRIB1-style (table2_version, param) surface
        pid = grib2_to_paramid(md["grid_id"], md["param"] // 1000,
                               md["param"] % 1000)
        md["table2_version"], md["param"] = divmod(pid, 1000)
        md["grid_id"] = 255
    nv = md["n_values"]
    vals = np.empty(nv, np.float64)
    rc = values(msg, len(msg),
                vals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                nv, ctypes.c_double(MISSING))
    if rc != 0:
        raise ValueError(f"grib{edition} unpack failed rc={rc}")
    npl = md["n_pl"]
    plarr = np.array([int(pl[i]) for i in range(npl)],
                     np.int64) if npl else None
    return GribMessage(meta=md, values=vals, pl=plarr, edition=edition)


def read_messages(path: str) -> list:
    """Decode every GRIB message in the file, edition 1 or 2."""
    with open(path, "rb") as f:
        buf = f.read()
    out = []
    i = 0
    n = len(buf)
    while True:
        i = buf.find(b"GRIB", i)
        if i < 0 or i + 16 > n:
            break
        edition = buf[i + 7]
        if edition == 1:
            mlen = int.from_bytes(buf[i + 4: i + 7], "big")
        elif edition == 2:
            mlen = int.from_bytes(buf[i + 8: i + 16], "big")
        else:
            i += 4
            continue
        if mlen < 32 or i + mlen > n:
            i += 4
            continue
        out.append(_decode_one(buf[i: i + mlen], edition))
        i += mlen
    return out


def encode_message(values: np.ndarray, meta: dict, *,
                   pl: np.ndarray | None = None,
                   missing: float = MISSING,
                   use_bitmap: bool | None = None,
                   edition: int = 1) -> bytes:
    lib = _lib() if edition == 1 else _lib2()
    encode = lib.g1_encode if edition == 1 else lib.g2_encode
    values = np.ascontiguousarray(values, np.float64).ravel()
    m = (ctypes.c_int64 * 32)()
    defaults = dict(
        table2_version=140, centre=98, generating_process=110, grid_id=255,
        level_type=102, level=0, unit_of_time=1, p1=0, p2=0, time_range=0,
        grid_type=0, scan_mode=0, decimal_scale=0, bits_per_value=16,
        sub_centre=0, di=-1, dj=0, ni=-1, nj=0,
        lat1=0, lon1=0, lat2=0, lon2=0,
        data_date=20000101, data_time=0)
    md = {**defaults, **meta}
    if edition == 2:
        disc, cat, num = paramid_to_grib2(
            md["table2_version"] * 1000 + md["param"])
        md["grid_id"] = disc
        md["param"] = cat * 1000 + num
    md["n_pl"] = len(pl) if pl is not None else 0
    for i, k in enumerate(_META_KEYS):
        m[i] = int(md.get(k, 0))
    plc = ((ctypes.c_int64 * len(pl))(*[int(x) for x in pl])
           if pl is not None else (ctypes.c_int64 * 1)(0))
    if use_bitmap is None:
        use_bitmap = bool(np.any(values == missing))
    cap = values.size * 4 + 16384
    out = ctypes.create_string_buffer(cap)
    n = encode(values.ctypes.data_as(
        ctypes.POINTER(ctypes.c_double)),
        values.size, m, plc, out, cap,
        ctypes.c_double(missing), ctypes.c_int(1 if use_bitmap else 0))
    if n < 0:
        raise ValueError(f"grib{edition} encode failed rc={n}")
    return out.raw[:n]


def write_messages(path: str, messages: list):
    """messages: list of (values, meta[, pl]) tuples or dicts."""
    with open(path, "wb") as f:
        for msg in messages:
            if isinstance(msg, GribMessage):
                f.write(encode_message(msg.values, msg.meta, pl=msg.pl))
            else:
                values, meta = msg[0], msg[1]
                pl = msg[2] if len(msg) > 2 else None
                f.write(encode_message(values, meta, pl=pl))
