"""Forcing ingestion: the PREWIND/READWIND/GRIB2WGRID/WAMWND pipeline.

Copied unchanged from ``ecwam_tpu/io/forcing.py`` (numpy only, no
JAX), with its imports pointed at ``ecwam_tpu_torch``: the port
imports nothing of the JAX package.

The reference reads GRIB wind/ice fields on an arbitrary regular or
reduced lat-lon grid, bilinearly interpolates them to the wave grid
(src/ecwam/grib2wgrid.F90:20-30) and converts components
to speed/direction at the model points (wamwnd.F90).  Here the container
is a ``.npz`` file (until the native GRIB codec lands); the interpolation
and conversion are faithful re-derivations.

npz layout (time-major):
  times:   (nt,) int64 YYYYMMDDHHMMSS
  lats:    (ny,) descending or ascending degrees
  lons:    (nx,) degrees
  u10,v10: (nt, ny, nx)   10 m wind components  [or wspd+wdir]
  cicover: (nt, ny, nx)   optional sea-ice cover
  ucur,vcur: optional surface currents
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ecwam_tpu_torch.core import constants as c

WSPMIN = 1.0               # minimum wind speed (userin.F90:914-917)


def rotate_coords(plat, plon, sp_lat, sp_lon):
    """True wave-point coords → rotated-grid coords for a grid whose
    south pole sits at (sp_lat, sp_lon) (GRIB rotated lat-lon: compute
    the source-grid coordinates of each target point, then interpolate
    as usual)."""
    th = np.deg2rad(90.0 + sp_lat)          # rotation about the y-axis
    lam = np.deg2rad(np.asarray(plon, np.float64) - sp_lon)
    phi = np.deg2rad(np.asarray(plat, np.float64))
    x = np.cos(phi) * np.cos(lam)
    y = np.cos(phi) * np.sin(lam)
    z = np.sin(phi)
    xr = np.cos(th) * x + np.sin(th) * z
    zr = -np.sin(th) * x + np.cos(th) * z
    rlat = np.rad2deg(np.arcsin(np.clip(zr, -1.0, 1.0)))
    rlon = np.rad2deg(np.arctan2(y, xr))
    return rlat, rlon % 360.0


def bilinear_weights(lats, lons, plat, plon, *, rotation=None):
    """Bilinear interpolation indices/weights from a (possibly irregular)
    lat-lon grid to scattered points (grib2wgrid.F90 interpolation core).

    Longitudes are periodic; latitudes are clamped at the poles; both
    axes may be non-uniformly spaced (the reference's "irregular"
    lat-lon grids).  ``rotation=(sp_lat, sp_lon)`` interprets the source
    grid as a rotated lat-lon grid with that south pole.  Returns
    (iy0, iy1, wy, ix0, ix1, wx) arrays over the points.
    """
    lats = np.asarray(lats, np.float64)
    lons = np.asarray(lons, np.float64)
    if rotation is not None:
        plat, plon = rotate_coords(plat, plon, *rotation)
    asc = lats[1] > lats[0]
    la = lats if asc else lats[::-1]
    ny, nx = len(lats), len(lons)

    iy = np.searchsorted(la, plat, side="right") - 1
    iy = np.clip(iy, 0, ny - 2)
    wy = np.clip((plat - la[iy]) / (la[iy + 1] - la[iy]), 0.0, 1.0)
    iy0, iy1 = iy, iy + 1
    if not asc:
        iy0, iy1 = ny - 1 - iy0, ny - 1 - iy1

    lo = (lons - lons[0]) % 360.0
    uniform = nx < 2 or np.allclose(np.diff(lo), lo[1] - lo[0])
    x0 = ((np.asarray(plon, np.float64) - lons[0]) % 360.0)
    if uniform and nx >= 2:
        dlon = lo[1] % 360.0
        x = x0 / dlon
        ix0 = np.floor(x).astype(int) % nx
        wx = x - np.floor(x)
    else:
        # irregular spacing: searchsorted with a periodic last cell
        ix0 = np.clip(np.searchsorted(lo, x0, side="right") - 1,
                      0, nx - 1)
        span = np.where(ix0 < nx - 1, lo[(ix0 + 1) % nx] - lo[ix0],
                        360.0 - lo[nx - 1])
        wx = np.clip((x0 - lo[ix0]) / np.maximum(span, 1e-12), 0.0, 1.0)
    ix1 = (ix0 + 1) % nx
    return iy0, iy1, wy, ix0, ix1, wx


def interp_field(field2d, w, missing=None):
    """Bilinear interpolation with the reference's missing-data rules
    (grib2wgrid.F90:34-37): corners flagged missing fall back to the
    CLOSEST grid point; if the closest is missing too, the average of
    the non-missing corners; all-missing stays missing."""
    iy0, iy1, wy, ix0, ix1, wx = w
    f00 = field2d[iy0, ix0]
    f01 = field2d[iy0, ix1]
    f10 = field2d[iy1, ix0]
    f11 = field2d[iy1, ix1]
    w00 = (1 - wy) * (1 - wx)
    w01 = (1 - wy) * wx
    w10 = wy * (1 - wx)
    w11 = wy * wx
    bl = w00 * f00 + w01 * f01 + w10 * f10 + w11 * f11
    if missing is None:
        return bl
    vals = np.stack([f00, f01, f10, f11])
    wmat = np.stack([w00, w01, w10, w11])
    miss = vals == missing
    any_miss = miss.any(axis=0)
    nearest = np.argmax(wmat, axis=0)        # closest point overall
    near_val = np.take_along_axis(vals, nearest[None], axis=0)[0]
    cnt = (~miss).sum(axis=0)
    avg = np.where(cnt > 0,
                   np.where(miss, 0.0, vals).sum(axis=0)
                   / np.maximum(cnt, 1), missing)
    near_ok = ~np.take_along_axis(miss, nearest[None], axis=0)[0]
    return np.where(~any_miss, bl, np.where(near_ok, near_val, avg))


def reduced_to_regular(msg):
    """Regrid a reduced lat-lon GRIB message to the regular grid of its
    longest row (grib2wgrid.F90 reduced-grid branch): per-row periodic
    linear interpolation in longitude."""
    pl = np.asarray(msg.pl, np.int64)
    lats = msg.lats
    nx = int(pl.max())
    lon1 = msg.meta["lon1"] / 1000.0
    lons = lon1 + np.arange(nx) * 360.0 / nx
    out = np.empty((len(pl), nx))
    tx = np.arange(nx) / nx
    off = 0
    for j, p in enumerate(pl):
        p = int(p)
        row = msg.values[off:off + p]
        off += p
        x = np.arange(p + 1) / p
        out[j] = np.interp(tx, x, np.concatenate([row, row[:1]]))
    return lats, lons, out


def uv_to_speed_dir(u, v):
    """WAMWND conversion: components → speed + oceanographic direction
    (direction the wind blows TOWARDS, radians) (wamwnd.F90)."""
    wspd = np.hypot(u, v)
    wdir = np.arctan2(u, v) % c.ZPI
    return wspd, wdir


@dataclasses.dataclass
class ForcingFile:
    """Time series of forcing fields on a regular lat-lon grid."""

    times14: np.ndarray        # (nt,) int64
    lats: np.ndarray
    lons: np.ndarray
    fields: dict               # name → (nt, ny, nx)

    @classmethod
    def load(cls, path: str) -> "ForcingFile":
        if path.endswith((".grib", ".grb", ".grib1")):
            return cls.from_grib(path)
        with np.load(path) as z:
            fields = {k: z[k] for k in z.files
                      if k not in ("times", "lats", "lons")}
            return cls(times14=np.asarray(z["times"], np.int64),
                       lats=z["lats"], lons=z["lons"], fields=fields)

    # GRIB1 parameter → forcing field (readwind.F90 ingest set; ECMWF
    # table 128: 165/166 = 10u/10v, 31 = ci, 235 nothing here)
    GRIB_PARAMS = {165: "u10", 166: "v10", 31: "cicover",
                   245: "wspd", 249: "wdir", 93: "cithick"}

    @classmethod
    def from_grib(cls, path: str) -> "ForcingFile":
        """Read forcing from a GRIB1 file on a regular lat-lon grid
        (the READWIND → GRIB2WGRID ingest, via the native codec)."""
        from ecwam_tpu_torch.io import grib as grib_mod
        msgs = grib_mod.read_messages(path)
        series: dict = {}
        lats = lons = None
        for m in msgs:
            name = cls.GRIB_PARAMS.get(m.meta["param"])
            if name is None:
                continue
            if m.meta["ni"] < 0:
                la, lo, vals = reduced_to_regular(m)
            else:
                la, lo, vals = m.lats, m.lons, m.grid_values()
            if lats is None:
                lats, lons = la, lo
            elif len(la) != len(lats) or len(lo) != len(lons):
                raise ValueError("mixed forcing grids in one file")
            t = np.int64(m.date14)
            series.setdefault(name, {})[t] = vals
        if not series:
            raise ValueError(f"no usable forcing fields in {path}")
        times = sorted({t for d in series.values() for t in d})
        ny, nx = len(lats), len(lons)
        fields = {}
        for name, d in series.items():
            arr = np.empty((len(times), ny, nx))
            last = None
            for i, t in enumerate(times):
                last = d.get(t, last if last is not None
                             else next(iter(d.values())))
                arr[i] = last
            fields[name] = arr
        return cls(times14=np.asarray(times, np.int64),
                   lats=lats, lons=lons, fields=fields)

    def save(self, path: str):
        np.savez_compressed(path, times=self.times14, lats=self.lats,
                            lons=self.lons, **self.fields)

    def time_index(self, date14: str) -> int:
        """Latest record at or before date14 (NEWWIND uses the field valid
        for the current wind period)."""
        t = np.int64(date14)
        idx = int(np.searchsorted(self.times14, t, side="right")) - 1
        return max(idx, 0)

    def provider(self, plat, plon):
        """Build a ``provider(date14) -> dict`` for WaveModel (the GETWND
        role): interpolate to the points, convert to model fields."""
        w = bilinear_weights(self.lats, self.lons, plat, plon)
        npts = len(plat)

        def provider(date14: str) -> dict:
            i = self.time_index(date14)
            out = {}
            f = self.fields
            out["aird"] = (interp_field(f["aird"][i], w) if "aird" in f
                           else np.full(npts, c.ROAIR))
            if "ust" in f:
                # ICODE=1: friction-velocity components (wamwnd.F90 CASE 1)
                uu = interp_field(f["ust"][i], w)
                vv = interp_field(f["vst"][i], w)
                us, wdir = uv_to_speed_dir(uu, vv)
                out["ufric"] = np.maximum(us, 1.0e-6)
                out["wswave"] = np.zeros(npts)      # derived by AIRSEA
                out["wdwave"] = wdir
            elif "taux" in f:
                # ICODE=2: surface stress components → u* = √(|τ|/ρ)
                # (wamwnd.F90 CASE 2)
                uu = interp_field(f["taux"][i], w)
                vv = interp_field(f["tauy"][i], w)
                tau, wdir = uv_to_speed_dir(uu, vv)
                us = np.sqrt(np.maximum(tau, 0.0)
                             / np.maximum(out["aird"], 1.0))
                out["ufric"] = np.maximum(us, 1.0e-6)
                out["wswave"] = np.zeros(npts)
                out["wdwave"] = wdir
            elif "u10" in f:
                u = interp_field(f["u10"][i], w)
                v = interp_field(f["v10"][i], w)
                wspd, wdir = uv_to_speed_dir(u, v)
                out["wswave"] = wspd    # WSPMIN floor applied by NEWWIND
                out["wdwave"] = wdir
            else:
                out["wswave"] = interp_field(f["wspd"][i], w)
                out["wdwave"] = np.deg2rad(interp_field(f["wdir"][i], w))
            out["wstar"] = (interp_field(f["wstar"][i], w) if "wstar" in f
                            else np.zeros(npts))
            out["cicover"] = np.clip(
                interp_field(f["cicover"][i], w), 0.0, 1.0) \
                if "cicover" in f else np.zeros(npts)
            if "cithick" in f:
                out["cithick"] = np.maximum(
                    interp_field(f["cithick"][i], w), 0.0)
            if "ucur" in f:
                # time-varying surface currents (getcurr.F90 ingest)
                out["ucur"] = interp_field(f["ucur"][i], w)
                out["vcur"] = interp_field(f["vcur"][i], w)
            return out

        return provider


def synthetic_forcing_file(times14, lats=None, lons=None, *,
                           u10_fn=None) -> ForcingFile:
    """Analytic global wind field for tests/benchmarks: a zonally-banded
    westerly/trade pattern unless ``u10_fn(lat2d, lon2d, it)`` is given."""
    lats = np.arange(-87.5, 88.0, 5.0) if lats is None else lats
    lons = np.arange(0.0, 360.0, 5.0) if lons is None else lons
    la, lo = np.meshgrid(lats, lons, indexing="ij")
    nt = len(times14)
    u10 = np.empty((nt, len(lats), len(lons)))
    v10 = np.empty_like(u10)
    for it in range(nt):
        if u10_fn is not None:
            u10[it], v10[it] = u10_fn(la, lo, it)
        else:
            u10[it] = 8.0 * np.sin(np.deg2rad(3.0 * la)) \
                + 2.0 * np.cos(np.deg2rad(lo + 10.0 * it))
            v10[it] = 3.0 * np.sin(np.deg2rad(2.0 * lo) + 0.3 * it)
    return ForcingFile(
        times14=np.asarray(times14, np.int64), lats=lats, lons=lons,
        fields=dict(u10=u10, v10=v10))
