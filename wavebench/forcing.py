"""The forcing of a run, made from ``--seed``: one wind field each forcing
period and, where the configuration has them, surface currents that
change with it and polar sea ice.

Every seed gives the same kind of field at the same sizes (winds between
the configuration's two speeds, currents of the same strength); the seed
and the hour set only their phases, so the work of a step does not move
with the seed.  The grid's sea points and their latitudes and longitudes
come from the reference's own grid, not from the program.
"""

from __future__ import annotations

import datetime as _dt

import numpy as np

from wavebench.reference.ecw.core import grid as grid_mod

START = _dt.datetime(2023, 1, 1)
# distinct forcing periods made in set-up, taken in turn
POOL = 6
DATE_FMT = "%Y%m%d%H%M%S"


def point_latlon(build_kw: dict):
    """(lat, lon) in degrees of each sea point of the configuration's
    grid, in the order the model numbers them."""
    name = build_kw["grid_name"]
    grid = (grid_mod.octahedral_grid(int(name[1:])) if name.startswith("O")
            else grid_mod.regular_grid(float(name)))
    blk = grid_mod.build_sea_point_block(grid, grid_mod.aqua_bathymetry(grid))
    lat = grid.lats[blk.kxlt]
    lon = grid.amowep + blk.ixlg * grid.zdello[blk.kxlt]
    return np.asarray(lat, np.float64), np.asarray(lon, np.float64)


class Forcing:
    """``provider(date14) -> dict`` of (n,) host arrays, the model's
    forcing provider.  The fields of :data:`POOL` periods are made once,
    in set-up, and period ``h`` takes ``h % POOL``'s: each period brings
    a new field, and the window times the model's NEWWIND, not the
    making of the fields.  ``spec`` is the configuration's ``forcing`` block:
    ``wind_speed`` [lo, hi] m/s; ``currents`` None or a jet-and-eddies
    block (``jet``, ``eddy`` m/s, ``jet_width`` degrees, ``wave``
    number, ``vary`` the hourly relative change); ``ice`` None or
    ``lat0``, ``width`` degrees and ``thick`` m.  ``period_s`` is the
    forcing period: the fields change at its multiples from
    :data:`START`."""

    def __init__(self, spec: dict, lat, lon, seed: int, period_s: float):
        self.spec, self.seed, self.period_s = spec, int(seed), period_s
        self.phi, self.lam = np.radians(lat), np.radians(lon)
        self.lat = lat
        n = lat.shape[0]
        self.const = dict(aird=np.full(n, 1.225), wstar=np.zeros(n))
        ice = spec.get("ice")
        ci = (np.clip((np.abs(lat) - ice["lat0"]) / ice["width"], 0.0, 1.0)
              if ice else np.zeros(n))
        self.const["cicover"] = ci
        if ice:
            self.const["cithick"] = ice["thick"] * ci
        self.pool = [self._make(h) for h in range(POOL)]

    def period(self, date14: str) -> int:
        """The index of the forcing period ``date14`` lies in."""
        dt = _dt.datetime.strptime(date14, DATE_FMT) - START
        return int(dt.total_seconds() // self.period_s)

    def _rng(self, h: int):
        # the seed may exceed 32 bits: numpy takes any non-negative int
        return np.random.default_rng([abs(self.seed), h, 15])

    def fields(self, h: int) -> dict:
        """The forcing of period ``h``."""
        return self.pool[h % POOL]

    def _make(self, h: int) -> dict:
        rng = self._rng(h)
        lo, hi = self.spec["wind_speed"]
        k, m = rng.integers(2, 6), rng.integers(1, 4)
        p1, p2, p3, d0 = rng.uniform(0.0, 2.0 * np.pi, 4)
        shape = np.sin(k * self.lam + p1) * np.cos(m * self.phi + p2)
        out = dict(self.const)
        out["wswave"] = lo + (hi - lo) * 0.5 * (1.0 + shape)
        out["wdwave"] = np.mod(d0 + 0.6 * np.sin(self.lam + p3)
                               * np.cos(self.phi), 2.0 * np.pi)
        cur = self.spec.get("currents")
        if cur:
            a, b = 1.0 + cur["vary"] * rng.uniform(-1.0, 1.0, 2)
            p = cur["vary"] * rng.uniform(-np.pi, np.pi)
            w = cur["wave"]
            out["ucur"] = (a * cur["jet"] * np.exp(
                -(self.lat / cur["jet_width"]) ** 2)
                - b * cur["eddy"] * np.cos(w * self.lam + p)
                * np.sin(2.0 * self.phi))
            out["vcur"] = (b * cur["eddy"] * np.sin(w * self.lam + p)
                           * np.cos(self.phi))
        return out

    def currents0(self):
        """The currents the model is built with (period 0), or None."""
        if not self.spec.get("currents"):
            return None
        f = self.fields(0)
        return f["ucur"], f["vcur"]

    def provider(self, date14: str) -> dict:
        return self.fields(self.period(date14))
