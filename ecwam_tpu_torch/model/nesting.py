"""Boundary nesting: coarse→fine one-way spectral boundary conditions.

Port of ``ecwam_tpu/model/nesting.py`` (the MBOUNC, OUTBC/HEADBC, bouint,
MBOUNF and BOUINPT roles; INTSPEC, K. Hasselmann 1990: intspec.F90,
rotspec.F90, strspec.F90).

Where the work runs:

  * the boundary tables (:func:`coarse_boundary`, :func:`fine_boundary`)
    are built once on the host in numpy, as in the reference;
  * the spectra live on the model's device in float64: the gathers,
    rotations, stretches and blends of INTSPEC, the coarse writer's mean
    parameters and the boundary file's records (float32, as stored);
  * the per-point parameters of INTSPEC — the (nb,) means, weights and
    angles and the (nb, nfre) bin indices and fractions that ROTSPEC and
    STRSPEC derive from them — are float64 numpy on the host, computed
    by the reference's own expressions.  The bin indices are truncations
    of ``log10`` ratios and angles: a last-bit difference between the
    device's and numpy's ``log10`` would move a bin where the value sits
    on an integer (an exact power of the frequency ratio), so they are
    taken where the reference takes them.  A tensor passed for one of
    these parameters is copied to the host.

The fine model's rim is written in place through the model's
``put_points`` (the SRL rows and tail of ``FastWaveModel``, the compact
field of ``WaveModel``), and the coarse writer takes only the boundary
points (``take_points``): no whole-field copy on either side.
:func:`apply_boundary` keeps the reference's compact form.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ecwam_tpu_torch.core import constants as c
from ecwam_tpu_torch.core import spectral as sp
from ecwam_tpu_torch.device import resolve
from ecwam_tpu_torch.model.driver import parse_date

ZPI = 2.0 * np.pi


def _f64(f, device=None) -> torch.Tensor:
    """Spectra as a float64 tensor (on ``device``, else where they are)."""
    return torch.as_tensor(f, dtype=torch.float64, device=device)


def _host(a) -> np.ndarray:
    """A per-point parameter as float64 numpy on the host."""
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu", torch.float64).numpy()
    return np.asarray(a, np.float64)


def _on(a, f: torch.Tensor) -> torch.Tensor:
    """Host values ``a`` as a tensor on ``f``'s device: bool masks, int64
    indices or float64."""
    a = np.asarray(a)
    dt = {"b": torch.bool, "i": torch.int64,
          "u": torch.int64}.get(a.dtype.kind, torch.float64)
    return torch.as_tensor(a, dtype=dt).to(f.device)


# ---------------------------------------------------------------------------
# spectral interpolation primitives (vectorized over leading batch dim)
# ---------------------------------------------------------------------------

def rotspec(f, rthet):
    """Rotate spectra by ``rthet`` (rotspec.F90:70-88).

    ``f``: (nb, nang, nfre) tensor (or numpy) on any device; ``rthet``:
    (nb,) radians.  Linear interpolation between the two neighbouring
    direction bins; the bins and weights come from the host."""
    f = _f64(f)
    nb, nang, nfre = f.shape
    fth = np.mod(_host(rthet) + ZPI, ZPI) * nang / ZPI
    inc = fth.astype(np.int64)                      # 0 <= inc < nang
    adif = _on(fth - inc, f)[:, None, None]
    k = np.arange(nang)[None, :]
    kc = (k - inc[:, None]) % nang                  # (nb, nang)
    kc1 = (kc - 1) % nang
    shape = (nb, nang, nfre)
    return ((1.0 - adif) * torch.gather(f, 1, _on(kc, f)[:, :, None]
                                        .expand(shape))
            + adif * torch.gather(f, 1, _on(kc1, f)[:, :, None]
                                  .expand(shape)))


def strspec(f, gamma, fr, fratio=None):
    """Stretch spectra in frequency by ``gamma`` (strspec.F90:70-180).

    The logarithmic frequency grid fr[m] = fr[0]·ratio^m means a
    stretch is a (fractional) shift of the frequency index: shift by
    ``int(log(γ)/log(ratio))`` whole bins, plus linear interpolation
    between neighbouring bins for the fractional part; energy moving
    past either end is dropped (zero inflow).  ``fratio`` defaults to
    the reference's literal 1.1 (strspec.F90 notes it "should actually
    be FRATIO" — they coincide for the operational grid).  The indices
    and fractions are the reference's, on the host; the gathers and
    blends run on ``f``'s device.
    """
    f = _f64(f)
    nb, nang, nfre = f.shape
    fr = np.asarray(fr, np.float64)[:nfre]
    ratio = 1.1 if fratio is None else float(fratio)
    alo = np.log10(ratio)
    gams = _host(gamma)

    inc = (np.log10(np.maximum(gams, 1e-30)) / alo).astype(np.int64)
    exact = np.abs(ratio ** inc.astype(np.float64) - gams) <= 0.001
    m = np.arange(nfre)[None, :]

    # general case: target bin m draws from the source frequency
    # fr[m]·γ placed on the log grid (strspec.F90:140-165)
    ar2 = fr[None, :] * gams[:, None]               # (nb, nfre)
    ifr = (np.log10(np.maximum(ar2 / fr[0], 1e-30)) / alo).astype(np.int64)
    # reference's MC source index: m+inc (γ>1) or m+inc-1 (γ<1)
    mc = np.where(gams[:, None] > 1.0, m + inc[:, None],
                  m + inc[:, None] - 1)
    ifr_c = np.clip(ifr, 0, nfre - 2)
    adif = (fr[ifr_c + 1] - ar2) / (fr[ifr_c + 1] - fr[ifr_c])
    adif = np.clip(adif, 0.0, 1.0)
    mc_ok = (mc >= 0) & (mc + 1 <= nfre - 1)
    mc_c = np.clip(mc, 0, nfre - 2)
    # valid target range per reference loop bounds
    lo = np.where(gams[:, None] > 1.0, 0, 1 - inc[:, None])
    hi = np.where(gams[:, None] > 1.0, nfre - inc[:, None] - 1, nfre)
    keep = mc_ok & (m >= lo) & (m < hi)

    # exact power-of-ratio: pure shift (strspec.F90:100-135)
    msrc = m + inc[:, None]
    src_ok = (msrc >= 0) & (msrc <= nfre - 1)
    msrc_c = np.clip(msrc, 0, nfre - 1)

    shape = (nb, nang, nfre)

    def take(idx):
        return torch.gather(f, 2, _on(idx, f)[:, None, :].expand(shape))
    a = _on(adif, f)[:, None, :]
    zero = f.new_zeros(())
    gen = a * take(mc_c) + (1.0 - a) * take(mc_c + 1)
    gen = torch.where(_on(keep, f)[:, None, :], gen, zero)
    shf = torch.where(_on(src_ok, f)[:, None, :], take(msrc_c), zero)
    out = torch.where(_on(exact, f)[:, None, None], shf, gen)
    return torch.where(_on(np.abs(gams - 1.0) < 1e-12, f)[:, None, None],
                       f, out)


def mean_params(f, tb):
    """Batch EM/FM (femean.F90) and mean direction θq (sthq.F90) of
    (nb, nang, nfre) spectra, as float64 tensors on their device."""
    f = _f64(f)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=f.device)
    temp = torch.clamp(f, min=c.EPSMIN).sum(dim=1)   # (nb, nfre)
    em = (t(tb.dfim)[None, :] * temp).sum(dim=1)
    fm = (t(tb.dfimofr)[None, :] * temp).sum(dim=1)
    delt25 = sp.WETAIL * tb.fr[tb.nfre - 1] * tb.delth
    delt2 = sp.FRTAIL * tb.delth
    em = em + delt25 * temp[:, -1]
    fm = fm + delt2 * temp[:, -1]
    fm = torch.clamp(em / fm, min=float(tb.fr[0]))
    fa = f.sum(dim=2)
    sidir = (fa * t(np.sin(tb.th))[None, :]).sum(dim=1)
    cidir = (fa * t(np.cos(tb.th))[None, :]).sum(dim=1)
    cidir = torch.where(cidir == 0.0, torch.full_like(cidir, c.EPSMIN),
                        cidir)
    thq = torch.remainder(torch.atan2(sidir, cidir) + ZPI, ZPI)
    return em, fm, thq


def intspec(f1, f2, w2, tb, means1=None, means2=None, fratio=None):
    """INTSPEC (intspec.F90:110-230): interpolate spectra pairs.

    ``w2`` = DEL1L/DEL12 ∈ [0,1] is the weight of spectrum 2; returns
    (fl, em, fm, thq): ``fl`` a float64 tensor on ``f1``'s device, the
    means float64 numpy.  Vectorized over the (nb,) batch; means not
    given are computed from the spectra (:func:`mean_params`).
    """
    f1 = _f64(f1)
    f2 = _f64(f2, f1.device)
    gw2 = _host(w2)
    gw1 = 1.0 - gw2
    em1, fm1, th1 = (_host(a) for a in (means1 if means1 is not None
                                        else mean_params(f1, tb)))
    em2, fm2, th2 = (_host(a) for a in (means2 if means2 is not None
                                        else mean_params(f2, tb)))

    em = gw1 * em1 + gw2 * em2
    fm = gw1 * fm1 + gw2 * fm2
    cm = gw1 * np.cos(th1) + gw2 * np.cos(th2)
    sm = gw1 * np.sin(th1) + gw2 * np.sin(th2)
    thq = np.mod(np.arctan2(sm, cm) + ZPI, ZPI)

    safe1 = np.maximum(em1, 1e-300)
    safe2 = np.maximum(em2, 1e-300)
    f3 = strspec(rotspec(f1, thq - th1), fm1 / fm, tb.fr, fratio) \
        * _on(em / safe1, f1)[:, None, None]
    f4 = strspec(rotspec(f2, thq - th2), fm2 / fm, tb.fr, fratio) \
        * _on(em / safe2, f1)[:, None, None]
    g1 = _on(gw1, f1)[:, None, None]
    g2 = _on(gw2, f1)[:, None, None]
    fl = g1 * f3 + g2 * f4

    # zero-energy special cases (intspec.F90:120-160)
    z1 = _on(em1 == 0.0, f1)[:, None, None]
    z2 = _on(em2 == 0.0, f1)[:, None, None]
    fl = torch.where(z1, g2 * f2, fl)
    fl = torch.where(z2 & ~z1, g1 * f1, fl)
    em = np.where(em1 == 0.0, gw2 * em2, np.where(em2 == 0.0, gw1 * em1,
                                                  em))
    fm = np.where(em1 == 0.0, fm2, np.where(em2 == 0.0, fm1, fm))
    thq = np.where(em1 == 0.0, th2, np.where(em2 == 0.0, th1, thq))
    return fl, em, fm, thq


# ---------------------------------------------------------------------------
# boundary-point tables (MBOUNC / MBOUNF roles), host numpy
# ---------------------------------------------------------------------------

def _point_coords(grid, blk):
    lat = np.asarray(grid.lats)[np.asarray(blk.kxlt)]
    lon = np.asarray(grid.amowep) + np.asarray(blk.ixlg) * \
        np.asarray(grid.zdello)[np.asarray(blk.kxlt)]
    return lat, lon


def _perimeter_coord(lat, lon, south, north, west, east):
    """Arclength-like coordinate along the rectangle perimeter (deg),
    anchored at the SW corner, running W→E on the south edge, S→N on
    the east edge, E→W north, N→S west (mbounc.F90 ordering)."""
    w, e, s, n = west, east, south, north
    dx, dy = e - w, n - s
    d_s = np.abs(lat - s)
    d_e = np.abs(lon - e)
    d_n = np.abs(lat - n)
    d_w = np.abs(lon - w)
    edge = np.argmin(np.stack([d_s, d_e, d_n, d_w]), axis=0)
    t = np.where(edge == 0, lon - w,
        np.where(edge == 1, dx + (lat - s),
        np.where(edge == 2, dx + dy + (e - lon),
                 2 * dx + dy + (n - lat))))
    return t, edge


@dataclasses.dataclass(frozen=True)
class CoarseBoundary:
    """MBOUNC tables: coarse sea points on the fine domain's rim."""

    idx: np.ndarray          # (nb,) coarse sea-point indices, ordered
    lat: np.ndarray
    lon: np.ndarray
    s: np.ndarray            # perimeter coordinate (deg)
    rect: tuple              # (south, north, west, east)


def coarse_boundary(grid, blk, south, north, west, east,
                    tol=None) -> CoarseBoundary:
    """Coarse-grid sea points within ``tol`` of the fine-domain rim
    (default: one coarse cell), ordered along the perimeter."""
    lat, lon = _point_coords(grid, blk)
    # per-point tolerances: latitudes are xdella-spaced, longitudes
    # zdello(row)-spaced (reduced grids reach zdello=180 deg at the
    # poles, so a single global tolerance would select everything)
    tlat = float(grid.xdella) * 0.51 if tol is None else tol
    tlon = (np.maximum(np.asarray(grid.zdello)[np.asarray(blk.kxlt)],
                       grid.xdella) * 0.51 if tol is None else tol)
    on_ew = (np.abs(lat - south) <= tlat) | (np.abs(lat - north) <= tlat)
    on_ns = (np.abs(lon - west) <= tlon) | (np.abs(lon - east) <= tlon)
    inside = (lat >= south - tlat) & (lat <= north + tlat) & \
             (lon >= west - tlon) & (lon <= east + tlon)
    sel = np.where(inside & (on_ew | on_ns))[0]
    if sel.size == 0:
        raise ValueError("no coarse boundary points on the fine rim "
                         f"[{south},{north}]x[{west},{east}]")
    t, _ = _perimeter_coord(lat[sel], lon[sel], south, north, west, east)
    order = np.argsort(t)
    sel, t = sel[order], t[order]
    return CoarseBoundary(idx=sel.astype(np.int32), lat=lat[sel],
                          lon=lon[sel], s=t,
                          rect=(south, north, west, east))


@dataclasses.dataclass(frozen=True)
class FineBoundary:
    """MBOUNF tables: fine rim points + their coarse bracket/weights."""

    idx: np.ndarray          # (nf,) fine sea-point indices
    ibfl: np.ndarray         # (nf,) left coarse boundary slot
    ibfr: np.ndarray         # (nf,) right coarse boundary slot
    bfw: np.ndarray          # (nf,) weight of the RIGHT neighbour


def fine_boundary(grid, blk, cb: CoarseBoundary) -> FineBoundary:
    """Fine-grid sea points on the fine domain's own rim, each between
    two coarse boundary points along the perimeter (mbounf.F90)."""
    lat, lon = _point_coords(grid, blk)
    tlat = float(grid.xdella) * 0.51
    tlon = np.maximum(np.asarray(grid.zdello)[np.asarray(blk.kxlt)],
                      grid.xdella) * 0.51
    south, north, west, east = cb.rect
    rim = (np.abs(lat - south) <= tlat) | \
          (np.abs(lat - north) <= tlat) | \
          (np.abs(lon - west) <= tlon) | (np.abs(lon - east) <= tlon)
    inside = (lat >= south - tlat) & (lat <= north + tlat) & \
             (lon >= west - tlon) & (lon <= east + tlon)
    sel = np.where(rim & inside)[0]
    t, _ = _perimeter_coord(lat[sel], lon[sel], south, north, west, east)
    # bracket along the (periodic) perimeter
    right = np.searchsorted(cb.s, t)
    nbc = cb.s.size
    perim = 2 * ((north - south) + (east - west))
    left = (right - 1) % nbc
    rightw = right % nbc
    sl = cb.s[left] + np.where(right == 0, -perim, 0.0)
    sr = cb.s[rightw] + np.where(right >= nbc, perim, 0.0)
    span = np.maximum(sr - sl, 1e-12)
    w = np.clip((t - sl) / span, 0.0, 1.0)
    return FineBoundary(idx=sel.astype(np.int32),
                        ibfl=left.astype(np.int32),
                        ibfr=rightw.astype(np.int32),
                        bfw=w)


# ---------------------------------------------------------------------------
# boundary file (OUTBC / HEADBC / bouint / BOUINPT roles)
# ---------------------------------------------------------------------------

class BoundaryWriter:
    """OUTBC role: collect per-date coarse boundary records, write one
    file (npz container; header = HEADBC fields).  The records stay on
    the device of the spectra given until :meth:`save`."""

    def __init__(self, cb: CoarseBoundary, tb):
        self.cb = cb
        self.tb = tb
        self.dates: list = []
        self.recs: list = []

    def add(self, date14: str, spec) -> None:
        """``spec``: the boundary points' spectra (nang, nfre, nb), in
        the order of ``cb.idx`` (a tensor on any device, or numpy)."""
        f = _f64(spec).permute(2, 0, 1)             # (nb, nang, nfre)
        em, fm, thq = mean_params(f, self.tb)
        self.recs.append((f.to(torch.float32), em, fm, thq))
        self.dates.append(int(date14))

    def save(self, path: str) -> None:
        def stack(i):
            return np.stack([r[i].cpu().numpy() for r in self.recs])
        np.savez_compressed(
            path,
            dates=np.asarray(self.dates, np.int64),
            lat=self.cb.lat, lon=self.cb.lon, s=self.cb.s,
            rect=np.asarray(self.cb.rect),
            fr=np.asarray(self.tb.fr)[: self.tb.nfre],
            th=np.asarray(self.tb.th),
            spec=stack(0), em=stack(1), fm=stack(2), thq=stack(3))


class BoundaryFile:
    """Reader + time interpolation (bouint role).  The float32 spectral
    records live on ``device`` (the card unless the caller asks for the
    CPU); the dates and means stay on the host."""

    def __init__(self, path: str, tb, device=None):
        z = np.load(path)
        self.device = resolve(device)
        self.dates = z["dates"]
        self.spec = torch.as_tensor(z["spec"], device=self.device)
        self.em, self.fm, self.thq = z["em"], z["fm"], z["thq"]
        self.lat, self.lon, self.s = z["lat"], z["lon"], z["s"]
        self.rect = tuple(z["rect"])
        self.fr_in = z["fr"]
        self.tb = tb
        if self.fr_in.shape[0] != tb.nfre or not np.allclose(
                self.fr_in, np.asarray(tb.fr)[: tb.nfre], rtol=1e-6):
            raise ValueError(
                "boundary file frequency grid mismatch (bouinpt.F90 "
                "header consistency check)")

    def coarse_boundary(self) -> CoarseBoundary:
        s, n, w, e = self.rect
        return CoarseBoundary(
            idx=np.arange(self.lat.size, dtype=np.int32),
            lat=self.lat, lon=self.lon, s=self.s, rect=(s, n, w, e))

    def at(self, date14: str):
        """Time-interpolated record (bouint.F90:19-23: INTSPEC with the
        time offsets as distances): (spectra (nb, nang, nfre) float64 on
        the device, (em, fm, thq) float64 numpy)."""
        t = int(date14)
        i = int(np.searchsorted(self.dates, t))
        if (i == 0 or i >= len(self.dates)
                or (i < len(self.dates) and self.dates[i] == t)):
            j = min(i, len(self.dates) - 1)
            return (self.spec[j].to(torch.float64),
                    (self.em[j], self.fm[j], self.thq[j]))
        d0 = parse_date(str(self.dates[i - 1]))
        d12 = (parse_date(str(self.dates[i])) - d0).total_seconds()
        d1l = (parse_date(str(date14).ljust(14, "0"))
               - d0).total_seconds()
        w2 = np.full(self.lat.size, d1l / d12)
        fl, em, fm, thq = intspec(
            self.spec[i - 1], self.spec[i], w2, self.tb,
            means1=(self.em[i - 1], self.fm[i - 1], self.thq[i - 1]),
            means2=(self.em[i], self.fm[i], self.thq[i]))
        return fl, (em, fm, thq)


def boundary_spectra(bf: BoundaryFile, fb: FineBoundary, date14: str):
    """BOUINPT's space/time-interpolated coarse spectra at the fine rim
    points ``fb.idx``: (nang, nfre, nf) float64 on the file's device."""
    spec_t, means_t = bf.at(date14)
    il = _on(fb.ibfl.astype(np.int64), spec_t)
    ir = _on(fb.ibfr.astype(np.int64), spec_t)
    m1 = tuple(a[fb.ibfl] for a in means_t)
    m2 = tuple(a[fb.ibfr] for a in means_t)
    fl, _, _, _ = intspec(spec_t[il], spec_t[ir], fb.bfw, bf.tb,
                          means1=m1, means2=m2)
    return fl.permute(1, 2, 0)


def apply_boundary(fl1, bf: BoundaryFile, fb: FineBoundary, date14: str):
    """BOUINPT role on a compact field: overwrite the fine rim points of
    ``fl1`` ((nang, nfre, npts)) with the space/time-interpolated coarse
    boundary spectra.  A tensor is written in place (an indexed store)
    and returned; numpy is copied, as in the reference."""
    vals = boundary_spectra(bf, fb, date14)
    if isinstance(fl1, np.ndarray):
        out = fl1.copy()
        out[..., fb.idx] = vals.cpu().numpy()
        return out
    idx = torch.as_tensor(fb.idx.astype(np.int64), device=fl1.device)
    fl1[..., idx] = vals.to(fl1.device, fl1.dtype)
    return fl1
