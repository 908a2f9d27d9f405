"""Data-assimilation surface: the WAMASSI callback registry + an OI
reference implementation.

Port of ``ecwam_tpu/model/assimilation.py``.  The reference distributes
only procedure-pointer stubs (yowassi.F90:20-60: "data assimilation can be
added via an external library ... A setup routine needs to point the
HANDLERs to the correct implementation"; the real ECMWF OI is not
distributed, wavemdl.F90:602-605).  This module provides the same
pluggable surface — :func:`register_wamassi` / :func:`wamassi`
abort-if-unset semantics — plus a working default analysis in the classic
WAM spirit:

  * :func:`oi_swh_analysis` — optimum interpolation of significant
    wave height: model first-guess SWH at sea points, point
    observations with Gaussian structure functions and observation-
    error weighting (Lionello, Günther & Janssen 1992 §3);
  * :func:`update_spectra_from_swh` — the spectra update for an
    SWH-only analysis: F ← F · (Hs_an/Hs_fg)² per point (energy scales
    with Hs²; wind-sea/swell repartitioning needs the wind analysis,
    which is out of distribution in the reference too).

The analysis runs in float64 on the device of the first guess: the
(npts × nobs) distance and gain matrices are formed a chunk of points at
a time (at O320 with 2,000 observations the whole matrix would take
6.7 GB), and :func:`default_wamassi` scales the model's spectra in place
(``FastWaveModel``'s SRL rows and tail, ``WaveModel``'s compact field).
"""

from __future__ import annotations

import numpy as np
import torch

from ecwam_tpu_torch.device import resolve
from ecwam_tpu_torch.io import products as products_mod
from ecwam_tpu_torch.model.driver import FastWaveModel

_HANDLER = None
R_EARTH_KM = 6371.0
CHUNK = 16384           # points per block of the (points × obs) matrices


def register_wamassi(fn) -> None:
    """Point the WAMASSI handler at an implementation
    (yowassi.F90:24 WAMASSI_HANDLER)."""
    global _HANDLER
    _HANDLER = fn


def wamassi(*args, **kwargs):
    """Dispatch to the registered handler; abort when none is set —
    the reference's WAM_ABORT('data assimilation not available')."""
    if _HANDLER is None:
        raise RuntimeError(
            "WAMASSI: no data-assimilation handler registered "
            "(yowassi.F90 stubs abort identically); call "
            "register_wamassi(...) or use oi_swh_analysis")
    return _HANDLER(*args, **kwargs)


def great_circle_dist(lat1, lon1, lat2, lon2):
    """Great-circle distance (radians of arc) between degree coords
    (float64 tensors, broadcast)."""
    rad = np.pi / 180.0
    p1, p2 = lat1 * rad, lat2 * rad
    dl = (lon1 - lon2) * rad
    c = (torch.sin(p1) * torch.sin(p2)
         + torch.cos(p1) * torch.cos(p2) * torch.cos(dl))
    return torch.arccos(torch.clamp(c, -1.0, 1.0))


def _f64(a, device) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float64, device=device)


def _device(hs_fg, device):
    return hs_fg.device if isinstance(hs_fg, torch.Tensor) and \
        device is None else resolve(device)


def oi_weights(hs_fg, lat, lon, obs_lat, obs_lon, obs_hs, *,
               corr_km: float = 300.0, obs_err: float = 0.15,
               bg_err: float = 0.25, chunk: int = CHUNK, device=None):
    """The OI's observation weights w (nobs,): (B_oo + R) w = innovation,
    the innovation taken at each observation's nearest sea point (the
    first of equals, as ``np.argmin``), found a chunk of points at a
    time.  Returns (w, innovation), float64 on the first guess's device
    (a tensor's own, else ``device``, the card by default)."""
    dev = _device(hs_fg, device)
    hs_fg, lat, lon = (_f64(a, dev) for a in (hs_fg, lat, lon))
    olat, olon, ohs = (_f64(a, dev) for a in (obs_lat, obs_lon, obs_hs))
    nobs = ohs.shape[0]
    best = torch.full((nobs,), float("inf"), dtype=torch.float64,
                      device=dev)
    nearest = torch.zeros(nobs, dtype=torch.int64, device=dev)
    for s in range(0, lat.shape[0], chunk):
        d = great_circle_dist(olat[:, None], olon[:, None],
                              lat[None, s:s + chunk], lon[None, s:s + chunk])
        dmin, arg = torch.min(d * R_EARTH_KM, dim=1)
        closer = dmin < best
        best = torch.where(closer, dmin, best)
        nearest = torch.where(closer, arg + s, nearest)
    innov = ohs - hs_fg[nearest]
    d_oo = great_circle_dist(olat[:, None], olon[:, None],
                             olat[None, :], olon[None, :]) * R_EARTH_KM
    s2 = (bg_err / max(obs_err, 1e-9)) ** 2
    a = torch.exp(-(d_oo / corr_km) ** 2) + torch.eye(
        nobs, dtype=torch.float64, device=dev) / max(s2, 1e-9)
    return torch.linalg.solve(a, innov), innov


def oi_gain(hs_fg, lat, lon, obs_lat, obs_lon, w, *, corr_km: float = 300.0,
            max_obs: int = 20, chunk: int = CHUNK, device=None):
    """The analysis hs_fg + gain·w at each point, the gain being the
    Gaussian structure functions to the ``max_obs`` nearest observations
    (all of them tied at the cut), a chunk of points at a time; floored
    at 0.  Float64 on the first guess's device."""
    dev = _device(hs_fg, device)
    hs_fg, lat, lon, w = (_f64(a, dev) for a in (hs_fg, lat, lon, w))
    olat, olon = (_f64(a, dev) for a in (obs_lat, obs_lon))
    nobs = w.shape[0]
    out = torch.empty_like(hs_fg)
    for s in range(0, lat.shape[0], chunk):
        d = great_circle_dist(olat[None, :], olon[None, :],
                              lat[s:s + chunk, None],
                              lon[s:s + chunk, None]) * R_EARTH_KM
        gain = torch.exp(-(d / corr_km) ** 2)
        if nobs > max_obs:
            cut = torch.kthvalue(d, max_obs, dim=1).values
            gain = torch.where(d <= cut[:, None], gain,
                               torch.zeros((), dtype=gain.dtype,
                                           device=dev))
        out[s:s + chunk] = hs_fg[s:s + chunk] + gain @ w
    return torch.clamp(out, min=0.0)


def oi_swh_analysis(hs_fg, lat, lon, obs_lat, obs_lon, obs_hs, *,
                    corr_km: float = 300.0, obs_err: float = 0.15,
                    bg_err: float = 0.25, max_obs: int = 20,
                    chunk: int = CHUNK, device=None):
    """Optimum interpolation of SWH point observations.

    ``hs_fg``/(lat, lon): first-guess SWH at the (npts,) sea points;
    ``obs_*``: (nobs,) observations.  Gaussian structure function
    exp(-(r/L)²) with correlation length ``corr_km``; per-point
    analysis uses the ``max_obs`` nearest observations (the reference
    OI uses a fixed selection box).  Returns the analysed (npts,) SWH,
    float64 on the first guess's device (a tensor's own, else
    ``device``, the card by default)."""
    dev = _device(hs_fg, device)
    if len(obs_hs) == 0:
        return _f64(hs_fg, dev).clone()
    w, _ = oi_weights(hs_fg, lat, lon, obs_lat, obs_lon, obs_hs,
                      corr_km=corr_km, obs_err=obs_err, bg_err=bg_err,
                      chunk=chunk, device=dev)
    return oi_gain(hs_fg, lat, lon, obs_lat, obs_lon, w, corr_km=corr_km,
                   max_obs=max_obs, chunk=chunk, device=dev)


def swh_scale(hs_fg, hs_an, floor: float = 1e-3) -> torch.Tensor:
    """The energy factor (Hs_an / max(Hs_fg, floor))², float64."""
    hs_an = torch.as_tensor(hs_an)
    ratio = hs_an.double() / torch.clamp(
        torch.as_tensor(hs_fg, device=hs_an.device).double(), min=floor)
    return ratio ** 2


def update_spectra_from_swh(fl1, hs_fg, hs_an, floor: float = 1e-3):
    """Rescale spectra (nang, nfre, npts) for an SWH-only analysis:
    energy ∝ Hs².  A tensor gives a new tensor of its dtype (the factor
    cast to it); numpy gives float64 numpy, as the reference."""
    if isinstance(fl1, np.ndarray):
        return fl1 * swh_scale(hs_fg, hs_an, floor).numpy()[None, None, :]
    return fl1 * swh_scale(hs_fg, hs_an, floor).to(
        fl1.device, fl1.dtype)[None, None, :]


def first_guess_swh(model) -> torch.Tensor:
    """The model's SWH (n_pad,) in its dtype on its device; on
    ``FastWaveModel`` a chunk of points at a time from the SRL rows."""
    tb, n = model.setup.tb, model.setup.n_pad
    if isinstance(model, FastWaveModel):
        return torch.cat([products_mod.swh(model.fl1_chunk(s, CHUNK), tb)
                          for s in range(0, n, CHUNK)])
    return products_mod.swh(model.fl1, tb)


def scale_spectra(model, scale) -> None:
    """Multiply the model's spectra in place by ``scale`` (n_pad,), one
    factor a point, cast to the model's dtype: the dense model's compact
    field, or ``FastWaveModel``'s SRL rows and tail, every row through
    ``srl_src`` (wrap duplicates included; the pad row by 1)."""
    ms = model.setup
    if isinstance(model, FastWaveModel):
        rows = torch.cat([scale, scale.new_ones(1)])[
            model.fp.tabs["srl_src"]].to(ms.dtype)[:, None]
        model._f_srl.mul_(rows)
        if model._tail is not None:
            model._tail.mul_(rows)
    else:
        model.fl1.mul_(scale.to(ms.dtype)[None, None, :])


def default_wamassi(model, obs: dict):
    """A complete WAMASSI: analyse SWH and update the model spectra.

    ``model``: the driver's ``WaveModel`` or ``FastWaveModel``; ``obs``:
    dict with lat/lon/swh arrays.  The spectra are scaled in place
    (:func:`scale_spectra`) by each point's energy factor, pad points by
    1 (the reference pads the analysis with the last first guess).
    Registered as the default handler so `wamassi(...)` works out of the
    box while staying replaceable.  Returns the analysed (n_real,) SWH,
    float64 on the model's device.
    """
    ms = model.setup
    hs_fg = first_guess_swh(model)[: ms.n_real]
    lat = np.asarray(ms.grid.lats)[ms.blk.kxlt]
    lon = ms.grid.amowep + ms.blk.ixlg * \
        np.asarray(ms.grid.zdello)[ms.blk.kxlt]
    hs_an = oi_swh_analysis(hs_fg, lat, lon, obs["lat"], obs["lon"],
                            obs["swh"])
    rep = hs_fg[-1:].repeat(ms.n_pad - ms.n_real)
    scale_spectra(model, swh_scale(torch.cat([hs_fg, rep]),
                                   torch.cat([hs_an, rep.double()])))
    return hs_an


register_wamassi(default_wamassi)
