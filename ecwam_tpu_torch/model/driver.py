"""Time-integration driver on SRL-resident state (the RUNWAM/WAMODEL role).

Port of ``ecwam_tpu/model/driver.py: FastWaveModel`` — the production
stepping mode: the spectrum stays in the segmented row layout between
steps, each ``idelpro`` runs the CTU advection (kernel A) and each
``idelt`` the IMPLSCH physics (kernel B): minimal mode between output
dates, and at output dates (``advance(..., full_phys=True)``) full mode
chunked over rows with the windsea/swell separation, which fills
``state`` (wamodel.F90:228-649, wamintgr.F90:94-186).  Dates are
14-character strings (incdate.F90) kept as ``datetime``.  Surface
currents in the forcing (``ucur``/``vcur``) re-derive the refraction
inputs and the CFL retry mask (GETCURR → LUPDTWGHT).
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
import time
from typing import Callable

import numpy as np
import torch

from ecwam_tpu_torch.device import synchronize
from ecwam_tpu_torch.model.fusedstep import FusedPropagation
from ecwam_tpu_torch.model.setup import ModelSetup, pad_point_field
from ecwam_tpu_torch.model.stepper import initial_stress
from ecwam_tpu_torch.ops.physics import implsch_cuda as ipk
from ecwam_tpu_torch.ops.physics import means as means_mod

DATE_FMT = "%Y%m%d%H%M%S"


def parse_date(s: str) -> _dt.datetime:
    """14-char YYYYMMDDHHMMSS (incdate.F90 convention)."""
    return _dt.datetime.strptime(s, DATE_FMT)


def format_date(d: _dt.datetime) -> str:
    return d.strftime(DATE_FMT)


@dataclasses.dataclass
class StepTimers:
    """TIME_PROPAG / TIME_PHYS split (runwam.F90:389-397), seconds of
    host clock around synchronised device work."""
    propag: float = 0.0
    phys: float = 0.0
    steps: int = 0


class FastWaveModel:
    """SRL-resident wave model on one device.

    ``forcing_provider(date14) -> dict`` returns host arrays of shape
    (n_real,) for keys wswave, wdwave, aird, wstar, cicover (optional
    cithick, and ucur/vcur, the surface currents, for irefra 2/3).
    ``fl1`` (compact (nang, nfre, n_pad)) and ``stress`` (dict of
    (n_pad,) fields), numpy arrays or tensors on any device, carry a
    state across; without ``fl1`` the
    JONSWAP cold start is built in the SRL layout on the device.
    ``plain=True`` runs the plain PyTorch versions of both kernels.
    """

    WSPMIN_RESET_TAUW = 4.0           # yowwind.F90:19-20
    _ACD, _BCD = 8.0e-4, 8.0e-5       # yowpcons.F90:55-56

    def __init__(self, setup: ModelSetup, forcing_provider: Callable,
                 start_date: str | _dt.datetime, fl1=None, stress=None,
                 *, plain: bool = False):
        if setup.phys.icode_wnd != 3:
            raise NotImplementedError("only U10 forcing (icode_wnd=3) is "
                                      "ported")
        self.setup = setup
        self.forcing_provider = forcing_provider
        self.date = (parse_date(start_date)
                     if isinstance(start_date, str) else start_date)
        self.fp = fp = FusedPropagation(setup, plain=plain)
        frc, cur = self._forcing_host(self.date)
        self.frc = self._to_device(frc)
        if cur is not None:
            fp.refresh(*cur)
        # cold start and first-guess stress from the forcing as the model
        # holds it (model dtype), like the reference
        wind = {k: self.frc[k].cpu().numpy() for k in ("wswave", "wdwave")}
        if fl1 is None:
            self._f_srl, self._tail = fp.initial_srl(wind["wswave"],
                                                     wind["wdwave"])
        else:
            self.fl1 = fl1
        if stress is None:
            stress = initial_stress(setup, wind)
        (self._env2d, self._denv, self._frc6,
         self._stress6) = fp.build_phys_srl(self.frc, stress)
        self.state = {}
        self.timers = StepTimers()
        self._phys_elapsed = 0.0

    # -- forcing (GETWND / NEWWIND) ---------------------------------------
    def _forcing_host(self, date):
        """Provider fields → padded (n_pad,) float64 host arrays, and the
        currents (ucur, vcur) the same way or None; U10 is floored at
        WSPMIN (wamwnd.F90 CASE(3))."""
        raw = self.forcing_provider(format_date(date))
        keys = ["wswave", "wdwave", "aird", "wstar", "cicover"]
        if "cithick" in raw:
            keys.append("cithick")
        out = {}
        for k in keys:
            v = np.asarray(raw[k], dtype=np.float64)
            if k == "wswave":
                v = np.maximum(v, 1.0)
            out[k] = pad_point_field(self.setup, v)
        cur = None
        if "ucur" in raw:
            # as the model holds them (its dtype), like the reference
            cur = tuple(np.asarray(torch.as_tensor(pad_point_field(
                self.setup, np.asarray(raw[k], np.float64)),
                dtype=self.setup.dtype), np.float64) for k in ("ucur", "vcur"))
        return out, cur

    def _as_tensor(self, value) -> torch.Tensor:
        """A numpy array or a tensor on any device as the model's dtype on
        its device."""
        return torch.as_tensor(value, dtype=self.setup.dtype,
                               device=self.setup.device)

    def _to_device(self, fields: dict) -> dict:
        return {k: self._as_tensor(v) for k, v in fields.items()}

    def newwind(self, date):
        """Swap forcing in and cap TAUW where the new wind is weak
        (newwind.F90:97-178): TAUW ≤ (ACD+BCD·U10)·U10³/WSPMIN_RESET_TAUW.
        New currents re-derive the refraction inputs (GETCURR →
        LUPDTWGHT)."""
        frc, cur = self._forcing_host(date)
        self.frc = self._to_device(frc)
        if cur is not None:
            self.fp.refresh(*cur)
        self._frc6 = self.fp.frc_srl(self.frc)
        u10 = self._frc6[0]
        tlwmax = (1.0 / self.WSPMIN_RESET_TAUW) * (
            self._ACD + self._BCD * u10) * u10**3
        tauw = self._stress6[1]
        self._stress6 = self._stress6.clone()
        self._stress6[1] = torch.where(u10 < self.WSPMIN_RESET_TAUW,
                                       torch.minimum(tauw, tlwmax), tauw)
        return self

    # -- stepping ---------------------------------------------------------
    def advance(self, n_steps: int = 1, wind_every: int | None = None,
                full_phys: bool = False):
        """Advance ``n_steps`` advection steps of ``idelpro`` seconds;
        physics runs whenever the accumulated time reaches ``idelt``
        (wamintgr.F90:117-146).  ``wind_every``: swap forcing every N
        steps (NEWWIND incl. the TAUW cap); None keeps the forcing.
        ``full_phys``: these physics steps are output dates — full mode,
        chunked, and ``state`` takes their diagnostics at the canonical
        points."""
        s, dev = self.setup, self.setup.device
        for i in range(n_steps):
            if wind_every and i > 0 and i % wind_every == 0:
                self.newwind(self.date)
            t0 = time.perf_counter()
            self._f_srl = self.fp.advect_srl(self._f_srl)
            synchronize(dev)
            self.timers.propag += time.perf_counter() - t0
            self._phys_elapsed += s.idelpro
            if self._phys_elapsed >= s.idelt - 1e-6:
                t0 = time.perf_counter()
                args = (self._f_srl, self._stress6, self._frc6, self._denv,
                        self._env2d, self._tail)
                if full_phys:
                    (self._f_srl, self._stress6, self._tail,
                     state) = self.fp.phys_srl_full_chunked(*args)
                    self.state = self._extract(state)
                else:
                    self._f_srl, self._stress6, self._tail = \
                        self.fp.phys_srl(*args)
                self._phys_elapsed = 0.0
                synchronize(dev)
                self.timers.phys += time.perf_counter() - t0
            self.timers.steps += 1
            self.date += _dt.timedelta(seconds=s.idelpro)
        return self

    # -- compact-layout views ---------------------------------------------
    @property
    def fl1(self) -> torch.Tensor:
        """Compact spectrum (nang, nfre, n_pad)."""
        fp, tb = self.fp, self.setup.tb
        out = fp.from_srl(self._f_srl)
        if self._tail is not None:
            t = self._tail[fp.from_srl_pad]
            out = torch.cat([out, t.reshape(-1, tb.nang, tb.nfre - tb.nfre_red)
                             .permute(1, 2, 0)], dim=1)
        return out

    @fl1.setter
    def fl1(self, value):
        fp, tb = self.fp, self.setup.tb
        f = self._as_tensor(value)
        self._f_srl = fp.to_srl(f)
        self._tail = None
        if fp.LT:
            rows = f[:, tb.nfre_red:].permute(2, 0, 1).reshape(-1, fp.LT)
            rows = torch.cat([rows, rows.new_zeros((1, fp.LT))])
            self._tail = rows[fp.tabs["srl_src"]].contiguous()

    def fl1_chunk(self, start: int, count: int) -> torch.Tensor:
        """Compact spectrum (nang, nfre, count) of the canonical points
        [start, start + count) without forming the whole compact field."""
        fp, tb = self.fp, self.setup.tb
        idx = fp.from_srl_pad[start:start + count]
        n = idx.shape[0]
        out = self._f_srl[idx].reshape(n, tb.nang, tb.nfre_red)
        if self._tail is not None:
            out = torch.cat([out, self._tail[idx].reshape(
                n, tb.nang, tb.nfre - tb.nfre_red)], dim=2)
        return out.permute(1, 2, 0)

    def _extract(self, state: dict) -> dict:
        """SRL-ordered per-point rows (nested dicts too) → (n_pad,)."""
        return {k: (self._extract(v) if isinstance(v, dict)
                    else self.fp.extract_state(v)) for k, v in state.items()}

    @property
    def stress(self) -> dict:
        rows = self.fp.extract_state(self._stress6)
        return {k: rows[i] for i, k in enumerate(ipk.STRESS_KEYS)}

    @stress.setter
    def stress(self, value):
        """The six STRESS_KEYS fields, each (n_pad,), into the SRL rows
        (the land slot replicates point 0, as at construction)."""
        self._stress6 = self.fp.stress_srl(value)

    # -- diagnostics ------------------------------------------------------
    def swh(self) -> np.ndarray:
        """Significant wave height over real sea points."""
        em = means_mod.semean(self.fl1, self.setup.tb)
        return (4.0 * torch.sqrt(em)).cpu().numpy()[: self.setup.n_real]

    def norms(self) -> dict:
        """avg/min/max of SWH — the statistics.log contract
        (outwnorm.F90:80-140)."""
        swh = self.swh()
        return dict(name="swh", date=format_date(self.date),
                    average=float(swh.mean()), minimum=float(swh.min()),
                    maximum=float(swh.max()), count=int(swh.size))


def constant_wind_forcing(n_real: int, u10: float = 10.0,
                          direction: float = 0.0):
    """Uniform forcing provider for tests and checks."""
    def provider(date14: str):
        return dict(
            wswave=np.full(n_real, u10),
            wdwave=np.full(n_real, direction),
            aird=np.full(n_real, 1.225),
            wstar=np.zeros(n_real),
            cicover=np.zeros(n_real))
    return provider
