"""Time-integration drivers (the RUNWAM/WAMODEL role).

Port of ``ecwam_tpu/model/driver.py``:

  * :class:`WaveModel`, the dense model: the spectrum stays compact
    (nang, nfre, n_pad) between steps; each ``idelpro`` advects it in the
    setup's weight mode (``cached``/``otf`` CTU weights, or kernel A in
    ``fused``, :mod:`.stepper`) and each ``idelt`` runs the full-mode
    physics through kernel C, with the windsea mask and every diagnostic
    in ``state``.  It takes u* forcing (icode_wnd 1/2) as well as U10;
  * :class:`FastWaveModel`, the production stepping mode: the spectrum
    stays in the segmented row layout between steps, each ``idelpro`` runs
    the CTU advection (kernel A) and each ``idelt`` the IMPLSCH physics
    (kernel B): minimal mode between output dates, and at output dates
    (``advance(..., full_phys=True)``) full mode chunked over rows with
    the windsea/swell separation, which fills ``state``.

(wamodel.F90:228-649, wamintgr.F90:94-186.)  Dates are 14-character
strings (incdate.F90) kept as ``datetime``.  Surface currents in the
forcing (``ucur``/``vcur``) re-derive the refraction inputs and the CFL
retry (GETCURR → LUPDTWGHT).
"""

from __future__ import annotations

import datetime as _dt
from typing import Callable

import numpy as np
import torch

from ecwam_tpu_torch.model.fusedstep import FusedPropagation
from ecwam_tpu_torch.model.setup import ModelSetup, pad_point_field
from ecwam_tpu_torch.model import preset as preset_mod
from ecwam_tpu_torch.model import stepper as stepper_mod
from ecwam_tpu_torch.model.stepper import initial_stress
from ecwam_tpu_torch.ops import propagation_fused as pfz
from ecwam_tpu_torch.ops.physics import implsch_cuda as ipk
from ecwam_tpu_torch.ops.physics import means as means_mod
from ecwam_tpu_torch.tracing import Tally, span

DATE_FMT = "%Y%m%d%H%M%S"
# the forcing's surface currents (GETCURR), uploaded with the rest
CURRENT_KEYS = ("ucur", "vcur")


def parse_date(s: str) -> _dt.datetime:
    """14-char YYYYMMDDHHMMSS (incdate.F90 convention)."""
    return _dt.datetime.strptime(s, DATE_FMT)


def format_date(d: _dt.datetime) -> str:
    return d.strftime(DATE_FMT)


class StepTimers:
    """TIME_PROPAG / TIME_PHYS split (runwam.F90:389-397): the seconds of
    the model's ``advect`` and ``phys`` spans, device time between CUDA
    events on the card (from the step's first operation to its last,
    never waited on while stepping) and host time on the CPU;
    ``phys_full`` is the part of ``phys`` spent in output-date (full-mode)
    physics steps.  Reading a field waits on that field's events alone."""

    def __init__(self):
        self.tallies = dict(propag=Tally(), phys=Tally(), phys_full=Tally())
        self.steps = 0

    @property
    def propag(self) -> float:
        return self.tallies["propag"].seconds

    @property
    def phys(self) -> float:
        return self.tallies["phys"].seconds

    @property
    def phys_full(self) -> float:
        return self.tallies["phys_full"].seconds

    def __repr__(self):
        return (f"StepTimers(propag={self.propag!r}, phys={self.phys!r}, "
                f"phys_full={self.phys_full!r}, steps={self.steps!r})")


class WaveModel:
    """The dense wave model on one device (the reference's ``WaveModel``).

    ``forcing_provider(date14) -> dict`` returns host arrays of shape
    (n_real,) for keys wswave, wdwave, aird, wstar, cicover (optional
    cithick; ufric, the friction velocity, for u* forcing, icode_wnd 1/2;
    ucur/vcur, the surface currents, for irefra 2/3).  ``fl1`` (compact
    (nang, nfre, n_pad)) and ``stress`` (dict of (n_pad,) fields), numpy
    arrays or tensors on any device, carry a state across; without
    ``fl1`` the JONSWAP cold start of the forcing's winds.  Every physics
    step runs in full mode, so ``state`` always holds the last one's
    diagnostics and windsea mask.  ``plain=True`` runs the plain PyTorch
    versions of kernels A and C (for the checks).
    """

    # forcing-swap constants (yowwind.F90:19-20, yowpcons.F90:55-56)
    WSPMIN_RESET_TAUW = 4.0
    USTMIN_RESET_TAUW = 0.08
    _ACD, _BCD = 8.0e-4, 8.0e-5

    def __init__(self, setup: ModelSetup, forcing_provider: Callable,
                 start_date: str | _dt.datetime, fl1=None, stress=None,
                 *, plain: bool = False):
        self.setup = setup
        self.forcing_provider = forcing_provider
        self.date = (parse_date(start_date) if isinstance(start_date, str)
                     else start_date)
        self._uploaded = None                  # the last upload's event
        with span("model.init"):
            self.steps = stepper_mod.make_step(setup, plain=plain)
            self.step_full, self.step_adv, self.step_phys = self.steps
            self.frc, self._currents = self._upload(
                self._forcing_host(self.date))
            if self._currents is not None:
                self.steps.refresh_currents(*self._currents)
            # cold start and first-guess stress from the forcing as the
            # model holds it (model dtype), like the reference
            wind = {k: self.frc[k].cpu().numpy()
                    for k in ("wswave", "wdwave")}
            self.fl1 = (preset_mod.mstart(setup.tb, wind["wswave"],
                                          wind["wdwave"])
                        if fl1 is None else fl1)
            self.stress = initial_stress(setup, wind) if stress is None \
                else stress
        self.state = {}
        self.timers = StepTimers()
        self._phys_elapsed = 0.0

    @property
    def fl1(self) -> torch.Tensor:
        """Compact spectrum (nang, nfre, n_pad)."""
        return self._fl1

    @fl1.setter
    def fl1(self, value):
        # the compact layout, points contiguous (kernel C's layout)
        self._fl1 = self._as_tensor(value).contiguous()

    @property
    def currents(self):
        """The surface currents (ucur, vcur) the propagation was last
        refreshed with (GETCURR), (n_pad,) float64 host arrays as the model
        holds them (its dtype), or None.  The model keeps them on its
        device; reading them copies them to the host."""
        if self._currents is None:
            return None
        return tuple(np.asarray(c.cpu(), np.float64) for c in self._currents)

    def take_points(self, idx) -> torch.Tensor:
        """The spectra (nang, nfre, nb) at the canonical points ``idx``."""
        return self._fl1[..., self._index(idx)]

    def put_points(self, idx, spec) -> None:
        """Overwrite the spectra at the canonical points ``idx`` with
        ``spec`` (nang, nfre, nb), in place."""
        self._fl1[..., self._index(idx)] = self._as_tensor(spec)

    def _index(self, idx) -> torch.Tensor:
        return torch.as_tensor(idx, dtype=torch.int64,
                               device=self.setup.device)

    @property
    def stress(self) -> dict:
        return self._stress

    @stress.setter
    def stress(self, value):
        """The six STRESS_KEYS fields, each (n_pad,), numpy or tensors on
        any device."""
        self._stress = {k: self._as_tensor(value[k])
                        for k in ipk.STRESS_KEYS}

    # -- forcing (GETWND / NEWWIND) ---------------------------------------
    def _forcing_host(self, date):
        """Provider fields → padded (n_pad,) float64 host arrays, the
        surface currents ``ucur``/``vcur`` among them where the provider
        gives them.  Under U10 forcing (icode_wnd 3) the wind is floored
        at WSPMIN (wamwnd.F90 CASE(3)); u* forcing brings ``ufric``."""
        raw = self.forcing_provider(format_date(date))
        keys = ["wswave", "wdwave", "aird", "wstar", "cicover"]
        keys += [k for k in ("cithick", "ufric") if k in raw]
        if "ucur" in raw:
            keys += list(CURRENT_KEYS)
        out = {}
        for k in keys:
            v = np.asarray(raw[k], dtype=np.float64)
            if k == "wswave" and self.setup.phys.icode_wnd == 3:
                v = np.maximum(v, 1.0)
            out[k] = pad_point_field(self.setup, v)
        return out

    def _as_tensor(self, value) -> torch.Tensor:
        """A numpy array or a tensor on any device as the model's dtype on
        its device."""
        return torch.as_tensor(value, dtype=self.setup.dtype,
                               device=self.setup.device)

    def _upload(self, fields: dict):
        """The hour's host fields (:meth:`_forcing_host`) on the device in
        the model's dtype, split into the forcing and the currents
        (ucur, vcur), as the model holds them, or None.

        One copy: the fields are stacked and cast on the host, into
        pinned memory for a card, and copied without waiting for the work
        queued before it, so that the card stays busy while the host
        prepares the next period; each field is a row of the one device
        tensor.  The host waits only until the previous upload has run
        on the card, so it stays at most about one forcing period ahead
        and no launch of the period's work waits for room in the queue."""
        dev = self.setup.device
        host = torch.from_numpy(np.stack(list(fields.values()))).to(
            self.setup.dtype)
        if dev.type == "cuda":
            host = host.pin_memory()
            if self._uploaded is not None:
                self._uploaded.synchronize()
        frc = dict(zip(fields, host.to(dev, non_blocking=True)))
        if dev.type == "cuda":
            self._uploaded = torch.cuda.Event()
            self._uploaded.record(torch.cuda.current_stream(dev))
        if CURRENT_KEYS[0] not in frc:
            return frc, None
        return frc, tuple(frc.pop(k) for k in CURRENT_KEYS)

    def newwind(self, date):
        """Swap staged forcing in (newwind.F90:97-178).

        ICODE 3: cap the wave stress where the new wind is weak —
        TAUW ≤ (ACD+BCD·U10)·U10³/WSPMIN_RESET_TAUW (newwind.F90:125-146).
        ICODE 1/2: take u* from the forcing and rebuild
        TAUW = u*²·(1−(α/CHARNOCK)²), zeroed below USTMIN_RESET_TAUW.
        New currents re-derive the CTU weights (GETCURR → LUPDTWGHT).

        The provider's fields are padded on the host and uploaded at once,
        currents included; the weights (``refresh``, timed on the device)
        and the stress update run on the model's device."""
        with span("newwind"):
            with span("newwind.forcing"):
                fields = self._forcing_host(date)
            with span("newwind.upload"):
                frc, cur = self._upload(fields)
            stress = dict(self.stress)
            if self.setup.phys.icode_wnd == 3:
                u10 = frc["wswave"]
                tlwmax = (1.0 / self.WSPMIN_RESET_TAUW) * (
                    self._ACD + self._BCD * u10) * u10**3
                stress["tauw"] = torch.where(
                    u10 < self.WSPMIN_RESET_TAUW,
                    torch.minimum(stress["tauw"], tlwmax), stress["tauw"])
            else:
                us = frc["ufric"]
                alpha = self.setup.phys.params.alpha
                tauw = us**2 * (1.0 - (alpha / stress["chrnck"]) ** 2)
                stress.update(ufric=us, tauw=torch.where(
                    us < self.USTMIN_RESET_TAUW, torch.zeros_like(tauw),
                    tauw))
            self.stress = stress
            self.frc = frc
            if cur is not None:
                self._currents = cur
                with span("refresh", self.setup.device):
                    self.steps.refresh_currents(*cur)
        return self

    def advance(self, n_steps: int = 1, wind_every: int | None = None,
                full_phys: bool = True):
        """Advance ``n_steps`` advection steps of ``idelpro`` seconds;
        physics runs in full mode whenever the accumulated time reaches
        ``idelt`` (wamintgr.F90:117-146).  ``wind_every``: swap forcing
        every N steps (NEWWIND incl. the TAUW cap); None keeps the forcing.
        ``full_phys`` is taken for parity with :class:`FastWaveModel`.
        The timers split each step into its advection and its physics."""
        s, dev = self.setup, self.setup.device
        tal = self.timers.tallies
        for i in range(n_steps):
            if wind_every and i > 0 and i % wind_every == 0:
                self.newwind(self.date)
            with span("advect", dev, (tal["propag"],)):
                fl1 = self.step_adv(self._fl1)
            self._phys_elapsed += s.idelpro
            if self._phys_elapsed >= s.idelt - 1e-6:
                with span("phys", dev, (tal["phys"], tal["phys_full"])):
                    fl1, st = self.steps.phys_inplace(fl1, self.frc,
                                                      self.stress)
                    self.stress = {k: st[k] for k in ipk.STRESS_KEYS}
                self.state = st
                self._phys_elapsed = 0.0
            self._fl1 = fl1
            self.timers.steps += 1
            self.date += _dt.timedelta(seconds=s.idelpro)
        return self

    # -- diagnostics ------------------------------------------------------
    def memory_report(self) -> dict:
        """Device-memory snapshot (EC_MEMINFO role, runwam.F90:420-432),
        from ``torch.cuda.memory_stats``; None on the CPU."""
        dev = self.setup.device
        if dev.type != "cuda":
            return dict(bytes_in_use=None, peak_bytes_in_use=None,
                        bytes_limit=None)
        stats = torch.cuda.memory_stats(dev)
        return dict(
            bytes_in_use=stats.get("allocated_bytes.all.current"),
            peak_bytes_in_use=stats.get("allocated_bytes.all.peak"),
            bytes_limit=torch.cuda.get_device_properties(dev).total_memory)

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


class FastWaveModel(WaveModel):
    """SRL-resident wave model on one device.

    The forcing provider and the ``fl1``/``stress`` state are those of
    :class:`WaveModel`; without ``fl1`` the JONSWAP cold start is built in
    the SRL layout on the device.  U10 forcing (icode_wnd 3) only, on
    purpose: the reference's fast path accepts icode_wnd 1/2 but its
    ``newwind`` on SRL rows handles ICODE 3 alone and never reads
    ``ufric`` (ecwam_tpu/model/driver.py:362-376), so it steps with the
    forcing's ``wswave`` as given; u* forcing runs in :class:`WaveModel`.
    ``plain=True`` runs the plain PyTorch versions of kernels A and B.
    """

    def __init__(self, setup: ModelSetup, forcing_provider: Callable,
                 start_date: str | _dt.datetime, fl1=None, stress=None,
                 *, plain: bool = False):
        if setup.phys.icode_wnd != 3:
            raise NotImplementedError(
                "FastWaveModel takes U10 forcing (icode_wnd 3) only; u* "
                "forcing (icode_wnd 1/2) runs in the dense WaveModel (the "
                "reference's fast path would accept it but never read "
                "ufric)")
        if setup.fused is None:
            raise ValueError("FastWaveModel runs on a setup built with "
                             "weights_mode='fused'")
        self.setup = setup
        self.forcing_provider = forcing_provider
        self.date = (parse_date(start_date)
                     if isinstance(start_date, str) else start_date)
        self._uploaded = None                  # the last upload's event
        with span("model.init"):
            self.fp = fp = FusedPropagation(setup, plain=plain)
            self.frc, self._currents = self._upload(
                self._forcing_host(self.date))
            if self._currents is not None:
                fp.refresh(*self._currents)
            # cold start and first-guess stress from the forcing as the
            # model holds it (model dtype), like the reference
            wind = {k: self.frc[k].cpu().numpy()
                    for k in ("wswave", "wdwave")}
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

    def newwind(self, date):
        """Swap forcing in and cap TAUW where the new wind is weak
        (newwind.F90:97-178): TAUW ≤ (ACD+BCD·U10)·U10³/WSPMIN_RESET_TAUW.
        New currents re-derive the refraction inputs (GETCURR →
        LUPDTWGHT).

        On the host: the provider's fields, padded (``newwind.forcing``),
        and one upload of them all, currents included (``newwind.upload``:
        the host's one wait, for the previous upload, :meth:`_upload`).
        The rest runs on the model's device without a copy either way:
        the refresh of the refraction inputs and the CFL retry
        (``refresh``, :meth:`FusedPropagation.refresh`), the forcing rows
        and the TAUW cap (``newwind.rows``)."""
        with span("newwind"):
            with span("newwind.forcing"):
                fields = self._forcing_host(date)
            with span("newwind.upload"):
                self.frc, cur = self._upload(fields)
            if cur is not None:
                self._currents = cur
                with span("refresh", self.setup.device):
                    self.fp.refresh(*cur)
            with span("newwind.rows"):
                self._frc6 = self.fp.frc_srl(self.frc)
                u10 = self._frc6[0]
                tlwmax = (1.0 / self.WSPMIN_RESET_TAUW) * (
                    self._ACD + self._BCD * u10) * u10**3
                tauw = self._stress6[1]
                self._stress6 = self._stress6.clone()
                self._stress6[1] = torch.where(
                    u10 < self.WSPMIN_RESET_TAUW,
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
        tal = self.timers.tallies
        into = (tal["phys"], tal["phys_full"]) if full_phys else \
            (tal["phys"],)
        for i in range(n_steps):
            if wind_every and i > 0 and i % wind_every == 0:
                self.newwind(self.date)
            with span("advect", dev, (tal["propag"],)):
                self._f_srl = self.fp.advect_srl(self._f_srl)
            self._phys_elapsed += s.idelpro
            if self._phys_elapsed >= s.idelt - 1e-6:
                args = (self._f_srl, self._stress6, self._frc6, self._denv,
                        self._env2d, self._tail)
                with span("phys", dev, into):
                    if full_phys:
                        (self._f_srl, self._stress6, self._tail,
                         state) = self.fp.phys_srl_full_chunked(*args)
                        self.state = self._extract(state)
                    else:
                        self._f_srl, self._stress6, self._tail = \
                            self.fp.phys_srl(*args)
                self._phys_elapsed = 0.0
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
        return self._gather(self.fp.from_srl_pad[start:start + count])

    def take_points(self, idx) -> torch.Tensor:
        """The spectra (nang, nfre, nb) at the canonical points ``idx``,
        gathered from their SRL rows and tail."""
        return self._gather(self.fp.from_srl_pad[self._index(idx)])

    def put_points(self, idx, spec) -> None:
        """Overwrite the spectra at the canonical points ``idx`` with
        ``spec`` (nang, nfre, nb), in place: the first ``nfre_red``
        frequencies into each point's SRL row (k-major lanes), the rest
        into the same row of the tail.  Only the canonical rows are
        written.  A point's wrap duplicates keep their old values until
        the next :meth:`FusedPropagation.advect_srl`, which refreshes the
        wrap slots from the canonical rows before its pass; nothing reads
        them before that (the physics runs after the advection, and the
        wrap rows' physics results are overwritten by that refresh).  Pad
        rows are not touched."""
        fp, tb = self.fp, self.setup.tb
        rows = fp.from_srl_pad[self._index(idx)]
        f = self._as_tensor(spec)
        self._f_srl[rows] = pfz.to_lanes(f, tb.nfre_red, tb.nang)
        if self._tail is not None:
            self._tail[rows] = f[:, tb.nfre_red:].permute(2, 0, 1).reshape(
                rows.shape[0], fp.LT)

    def _gather(self, rows) -> torch.Tensor:
        tb = self.setup.tb
        n = rows.shape[0]
        out = self._f_srl[rows].reshape(n, tb.nang, tb.nfre_red)
        if self._tail is not None:
            out = torch.cat([out, self._tail[rows].reshape(
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
