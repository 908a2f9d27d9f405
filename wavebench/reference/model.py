"""The plain reference of a cell's check: the step the timed path takes,
worked out again from the configuration with the frozen plain modules of
:mod:`wavebench.reference.ecw`, from a state handed to it.

:class:`Reference` builds its own grid, SRL tables, physics tables and
second-order tables (into its own cache directory), and follows the
program from the program's own state: the forcing swap of a new forcing
period (NEWWIND with the TAUW cap and, with currents, the refraction
inputs and the CFL retry), advection steps with their fast-wave
sub-band passes, a minimal physics step, and an output date (an
advection step, full-mode physics with the windsea/swell split, the
second-order spectrum and the product catalog).  ``store`` is the
precision its state is held in between stages: float32 (the
configuration's) for the reference, bfloat16 for the control.
"""

from __future__ import annotations

import numpy as np
import torch

from wavebench.reference.ecw.io import products as products_mod
from wavebench.reference.ecw.model import preset as preset_mod
from wavebench.reference.ecw.model import setup as setup_mod
from wavebench.reference.ecw.model.fusedstep import FusedPropagation
from wavebench.reference.ecw.ops import secondorder as so_mod
from wavebench.reference.ecw.ops.physics import implsch_rows as ipk

# NEWWIND's TAUW cap (newwind.F90:125-146) and the U10 floor WSPMIN
# (wamwnd.F90 CASE(3))
WSPMIN_RESET_TAUW = 4.0
ACD, BCD = 8.0e-4, 8.0e-5
WSPMIN = 1.0
STRESS_KEYS = ipk.STRESS_KEYS
# rows a plain physics call takes at once (its intermediates scale with it)
PHYS_CHUNK = 65536


class Reference:
    """The reference model of one configuration on ``device``."""

    def __init__(self, build_kw: dict, device, cache_dir=None,
                 currents=None, store=torch.float32):
        self.ms = ms = setup_mod.build_model(
            **build_kw, currents=currents, cache_dir=cache_dir,
            device=device)
        self.fp = FusedPropagation(ms)
        self.store = store
        self.f_srl = self.tail = self.stress6 = None
        self.frc = self.frc6 = None
        env, src = ms.env, self.fp.tabs["srl_src"]
        self.env2d = torch.cat([env[k + "_ext"][:, src]
                                for k in ipk.ENV_FIELDS])
        self.denv = torch.stack([env["depth_ext"][src],
                                 env["emaxdpt_ext"][src]])
        self.phys_elapsed = 0.0

    # -- state --------------------------------------------------------
    def _held(self, t):
        if t is None or self.store == self.ms.dtype:
            return t
        return t.to(self.store).to(self.ms.dtype)

    def _t(self, a):
        return torch.as_tensor(np.asarray(a), dtype=self.ms.dtype,
                               device=self.ms.device)

    def _pad(self, v):
        ms = self.ms
        out = np.empty(ms.n_pad)
        out[:ms.n_real] = v
        out[ms.n_real:] = v[0]
        return out

    def put_state(self, fl1, stress: dict, phys_elapsed: float = 0.0):
        """The state to follow: the compact spectrum (nang, nfre, n_pad)
        and the STRESS_KEYS fields (n_pad,), host arrays or tensors."""
        fp, tb = self.fp, self.ms.tb
        f = self._held(self._t(fl1))
        self.f_srl = fp.to_srl(f)
        self.tail = None
        if fp.LT:
            rows = f[:, tb.nfre_red:].permute(2, 0, 1).reshape(-1, fp.LT)
            rows = torch.cat([rows, rows.new_zeros((1, fp.LT))])
            self.tail = rows[fp.tabs["srl_src"]].contiguous()
        self.stress6 = self._held(fp.stress_srl(
            {k: self._t(stress[k]) for k in STRESS_KEYS}))
        self.phys_elapsed = phys_elapsed

    def fl1(self) -> torch.Tensor:
        """The compact spectrum (nang, nfre, n_pad)."""
        fp, tb = self.fp, self.ms.tb
        out = fp.from_srl(self.f_srl)
        if self.tail is not None:
            t = self.tail[fp.from_srl_pad]
            out = torch.cat([out, t.reshape(-1, tb.nang, tb.nfre - tb.nfre_red)
                             .permute(1, 2, 0)], dim=1)
        return out

    def stress(self) -> dict:
        rows = self.fp.extract_state(self.stress6)
        return {k: rows[i] for i, k in enumerate(STRESS_KEYS)}

    # -- forcing (NEWWIND) ----------------------------------------------
    def newwind(self, raw: dict):
        """Take the forcing ``raw`` ((n_real,) host arrays, the model's
        provider output): floor U10 at WSPMIN, refresh the refraction
        inputs from new currents, and cap TAUW where the wind is weak."""
        frc = {}
        for k in ("wswave", "wdwave", "aird", "wstar", "cicover", "cithick"):
            if k in raw:
                v = np.asarray(raw[k], np.float64)
                if k == "wswave":
                    v = np.maximum(v, WSPMIN)
                frc[k] = self._t(self._pad(v))
        if "ucur" in raw:
            # the currents as the model's dtype holds them
            cur = [np.asarray(self._t(self._pad(np.asarray(raw[k],
                                                           np.float64)))
                              .cpu(), np.float64) for k in ("ucur", "vcur")]
            self.fp.refresh(*cur)
        self.frc = frc
        self.frc6 = self.fp.frc_srl(frc)
        if self.stress6 is not None:
            u10 = self.frc6[0]
            tlwmax = (1.0 / WSPMIN_RESET_TAUW) * (ACD + BCD * u10) * u10**3
            s6 = self.stress6.clone()
            s6[1] = torch.where(u10 < WSPMIN_RESET_TAUW,
                                torch.minimum(s6[1], tlwmax), s6[1])
            self.stress6 = s6

    # -- stepping -----------------------------------------------------
    def _phys_minimal(self):
        cfg = ipk.minimal_config(self.ms.phys)
        scal = torch.cat([self.frc6, self.denv, self.stress6])
        fp = self.fp
        nsrl = self.f_srl.shape[0]
        f_out = torch.empty_like(self.f_srl)
        t_out = None if self.tail is None else torch.empty_like(self.tail)
        s_out = torch.empty_like(self.stress6)
        for r0 in range(0, nsrl, PHYS_CHUNK):
            rows = slice(r0, min(nsrl, r0 + PHYS_CHUNK))
            f, so, t = ipk.implsch_srl_plain(
                cfg, self.f_srl[rows], self.env2d[:, rows].contiguous(),
                scal[:, rows].contiguous(),
                None if self.tail is None else self.tail[rows],
                nang=fp.nang, nfre_red=fp.nfre_red)
            f_out[rows] = f
            s_out[:, rows] = so
            if t_out is not None:
                t_out[rows] = t
        self.f_srl = self._held(f_out)
        self.tail = self._held(t_out)
        self.stress6 = self._held(s_out)

    def advance(self, n_steps: int, full_phys: bool = False):
        """``n_steps`` advection steps; physics where the elapsed time
        reaches idelt (full mode with ``full_phys``).  Returns the
        full-mode state of the last output-date step, or None."""
        ms, state = self.ms, None
        for _ in range(n_steps):
            self.f_srl = self._held(self.fp.advect_srl(self.f_srl))
            self.phys_elapsed += ms.idelpro
            if self.phys_elapsed >= ms.idelt - 1e-6:
                if full_phys:
                    state = self._phys_full()
                else:
                    self._phys_minimal()
                self.phys_elapsed = 0.0
        return state

    def _phys_full(self) -> dict:
        from wavebench.reference.ecw.model.fusedstep import full_chunked_rows
        ms, fp = self.ms, self.fp
        scal = torch.cat([self.frc6, self.denv, self.stress6])
        f_srl, tail, state = full_chunked_rows(
            ms.phys, ms.tb, self.f_srl, self.tail, scal, self.env2d,
            nang=fp.nang, nfre_red=fp.nfre_red)
        self.f_srl, self.tail = self._held(f_srl), self._held(tail)
        self.stress6 = self._held(torch.stack(
            [state[k].to(f_srl.dtype) for k in STRESS_KEYS]))
        return {k: (fp.extract_state(v) if not isinstance(v, dict) else
                    {kk: fp.extract_state(vv) for kk, vv in v.items()})
                for k, v in state.items()}

    # -- output date --------------------------------------------------
    def products(self, names, state: dict, chunk: int = 65536,
                 second_order: bool = True) -> dict:
        """The catalog ``names`` of the current spectrum with the
        second-order correction, as the output date computes it:
        name → (n_real,) tensor."""
        ms = self.ms
        so_tab = so_mod.build_second_order_tables(ms.tb)
        so_dev = so_mod.device_tables(so_tab, ms.env["depth"])
        fl = self.fl1()
        st = {**state, **self.stress()}
        env = {k: v for k, v in ms.env.items() if not k.endswith("_ext")}
        pieces = {n: [] for n in names}
        for s in range(0, ms.n_pad, chunk):
            cols = slice(s, min(ms.n_pad, s + chunk))
            fl_c = fl[..., cols]
            env_c = {k: v[..., cols] for k, v in env.items()}
            if second_order:
                fl_c = so_mod.cal_second_order_spec(
                    fl_c, env_c["wavnum"], env_c["depth"], ms.tb, so_tab,
                    sig=1.0, tabs=so_dev)
            fields = products_mod.compute(
                names, fl_c, ms.tb, _cols(st, cols), _cols(self.frc, cols),
                ms.phys.params, env=env_c, llgcbz0=ms.phys.params.llgcbz0)
            for n in names:
                pieces[n].append(fields[n])
        return {n: torch.cat(v)[:ms.n_real].to(ms.dtype)
                for n, v in pieces.items()}


def _cols(tree: dict, cols) -> dict:
    return {k: (_cols(v, cols) if isinstance(v, dict) else v[..., cols])
            for k, v in tree.items()}


def cold_start(tb, wswave, wdwave, *, fetch: float = 50000.0,
               frmax: float = 0.2, zgamma: float = 3.0, sa: float = 0.07,
               sb: float = 0.09) -> np.ndarray:
    """JONSWAP cold start (MSTART IOPTI=1, mstart.F90:49-80) of the points
    whose winds are given, in float64: (nang, nfre, n)."""
    fp, alphaj = preset_mod.peak(np.asarray(wswave, np.float64), fetch,
                                 frmax)
    et = preset_mod.jonswap_1d(tb.fr, fp, alphaj, zgamma, sa, sb)
    st = preset_mod.spread(tb.th, np.asarray(wdwave, np.float64))
    return np.einsum("pk,pm->kmp", st, et)
