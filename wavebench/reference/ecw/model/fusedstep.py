"""The fused step's plain path: the port's ``FusedPropagation`` and
``full_chunked_rows`` (``ecwam_tpu_torch/model/fusedstep.py``) frozen
with ``plain=True``.  The spectrum lives in the segmented row layout
(SRL, :mod:`.propagation_fused`); each advection step refreshes the
row-wrap slots and runs one all-band CTU pass plus the extra fast-wave
sub-band passes (propag_wam.F90:247-313), and each physics step runs the
IMPLSCH chain on every SRL row: in minimal mode between output dates,
and at output dates in full mode, chunked over rows, with each chunk's
windsea mask consumed at once by the windsea/swell separation.
"""

from __future__ import annotations

import numpy as np
import torch

from wavebench.reference.ecw.io import products as products_mod
from wavebench.reference.ecw.model import preset as preset_mod
from wavebench.reference.ecw.ops import propagation as prop
from wavebench.reference.ecw.ops import propagation_pass as pcu
from wavebench.reference.ecw.ops import propagation_fused as pfz
from wavebench.reference.ecw.ops.physics import implsch_rows as ipk


# windsea/swell separation keys precomputed by the chunked full step
SEP_KEYS = ("eswell", "fswell", "thswell", "p1swell", "p2swell",
            "sprdswell", "esea", "fsea", "thwisea", "p1sea", "p2sea",
            "sprdsea")


def full_chunked_rows(cfg, tb, f_srl, tail, scal_all, env2d, *,
                      nang: int, nfre_red: int, chunk: int = 65536):
    """Full-mode physics over SRL rows in chunks of ``chunk`` rows, in
    place: each chunk's windsea mask xllws (nang, nfre, rows) goes
    straight into the windsea/swell separation
    (:func:`wavebench.reference.ecw.io.products.sepwisw`) and is dropped, so a
    whole-field mask (2.4 GB at O320) never exists.

    Runs the plain IMPLSCH chain in full mode.  Returns
    (f_srl, tail, state): the SCAL_OUT_FULL rows (mij as int64) plus
    ``sep``, a dict of the SEP_KEYS rows.
    """
    nfre = tb.nfre
    nsrl = f_srl.shape[0]
    i_uf = ipk.SCAL_OUT_FULL.index("ufric")
    state_rows = f_srl.new_empty((len(ipk.SCAL_OUT_FULL), nsrl))
    sep_rows = f_srl.new_empty((len(SEP_KEYS), nsrl))
    for s in range(0, nsrl, chunk):
        rows = slice(s, min(nsrl, s + chunk))
        f_c = f_srl[rows]
        t_c = tail[rows] if tail is not None else None
        scal_c = scal_all[:, rows].contiguous()
        env_c = env2d[:, rows].contiguous()
        f_new, so, t_new, xllws = ipk.implsch_srl_plain(
            cfg, f_c, env_c, scal_c, t_c, nang=nang, nfre_red=nfre_red,
            full=True)
        f_c.copy_(f_new)
        if t_c is not None:
            t_c.copy_(t_new)
        cc = f_c.shape[0]
        fl = f_c.reshape(cc, nang, nfre_red).permute(1, 2, 0)
        if t_c is not None:
            fl = torch.cat([fl, t_c.reshape(cc, nang, nfre - nfre_red)
                            .permute(1, 2, 0)], dim=1)
        sep = products_mod.sepwisw(fl, xllws, env_c[nfre:2 * nfre],
                                   so[i_uf], scal_c[0], scal_c[1], tb)
        del xllws
        sep_rows[:, rows] = torch.stack([sep[k] for k in SEP_KEYS])
        state_rows[:, rows] = so
    state = ipk.unpack_scal_out(state_rows, full=True)
    state["sep"] = {k: sep_rows[i] for i, k in enumerate(SEP_KEYS)}
    return f_srl, tail, state


class FusedPropagation:
    """Static tables of the fused step for the setup's domain, on its
    device."""

    def __init__(self, setup):
        self.setup = setup
        self.ft = ft = setup.fused
        tb = setup.tb
        self.nang, self.nfre_red = tb.nang, tb.nfre_red
        self.L = self.nang * self.nfre_red
        self.LT = self.nang * (tb.nfre - tb.nfre_red)
        dt = setup.dtype
        device = setup.device
        self.dtype, self.device = dt, device

        def t(a):
            return torch.as_tensor(np.asarray(a), dtype=dt, device=device)
        fe = setup.fused_env
        tabs = pfz.device_tables(ft, dt, device)
        tabs.update(cg_srl=t(fe["cg_srl"]), cg_land=t(fe["cg_land"]))
        if setup.irefra:
            tabs["pf"] = t(fe["pf"])
        fs = np.asarray(ft.from_srl)
        pad = np.full(setup.n_pad - ft.npts, fs[0] if fs.size else 0)
        self.from_srl_pad = torch.as_tensor(np.concatenate([fs, pad]),
                                            dtype=torch.int64, device=device)

        dtf = np.full(self.nfre_red, setup.idelpro)
        if setup.ifrelfmax > 0:
            dtf[: setup.ifrelfmax] = setup.delpro_lf
        self.lc = pcu.lane_tensors(
            pfz.lane_consts(tb, dtf, self.nfre_red), dt, device)
        self.nsub = (max(1, round(setup.idelpro / setup.delpro_lf))
                     if setup.ifrelfmax > 0 else 1)
        self.mlf = setup.ifrelfmax
        # with σ̇ frequency shifting the sub-band carries ONE extra
        # frequency so that the m+1 coupling at the band edge sees the
        # once-advected high-band value (propag_wam.F90:262-265 ND3EF1 =
        # IFRELFMAX+1); the pass computes mlf_w frequencies and writes mlf
        self.mlf_w = (self.mlf + 1 if setup.irefra in (2, 3) and self.mlf
                      else self.mlf)
        self.lc_lo = None
        if self.nsub > 1:
            self.lc_lo = pcu.lane_tensors(
                pfz.lane_consts(tb, np.full(self.mlf_w, setup.delpro_lf),
                                self.mlf_w), dt, device)
        self.tabs = tabs
        self.cfl_bad = None
        self.refresh()

    # -- LUPDTWGHT / GETCURR --------------------------------------------
    def refresh(self, ucur=None, vcur=None):
        """Recompute the refraction inputs (propdot.F90:60-150 via GRADI):
        the depth gradients (irefra 1/3) and, with currents (irefra 2/3),
        the current field ``uv``, its gradients and ω·∂d (``omdd``,
        irefra 3), then the CFL current retry.  ``ucur``/``vcur`` are
        compact (n_pad,) arrays (GETCURR); None takes the setup's."""
        setup = self.setup
        if not setup.irefra:
            return
        src = np.asarray(self.ft.srl_src)
        zeros = np.zeros(setup.n_pad + 1)
        u_ext = v_ext = zeros
        cur = setup.irefra in (2, 3)
        if cur:
            if ucur is not None:
                u_ext, v_ext = (np.concatenate(
                    [np.asarray(a, np.float64)[:setup.n_pad], [0.0]])
                    for a in (ucur, vcur))
            else:
                u_ext, v_ext = (setup.env[k].cpu().numpy().astype(np.float64)
                                for k in ("ucur_ext", "vcur_ext"))
            self.tabs["uv"] = self._t(np.stack([u_ext[src], v_ext[src]], -1))
        g = prop.gradi(setup.stencil, self.setup.fused_env["depth_ext"],
                       u_ext, v_ext, setup.irefra)
        dco = np.asarray(setup.stencil.cosphm1_pt, np.float64)
        grads = np.zeros((setup.n_pad + 1, 8))
        grads[:-1, 0] = g["ddphi"]
        grads[:-1, 1] = g["ddlam"] * dco
        if cur:
            grads[:-1, 2] = g["duphi"]
            grads[:-1, 3] = g["dvphi"]
            grads[:-1, 4] = g["dulam"] * dco
            grads[:-1, 5] = g["dvlam"] * dco
            if setup.irefra == 3:
                grads[:-1, 6] = (v_ext[:-1] * g["ddphi"]
                                 + u_ext[:-1] * g["ddlam"] * dco)
        self.tabs["grads"] = self._t(grads[src])
        if cur:
            # CFL current retry (ctuw.F90:114-123): drop the current terms
            # wherever a pass with them would break the CFL condition,
            # tested by the pass on a zero spectrum
            _, bad = self._pass(self._zero_srl(), self.nfre_red, self.lc,
                                with_cfl=True)
            self.cfl_bad = bad                 # SRL rows whose currents drop
            self.tabs["grads"][:, 2:7] *= (~bad).to(self.dtype)[:, None]

    def _t(self, a):
        return torch.as_tensor(np.asarray(a), dtype=self.dtype,
                               device=self.device)

    def _zero_srl(self):
        return torch.zeros((self.ft.nsrl, self.L), dtype=self.dtype,
                           device=self.device)

    def build_phys_srl(self, frc, stress):
        """The SRL-ordered physics inputs.

        Returns (env2d, denv, frc6, stress6):
          env2d (3·nfre, nsrl)  dispersion env rows (static per depth)
          denv  (2, nsrl)       depth/emaxdpt rows (static)
          frc6  (6, nsrl)       forcing rows (rebuilt per wind date)
          stress6 (6, nsrl)     stress-state rows (carried step to step)
        Land/pad rows read the land slot or point 0 (finite — NaNs there
        would leak through the advection FIR taps as 0·NaN).
        """
        env, src = self.setup.env, self.tabs["srl_src"]
        env2d = torch.cat([env[k + "_ext"][:, src] for k in ipk.ENV_FIELDS])
        denv = torch.stack([env["depth_ext"][src], env["emaxdpt_ext"][src]])
        return env2d, denv, self.frc_srl(frc), self.stress_srl(stress)

    def stress_srl(self, stress):
        """Stress-state rows (6, nsrl) in SRL order from the STRESS_KEYS
        fields, each (n_pad,) numpy or a tensor on any device; the land
        slot replicates point 0."""
        return _rows({k: torch.as_tensor(stress[k], dtype=self.dtype,
                                         device=self.device)
                      for k in ipk.STRESS_KEYS}, ipk.STRESS_KEYS,
                     self.tabs["srl_src"])

    def frc_srl(self, frc):
        """Forcing rows (6, nsrl) in SRL order (NEWWIND update); absent
        fields are zero, the land slot replicates point 0."""
        zero = torch.zeros_like(frc["wswave"])
        full = {k: frc.get(k, zero) for k in ipk.SCAL_IN[:ipk.N_FRC]}
        return _rows(full, ipk.SCAL_IN[:ipk.N_FRC], self.tabs["srl_src"])

    def initial_srl(self, wswave, wdwave, *, fetch: float = 50000.0,
                    frmax: float = 0.2, zgamma: float = 3.0,
                    sa: float = 0.07, sb: float = 0.09, chunk: int = 65536):
        """JONSWAP cold start (MSTART IOPTI=1, mstart.F90:49-80) built
        straight into the SRL layout on the device.

        The per-point JONSWAP and spreading vectors come from
        :mod:`wavebench.reference.ecw.model.preset` on the host (float64,
        (nsrl, nfre) and (nsrl, nang)); their outer product — the full
        spectrum — is formed on the device in float64, chunked over rows,
        and cast.  The result
        equals the reference's host MSTART gathered into the SRL.

        Returns (f_srl, tail) with ``tail`` None when nfre_red == nfre.
        """
        tb = self.setup.tb
        src = np.asarray(self.ft.srl_src)
        ws = np.concatenate([np.asarray(wswave, np.float64), [0.0]])[src]
        wd = np.concatenate([np.asarray(wdwave, np.float64), [0.0]])[src]
        fp, alphaj = preset_mod.peak(ws, fetch, frmax)
        et = torch.as_tensor(
            preset_mod.jonswap_1d(tb.fr, fp, alphaj, zgamma, sa, sb),
            device=self.device)
        st = torch.as_tensor(preset_mod.spread(tb.th, wd), device=self.device)
        nsrl, nred = src.shape[0], self.nfre_red
        f_srl = torch.empty((nsrl, self.L), dtype=self.dtype,
                            device=self.device)
        tail = (torch.empty((nsrl, self.LT), dtype=self.dtype,
                            device=self.device) if self.LT else None)
        for c0 in range(0, nsrl, chunk):
            rows = slice(c0, min(nsrl, c0 + chunk))
            spec = st[rows, :, None] * et[rows, None, :]   # (C, nang, nfre)
            f_srl[rows] = spec[:, :, :nred].reshape(-1, self.L)
            if tail is not None:
                tail[rows] = spec[:, :, nred:].reshape(-1, self.LT)
        return f_srl, tail

    def phys_srl(self, f_srl, stress6, frc6, denv, env2d, tail=None):
        """One minimal-mode physics step on SRL-resident state (the
        counterpart of ``phys_srl_pallas``); runs on all SRL rows (wrap
        duplicates compute identical results, pads are finite garbage that
        the advection valid-mask never reads).  Output dates take
        :meth:`phys_srl_full_chunked`.

        Returns (f_srl, stress6, tail)."""
        cfg = ipk.minimal_config(self.setup.phys)
        scal = torch.cat([frc6, denv, stress6])
        kw = dict(nang=self.nang, nfre_red=self.nfre_red)
        return ipk.implsch_srl_plain(cfg, f_srl, env2d, scal, tail, **kw)

    def phys_srl_full_chunked(self, f_srl, stress6, frc6, denv, env2d,
                              tail=None, *, chunk: int = 65536):
        """The output-date physics step: full mode chunked over SRL rows
        (:func:`full_chunked_rows`), updating ``f_srl``/``tail`` in place.

        Returns (f_srl, stress6, tail, state) with ``state`` carrying the
        SCAL_OUT_FULL rows plus ``sep`` (the windsea/swell rows); the
        per-bin swell spectrum is not kept."""
        scal = torch.cat([frc6, denv, stress6])
        f_srl, tail, state = full_chunked_rows(
            self.setup.phys, self.setup.tb, f_srl, tail, scal, env2d,
            nang=self.nang, nfre_red=self.nfre_red, chunk=chunk)
        stress6 = torch.stack([state[k].to(f_srl.dtype)
                               for k in ipk.STRESS_KEYS])
        return f_srl, stress6, tail, state

    def extract_state(self, rows):
        """Gather canonical points of SRL-ordered per-point rows
        (…, nsrl) → (…, n_pad)."""
        return rows[..., self.from_srl_pad]

    # -- layout ----------------------------------------------------------
    def to_srl(self, fl1):
        """Compact (nang, nfre, n_pad) spectrum → SRL (nsrl, L)."""
        fll = pfz.to_lanes(fl1, self.nfre_red, self.nang)
        fll = torch.cat([fll, fll.new_zeros((1, self.L))])
        return fll[self.tabs["srl_src"]]

    def from_srl(self, f_srl):
        """SRL state → compact (nang, nfre_red, n_pad) spectrum."""
        return pfz.from_lanes(f_srl[self.from_srl_pad], self.nfre_red,
                              self.nang)

    # -- advection -------------------------------------------------------
    def advect_srl(self, f_srl):
        """One full advection step on SRL-resident state; refreshes the
        wrap slots of ``f_srl`` in place first."""
        return self._substeps(pfz.refresh_wraps(f_srl, self.tabs))

    def advect(self, fl1):
        """One full advection step on the compact (nang, nfre, n_pad)
        spectrum, incl. fast-wave substeps."""
        out = self.from_srl(self._substeps(self.to_srl(fl1)))
        if self.nfre_red < fl1.shape[1]:
            out = torch.cat([out, fl1[:, self.nfre_red:]], dim=1)
        return out

    def _pass(self, f_srl, nf, lc, nw=None, with_cfl=False):
        return pcu.advect_plain(f_srl, self.tabs, lc, nang=self.nang,
                                nf=nf, S=self.ft.S, EW=self.ft.EW,
                                irefra=self.setup.irefra, nw=nw,
                                with_cfl=with_cfl)

    def advect_pass(self, f_srl, i: int):
        """Pass ``i`` of an advection step (0: all bands, then the nsub−1
        fast-wave sub-band passes) on ``f_srl`` with its wraps fresh."""
        if i == 0:
            return self._pass(f_srl, self.nfre_red, self.lc)
        return self._pass(f_srl, self.mlf_w, self.lc_lo, nw=self.mlf)

    def _substeps(self, f_srl):
        """Main all-band pass + the extra fast-wave sub-band passes.

        The sub-band is the per-direction frequency prefix [:, :, :mlf]
        (k-major lanes); the pass advects those lanes (computing mlf_w)
        and carries the others through.  Wraps are refreshed on all lanes
        before each sub-band pass, so the wrap rows of the high band hold
        copies rather than zeros afterwards; nothing reads them before the
        next step's refresh."""
        f_srl = self.advect_pass(f_srl, 0)
        for i in range(1, self.nsub):
            f_srl = pfz.refresh_wraps(f_srl, self.tabs)
            f_srl = self.advect_pass(f_srl, i)
        return f_srl


def _rows(fields: dict, keys, src):
    """(len(keys), nsrl) rows of (n_pad,) fields in SRL order; the land
    slot replicates point 0 (benign, finite)."""
    return torch.stack([torch.cat([fields[k], fields[k][:1]])[src]
                        for k in keys])
