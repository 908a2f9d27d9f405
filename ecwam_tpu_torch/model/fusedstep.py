"""Fused propagation + SRL-resident physics steps.

Port of ``ecwam_tpu/model/fusedstep.py: FusedPropagation`` and
``full_chunked_rows``.  The spectrum lives in the
segmented row layout (SRL, :mod:`ecwam_tpu_torch.ops.propagation_fused`);
each advection step refreshes the row-wrap slots and runs one all-band CTU
pass plus the extra fast-wave sub-band passes (propag_wam.F90:247-313),
and each physics step runs the fused IMPLSCH chain on every SRL row: in
minimal mode between output dates, and at output dates in full mode,
chunked over rows, with each chunk's windsea mask consumed at once by
the windsea/swell separation.

Both operators go through their kernel wrappers
(:func:`ecwam_tpu_torch.ops.propagation_cuda.advect`,
:func:`ecwam_tpu_torch.ops.physics.implsch_cuda.implsch_srl`): the CUDA
kernels for tensors on the card, the plain versions for tensors on the
CPU.  ``plain=True`` runs the plain versions on any device — the
reference the kernels are held against on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from ecwam_tpu_torch.io import products as products_mod
from ecwam_tpu_torch.model import preset as preset_mod
from ecwam_tpu_torch.ops import propagation as prop
from ecwam_tpu_torch.ops import propagation_cuda as pcu
from ecwam_tpu_torch.ops import propagation_fused as pfz
from ecwam_tpu_torch.ops import propagation_rebase as prb
from ecwam_tpu_torch.ops.physics import implsch_cuda as ipk
from ecwam_tpu_torch.tracing import set_counter, span


# windsea/swell separation keys precomputed by the chunked full step
SEP_KEYS = ("eswell", "fswell", "thswell", "p1swell", "p2swell",
            "sprdswell", "esea", "fsea", "thwisea", "p1sea", "p2sea",
            "sprdsea")


def full_chunked_rows(cfg, tb, f_srl, tail, scal_all, env2d, *,
                      nang: int, nfre_red: int, chunk: int = 65536,
                      plain: bool = False, tables_dev: dict | None = None):
    """Full-mode physics over SRL rows in chunks of ``chunk`` rows, in
    place: each chunk's windsea mask xllws (nang, nfre, rows) goes
    straight into the windsea/swell separation
    (:func:`ecwam_tpu_torch.io.products.sepwisw`) and is dropped, so a
    whole-field mask (2.4 GB at O320) never exists.

    Runs kernel B in full mode (:func:`implsch_cuda.implsch_srl`), or its
    plain version with ``plain=True`` (and for CPU tensors).  Returns
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
        if plain:
            f_new, so, t_new, xllws = ipk.implsch_srl_plain(
                cfg, f_c, env_c, scal_c, t_c, nang=nang, nfre_red=nfre_red,
                full=True)
        else:
            f_new, so, t_new, xllws = ipk.implsch_srl(
                cfg, f_c, env_c, scal_c, t_c, nang=nang, nfre_red=nfre_red,
                full=True, tables_dev=tables_dev)
        if f_new is not f_c:                   # the plain version's copy
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
    """Static tables of the fused step for one domain, on the setup's
    device.

    ``ft``/``fused_env`` give another domain's tables in place of the
    setup's (a shard of :mod:`ecwam_tpu_torch.parallel.sharded`: its
    ``srl_src`` indexes the setup's compact points, its ``from_srl`` each
    of its ``npts`` layout slots), ``device`` another device."""

    def __init__(self, setup, *, plain: bool = False, ft=None,
                 fused_env: dict | None = None, device=None):
        self.setup = setup
        self.ft = ft = setup.fused if ft is None else ft
        self.plain = plain
        tb = setup.tb
        self.nang, self.nfre_red = tb.nang, tb.nfre_red
        self.L = self.nang * self.nfre_red
        self.LT = self.nang * (tb.nfre - tb.nfre_red)
        dt = setup.dtype
        device = setup.device if device is None else torch.device(device)
        self.dtype, self.device = dt, device

        def t(a):
            return torch.as_tensor(np.asarray(a), dtype=dt, device=device)
        fe = setup.fused_env if fused_env is None else fused_env
        tabs = pfz.device_tables(ft, dt, device)
        tabs.update(cg_srl=t(fe["cg_srl"]), cg_land=t(fe["cg_land"]))
        tabs.update(prb.kernel_tables(prb.rebase(ft), dt, device))
        if setup.irefra:
            tabs["pf"] = t(fe["pf"])
        fs = np.asarray(ft.from_srl)
        n_out = setup.n_pad if ft is setup.fused else ft.npts
        pad = np.full(n_out - ft.npts, fs[0] if fs.size else 0)
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
        self.phys_tables = None
        self.cfl_bad = None
        self._gradi = self._depth_grads = None
        if setup.irefra:
            self._static_gradients()
        self.refresh()

    # -- LUPDTWGHT / GETCURR --------------------------------------------
    def _static_gradients(self):
        """The refraction inputs that depth alone fixes, once, on the host
        in float64 (GRADI, :func:`prop.gradi`): the depth gradients
        (columns 0-1 of ``tabs["grads"]``, irefra 1/3; zero under irefra
        2).  With currents (irefra 2/3) also GRADI's stencil gathered to
        the SRL rows on the device (:func:`prop.gradi_stencil`), and for
        irefra 3 the depth gradients in float64 there, for ω·∂d."""
        setup = self.setup
        st, src = setup.stencil, np.asarray(self.ft.srl_src)
        nz = np.zeros(setup.n_pad + 1)
        g = prop.gradi(st, setup.fused_env["depth_ext"], nz, nz,
                       1 if setup.irefra in (1, 3) else 0)
        dco = np.asarray(st.cosphm1_pt, np.float64)
        grads = np.zeros((setup.n_pad + 1, 8))
        grads[:-1, 0] = g["ddphi"]
        grads[:-1, 1] = g["ddlam"] * dco
        self.tabs["grads"] = self._t(grads[src])
        if setup.irefra in (2, 3):
            self._gradi = prop.gradi_stencil(st, src, self.device)
        if setup.irefra == 3:
            self._depth_grads = torch.as_tensor(
                np.stack([np.append(g[k], 0.0)[src]
                          for k in ("ddphi", "ddlam")]),
                dtype=torch.float64, device=self.device)

    def refresh(self, ucur=None, vcur=None):
        """GETCURR → LUPDTWGHT with current refraction (irefra 2/3; a
        no-op otherwise: the depth gradients never change and were set
        once): the current field ``uv``, its gradients (GRADI with the
        reference's land fallbacks and clip) and ω·∂d (irefra 3) into
        columns 2-6 of ``tabs["grads"]``, in place, then the CFL current
        retry.  ``ucur``/``vcur`` are compact (n_pad,) fields, tensors on
        any device or host arrays (GETCURR); None takes the setup's.

        Everything runs on this object's device: GRADI in float64 at the
        SRL rows (:func:`prop.gradi_rows`, the host's arithmetic), cast
        once to the table's dtype, then one CFL pass of kernel A (the
        plain pass on the CPU).  Given tensors on the device, it neither
        copies to or from the host nor waits for the device; the number
        of rows the retry dropped goes to the ``cfl_dropped_rows``
        counter unread."""
        if self._gradi is None:
            return
        with span("refresh.gradi", self.device):
            self._current_gradients(self._ext(ucur, "ucur_ext"),
                                    self._ext(vcur, "vcur_ext"))
        with span("refresh.cfl", self.device):
            # CFL current retry (ctuw.F90:114-123): drop the current terms
            # wherever a pass with them would break the CFL condition,
            # tested by kernel A (or the plain pass) on a zero spectrum
            _, bad = self._pass(self._zero_srl(), self.nfre_red, self.lc,
                                with_cfl=True)
            self.cfl_bad = bad                 # SRL rows whose currents drop
            self.tabs["grads"][:, 2:7] *= (~bad).to(self.dtype)[:, None]
        set_counter("cfl_dropped_rows", bad.sum())

    def _ext(self, a, key):
        """A compact (n_pad,) current field, or the setup's (``key``), as
        the (n_pad+1,) float64 ext layout (land slot 0) on this device."""
        if a is None:
            return self.setup.env[key].to(self.device, torch.float64)
        t = torch.as_tensor(a, device=self.device)[:self.setup.n_pad]
        t = t.to(torch.float64)
        return torch.cat([t, t.new_zeros(1)])

    def _current_gradients(self, u_ext, v_ext):
        """``tabs["uv"]`` and columns 2-6 of ``tabs["grads"]`` from the
        (n_pad+1,) float64 currents, in float64 at the SRL rows and cast
        once (the host's order of operations: the table equals its
        columns to the bit)."""
        src, dco = self.tabs["srl_src"], self._gradi.dco
        u, v = u_ext[src], v_ext[src]
        self.tabs["uv"] = torch.stack([u, v], -1).to(self.dtype)
        g = prop.gradi_rows(self._gradi, u_ext, v_ext)
        cols = [g["duphi"], g["dvphi"], g["dulam"] * dco, g["dvlam"] * dco]
        if self._depth_grads is not None:
            # ω·∂d (irefra 3)
            ddphi, ddlam = self._depth_grads
            cols.append(v * ddphi + u * ddlam * dco)
        self.tabs["grads"][:, 2:2 + len(cols)] = torch.stack(cols, -1)

    def _t(self, a):
        return torch.as_tensor(np.asarray(a), dtype=self.dtype,
                               device=self.device)

    def _zero_srl(self):
        return torch.zeros((self.ft.nsrl, self.L), dtype=self.dtype,
                           device=self.device)

    def cfl_diagnostics(self) -> dict:
        """CHECKCFL equivalent (checkcfl.F90:74-210): the largest Courant
        numbers of the east/west, north/south and total-outflow terms and
        the count of violating points, from one pass on a zero spectrum.
        With current refraction the offending current terms were already
        zeroed by the CFL retry (LLCFLCUROFF), so what remains are genuine
        reduce-IDELPRO errors."""
        _, bad, (rx, ry, rs) = self._pass(self._zero_srl(), self.nfre_red,
                                          self.lc, with_cfl="stats")
        return dict(cfl_east_west=float(rx), cfl_north_south=float(ry),
                    max_outflow=float(rs), n_violations=int(bad.sum()))

    # -- SRL-resident physics -------------------------------------------
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
        :mod:`ecwam_tpu_torch.model.preset` on the host (float64,
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

    def _tables(self, f_srl):
        """The kernel's device tables, packed once (the same for both
        modes)."""
        if f_srl.device.type == "cuda" and self.phys_tables is None:
            self.phys_tables = ipk.pack_tables(self.setup.phys, f_srl.device)
        return self.phys_tables

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
        if self.plain:
            return ipk.implsch_srl_plain(cfg, f_srl, env2d, scal, tail, **kw)
        return ipk.implsch_srl(cfg, f_srl, env2d, scal, tail,
                               tables_dev=self._tables(f_srl), **kw)

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
            nang=self.nang, nfre_red=self.nfre_red, chunk=chunk,
            plain=self.plain, tables_dev=self._tables(f_srl))
        stress6 = torch.stack([state[k].to(f_srl.dtype)
                               for k in ipk.STRESS_KEYS])
        return f_srl, stress6, tail, state

    def phys_srl_chunked(self, f_srl, frc, stress, env, *, chunk: int,
                         tail=None, state_keys=ipk.STRESS_KEYS):
        """One minimal-mode physics step on SRL-resident state, a chunk of
        canonical points at a time (the counterpart of the reference's
        ``phys_srl_chunked``, without its ``bundle``: the tables are this
        object's).

        ``frc``, ``stress`` and ``env`` are the compact (n_pad,) forcing
        and stress fields and the setup's ``env`` (``depth``,
        ``emaxdpt``, and the (nfre, n_pad) ``wavnum``, ``cinv``,
        ``xk2cg``).  Each chunk gathers its points' rows (and tail rows)
        out of the SRL buffer, runs kernel B in minimal mode on them (its
        plain version on the CPU or with ``plain``), and writes them back
        in place; the wrap slots are then refreshed from the canonical
        rows (pad rows keep their finite values).  Returns ``(f_srl,
        acc)``, or ``(f_srl, tail, acc)`` with a tail, ``acc`` the
        ``state_keys`` fields (n_pad,) of the step (pad points replicate
        point 0, as :meth:`extract_state`); minimal mode computes the
        stress keys only."""
        bad = set(state_keys) - set(ipk.STRESS_KEYS)
        if bad:
            raise ValueError(f"minimal-mode physics has no {sorted(bad)}")
        if (tail is None) != (self.LT == 0):
            raise ValueError("tail block required iff nfre > nfre_red")
        setup = self.setup
        cfg = ipk.minimal_config(setup.phys)
        zero = torch.zeros_like(torch.as_tensor(frc["wswave"]))
        fields = [frc.get(k, zero) for k in ipk.SCAL_IN[:ipk.N_FRC]]
        fields += [env["depth"], env["emaxdpt"]]
        fields += [stress[k] for k in ipk.STRESS_KEYS]
        scal = torch.stack([torch.as_tensor(v, dtype=self.dtype,
                                            device=self.device)
                            for v in fields])
        env2d = torch.cat([torch.as_tensor(env[k], dtype=self.dtype,
                                           device=self.device)
                           for k in ipk.ENV_FIELDS])
        kw = dict(nang=self.nang, nfre_red=self.nfre_red)
        npts = self.ft.npts
        rows6 = f_srl.new_empty((len(ipk.STRESS_KEYS), setup.n_pad))
        for s in range(0, npts, chunk):
            pts = slice(s, min(npts, s + chunk))
            rows = self.from_srl_pad[pts]
            args = (cfg, f_srl[rows], env2d[:, pts].contiguous(),
                    scal[:, pts].contiguous(),
                    tail[rows] if tail is not None else None)
            if self.plain:
                f_c, so, t_c = ipk.implsch_srl_plain(*args, **kw)
            else:
                f_c, so, t_c = ipk.implsch_srl(
                    *args, tables_dev=self._tables(f_srl), **kw)
            f_srl[rows] = f_c
            if tail is not None:
                tail[rows] = t_c
            rows6[:, pts] = so
        rows6[:, npts:] = rows6[:, :1]
        pfz.refresh_wraps(f_srl, self.tabs)
        acc = {k: rows6[ipk.STRESS_KEYS.index(k)] for k in state_keys}
        return (f_srl, acc) if tail is None else (f_srl, tail, acc)

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
        fn = pcu.advect_plain if self.plain else pcu.advect
        return fn(f_srl, self.tabs, lc, nang=self.nang, nf=nf, S=self.ft.S,
                  EW=self.ft.EW, irefra=self.setup.irefra, nw=nw,
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
