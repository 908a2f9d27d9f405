"""Time-step functions of the dense ``WaveModel``: the WAMINTGR equivalent.

Port of ``ecwam_tpu/model/stepper.py``.  One advection step
(wamintgr.F90:94-186) advects the first nfre_red frequencies, with the
fast-wave sub-steps for m < ifrelfmax (propag_wam.F90:247-313), in one of
three weight modes:

  * ``cached``: the CTU weights are built once (and again when the
    currents change) and stay resident, as the reference caches them
    behind LUPDTWGHT (propag_wam.F90:221-236) — 17 planes per bin, 19 with
    σ̇ shifting.  They are assembled a few frequencies at a time into
    preallocated planes, so that no full-size temporary of CTUW's exists
    beside them;
  * ``otf``: the weights are recomputed every step per block of
    ``otf_block`` frequencies (propags1.F90-style on-the-fly fluxes);
  * ``fused``: kernel A through ``FusedPropagation.advect``, the compact
    round trip through the SRL layout.

In every mode the physics runs in full mode on every physics step through
kernel C (:func:`implsch_cuda.implsch_compact`), over the whole point
axis or in NPROMA chunks of ``phys_chunk`` points (mchunk.F90:44-45), each
chunk a view of the spectrum (no copy) updated in place.  ``plain=True``
runs the plain versions on the card instead (for the checks); on the CPU
the wrappers run them anyway.  The cached/otf advection (CTUW, PROPAGS2)
is plain PyTorch in both packages' sense: the reference runs it as XLA
code outside any Pallas kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from ecwam_tpu_torch.core import constants as c
from ecwam_tpu_torch.core import physparams as pp
from ecwam_tpu_torch.ops import propagation as prop
from ecwam_tpu_torch.ops.physics import implsch_cuda as ipk

# frequencies of one block when the cached weights are assembled
CACHED_BLOCK = 4


def stencil_device_arrays(setup) -> dict:
    """The stencil's tables as tensors on the setup's device (indices
    int64, weights in the model dtype)."""
    return prop.stencil_tensors(setup.stencil, setup.dtype, setup.device)


def _with_land(f):
    """(…, n) → (…, n+1) with the land slot's zero appended."""
    return torch.cat([f, f.new_zeros(f.shape[:-1] + (1,))], dim=-1)


def _refraction(setup, wenv, stencil=None) -> dict:
    """PROPDOT's rates and the refraction inputs of CTUW, or {} without
    refraction; ``stencil`` (numpy) is the domain's, the setup's by
    default."""
    if not setup.irefra:
        return {}
    nfr = setup.tb.nfre_red
    thdd, thdc, sdot = prop.propdot(
        setup.stencil if stencil is None else stencil, setup.tb,
        wenv["wavnum_ext"][:nfr],
        wenv["cgroup_ext"][:nfr], wenv["omosnh2kd_ext"][:nfr],
        wenv["depth_ext"], wenv["ucur_ext"], wenv["vcur_ext"], setup.irefra)
    return dict(thdd=thdd, thdc=thdc, sdot=sdot,
                omosnh2kd_ext=wenv["omosnh2kd_ext"][:nfr],
                u_ext=wenv["ucur_ext"], v_ext=wenv["vcur_ext"])


def _masked_currents(setup, refr: dict, fail) -> dict:
    """The CFL current retry (ctuw.F90:114-123): the current terms zeroed
    at the points whose weights broke the CFL condition with them."""
    curmask = 1.0 - fail.to(setup.dtype)
    return dict(refr, thdc=refr["thdc"] * curmask[None, :],
                sdot=refr["sdot"] * curmask[None, None, :])


def _bands(setup):
    """The cached weights' frequency windows [(mstart, mend, delpro)]: the
    fast-wave band (with σ̇ shifting one extra frequency for the band-edge
    m+1 read, propag_wam.F90:262) and the rest, or all nfre_red."""
    nfr = setup.tb.nfre_red
    if setup.ifrelfmax > 0:
        mw = (setup.ifrelfmax + 1 if setup.irefra in (2, 3)
              else setup.ifrelfmax)
        return [(0, mw, setup.delpro_lf),
                (setup.ifrelfmax, nfr, setup.idelpro)]
    return [(0, nfr, setup.idelpro)]


def _band_weights(setup, st, cg_ext, refr, m0, m1, delpro, *,
                  keep: bool = True, block: int = CACHED_BLOCK):
    """The weights of window [m0, m1), built ``block`` frequencies at a
    time into one preallocated (n_slots, nang, m1−m0, n) tensor (or, with
    ``keep`` false, only their CFL mask: each block is dropped)."""
    w = (torch.empty((prop.n_slots(setup.irefra), setup.tb.nang, m1 - m0,
                      st["klon"].shape[0]), dtype=setup.dtype,
                     device=cg_ext.device)
         if keep else None)
    fail = None
    for b0 in range(m0, m1, block):
        b1 = min(m1, b0 + block)
        wb = prop.ctuw_weights(
            delpro, st, setup.tb, cg_ext, irefra=setup.irefra, mstart=b0,
            mend=b1, out=None if w is None else w[:, :, b0 - m0:b1 - m0],
            **refr)
        fail = wb["cflfail"] if fail is None else fail | wb["cflfail"]
    return prop.weight_views(w, m0, m1, fail) if keep else fail


def _compute_weights(setup, st, cg_ext, wenv, stencil=None):
    """CTUWUPDT equivalent (ctuwupdt.F90:185-215): the weights of each
    band (:func:`_bands`).  With current refraction a CFL failure triggers
    the reference's retry with the current terms dropped at the failing
    points (ctuw.F90:114-123); the first pass keeps only its mask.
    ``st``/``cg_ext``/``wenv`` are the domain's tensors over its ext
    layout, ``stencil`` its numpy tables (the setup's by default)."""
    refr = _refraction(setup, wenv, stencil)
    bands = _bands(setup)
    if setup.irefra in (2, 3):
        fail = None
        for m0, m1, dtp in bands:
            f = _band_weights(setup, st, cg_ext, refr, m0, m1, dtp,
                              keep=False)
            fail = f if fail is None else fail | f
        refr = _masked_currents(setup, refr, fail)
    return tuple(_band_weights(setup, st, cg_ext, refr, m0, m1, dtp)
                 for m0, m1, dtp in bands)


def propagate(setup, weights, fl1, st):
    """One full advection step over all sub-bands (propag_wam.F90:240-330)
    with the cached weights.  Only the first nfre_red frequencies advect
    (physics integrates all nfre)."""
    tb = setup.tb
    nfre_red = tb.nfre_red
    out = torch.empty(fl1.shape, dtype=fl1.dtype, device=fl1.device)
    out[:, nfre_red:] = fl1[:, nfre_red:]
    if setup.ifrelfmax > 0:
        w_lf, w_hf = weights
        nsub = max(1, round(setup.idelpro / setup.delpro_lf))
        mlf = setup.ifrelfmax
        mw = mlf + 1 if setup.irefra in (2, 3) else mlf
        prop.propags2(_with_land(fl1[:, mlf:nfre_red]), w_hf, st, tb,
                      out=out[:, mlf:nfre_red])
        lf_win = fl1[:, :mw]
        for _ in range(nsub):
            lf = prop.propags2(_with_land(lf_win), w_lf, st, tb)[:, :mlf]
            # band-edge extra frequency: the once-advected high-band value
            # (propag_wam.F90:276-283 FL1=FL3 copy)
            lf_win = (torch.cat([lf, out[:, mlf:mlf + 1]], dim=1)
                      if mw > mlf else lf)
        out[:, :mlf] = lf
    else:
        (w,) = weights
        prop.propags2(_with_land(fl1[:, :nfre_red]), w, st, tb,
                      out=out[:, :nfre_red])
    return out


def _otf_blocks(setup):
    """Frequency-block windows [(mstart, mend, delpro, nsub), ...] that
    never straddle the fast-wave band boundary."""
    nfre_red = setup.tb.nfre_red
    bs = max(1, setup.otf_block)
    nsub = (max(1, round(setup.idelpro / setup.delpro_lf))
            if setup.ifrelfmax > 0 else 1)
    blocks = []
    for lo, hi, dtp, ns in (((0, setup.ifrelfmax, setup.delpro_lf, nsub),)
                            if setup.ifrelfmax > 0 else ()) + \
            ((setup.ifrelfmax, nfre_red, setup.idelpro, 1),):
        m = lo
        while m < hi:
            blocks.append((m, min(m + bs, hi), dtp, ns))
            m += bs
    return blocks


def propagate_otf(setup, fl1, st, cg_ext, wenv):
    """Advection with the weights recomputed per frequency block every
    step: no more than a block's weights exist at a time.  With σ̇
    shifting (irefra 2/3) a block carries one frequency of overlap on each
    side, so that the shift stencil sees its true neighbours."""
    tb = setup.tb
    nfre_red = tb.nfre_red
    refr = _refraction(setup, wenv)
    blocks = _otf_blocks(setup)

    def wgt(m0, m1, dtp, refr_):
        return prop.ctuw_weights(dtp, st, tb, cg_ext, mstart=m0, mend=m1,
                                 irefra=setup.irefra, **refr_)

    if setup.irefra in (2, 3):
        # the CFL current retry needs the global failure mask first
        fail = None
        for m0, m1, dtp, _ in blocks:
            f = wgt(m0, m1, dtp, refr)["cflfail"]
            fail = f if fail is None else fail | f
        refr = _masked_currents(setup, refr, fail)

    shift = setup.irefra in (2, 3)
    out = torch.empty(fl1.shape, dtype=fl1.dtype, device=fl1.device)
    out[:, nfre_red:] = fl1[:, nfre_red:]
    for m0, m1, dtp, nsub in blocks:
        e0 = max(0, m0 - 1) if shift else m0
        e1 = min(nfre_red, m1 + 1) if shift else m1
        w = wgt(e0, e1, dtp, refr)
        f = fl1[:, e0:e1]
        for _ in range(nsub):
            f = prop.propags2(_with_land(f), w, st, tb)
        out[:, m0:m1] = f[:, m0 - e0:m0 - e0 + (m1 - m0)]
        del w
    return out


def physics_env(setup) -> torch.Tensor:
    """The (3·nfre, n_pad) env rows the physics step reads (wavnum, cinv,
    xk2cg)."""
    return torch.cat([setup.env[k] for k in ipk.ENV_FIELDS]).contiguous()


def physics_scal(setup, frc: dict, stress: dict,
                 env: dict | None = None) -> torch.Tensor:
    """The (14, n) SCAL_IN rows: forcing (absent fields zero), depth
    and emaxdpt (of ``env``, the setup's by default), the stress state."""
    env = setup.env if env is None else env
    zero = torch.zeros_like(frc["wswave"])
    rows = [frc.get(k, zero) for k in ipk.SCAL_IN[:ipk.N_FRC]]
    rows += [env["depth"], env["emaxdpt"]]
    rows += [stress[k] for k in ipk.STRESS_KEYS]
    return torch.stack([r.to(setup.dtype) for r in rows])


def _chunked_implsch(setup, fl1, env2d, frc, stress, *, plain: bool,
                     tables, env: dict | None = None):
    """One full-mode physics step on ``fl1`` in place (on a contiguous copy
    if it is not), over NPROMA chunks of ``phys_chunk`` points
    (mchunk.F90:44-45) where that divides the point axis (else in one
    piece), each chunk a view of the spectrum.  Returns (fl1, state): the
    SCAL_OUT_FULL rows as fields (and under u* ``wswave``) plus the
    windsea mask ``xllws``.  ``env`` holds the domain's depth/emaxdpt
    (the setup's by default)."""
    cfg = setup.phys
    fl1 = fl1.contiguous()
    scal = physics_scal(setup, frc, stress, env)
    n = fl1.shape[-1]
    C = setup.phys_chunk
    if not C or n % C != 0 or n == C:
        C = n
    rows, masks = [], []
    for s in range(0, n, C):
        f = fl1[..., s:s + C]
        e = env2d if C == n else env2d[:, s:s + C].contiguous()
        sc = scal if C == n else scal[:, s:s + C].contiguous()
        if plain:
            r = ipk.implsch_compact_plain(cfg, f, e, sc, full=True)
            f.copy_(r[0])
        else:
            r = ipk.implsch_compact(cfg, f, e, sc, full=True,
                                    tables_dev=tables, out=f)
        rows.append(r[1])
        masks.append(r[2])
    state = ipk.unpack_scal_out(torch.cat(rows, dim=1) if len(rows) > 1
                                else rows[0], full=True)
    state["xllws"] = torch.cat(masks, dim=-1) if len(masks) > 1 \
        else masks[0]
    return fl1, state


class StepBundle:
    """The step functions + the GETCURR/LUPDTWGHT hook.

    Unpacks like the historical 3-tuple:
        step_full, step_adv, step_phys = make_step(setup)
    and exposes ``refresh_currents(uc, vc)``, which installs new (n_pad,)
    surface currents and re-derives the cached CTU weights (getcurr.F90 →
    LUPDTWGHT → CTUWUPDT; in OTF mode the weights are recomputed every step
    so only the env updates), and ``cfl_diagnostics`` (fused mode: the
    CHECKCFL numbers, else None).  ``phys_inplace(fl1, frc, stress)`` is
    ``step_phys`` on a spectrum it may overwrite.
    """

    def __init__(self, step_full, step_adv, step_phys, refresh_currents,
                 cfl_diagnostics=None, phys_inplace=None):
        self.step_full = step_full
        self.step_adv = step_adv
        self.step_phys = step_phys
        self.refresh_currents = refresh_currents
        self.cfl_diagnostics = cfl_diagnostics
        self.phys_inplace = phys_inplace

    def __iter__(self):
        return iter((self.step_full, self.step_adv, self.step_phys))


def make_step(setup, *, plain: bool = False) -> StepBundle:
    """The step functions of ``setup``'s weight mode.  ``step_adv(fl1)``
    advects, ``step_phys(fl1, frc, stress)`` runs one full-mode physics
    step and ``step_full`` both; each returns new tensors (the physics
    state with the spectrum).  ``plain=True`` runs the plain versions of
    kernels A and C on the card."""
    st = stencil_device_arrays(setup)
    env2d = physics_env(setup)
    cg_ext = setup.env["cgroup_ext"][: setup.tb.nfre_red]
    wenv_keys = ("wavnum_ext", "cgroup_ext", "omosnh2kd_ext", "depth_ext",
                 "ucur_ext", "vcur_ext")
    wenv = {k: setup.env[k] for k in wenv_keys}
    tables = (ipk.pack_tables(setup.phys, setup.device)
              if setup.device.type == "cuda" and not plain else None)

    def phys_inplace(fl1, frc, stress):
        return _chunked_implsch(setup, fl1, env2d, frc, stress, plain=plain,
                                tables=tables)

    def step_phys(fl1, frc, stress):
        return phys_inplace(fl1.clone(memory_format=torch.contiguous_format),
                            frc, stress)

    def currents_ext(uc, vc):
        z = torch.zeros(1, dtype=setup.dtype, device=setup.device)
        for k, v in (("ucur_ext", uc), ("vcur_ext", vc)):
            wenv[k] = torch.cat([torch.as_tensor(
                v, dtype=setup.dtype, device=setup.device)[:setup.n_pad], z])

    cfl = None
    if setup.weights_mode == "fused":
        from ecwam_tpu_torch.model.fusedstep import FusedPropagation
        fp = FusedPropagation(setup, plain=plain)
        cfl = fp.cfl_diagnostics

        def step_adv(fl1):
            # the compact layout back (kernel C reads points contiguous)
            return fp.advect(fl1).contiguous()

        def refresh_currents(uc, vc):
            fp.refresh(np.asarray(uc, np.float64), np.asarray(vc, np.float64))
    elif setup.weights_mode == "otf":
        def step_adv(fl1):
            return propagate_otf(setup, fl1, st, cg_ext, wenv)
        refresh_currents = currents_ext
    else:
        cache = {"weights": _compute_weights(setup, st, cg_ext, wenv)}

        def step_adv(fl1):
            return propagate(setup, cache["weights"], fl1, st)

        def refresh_currents(uc, vc):
            currents_ext(uc, vc)
            cache["weights"] = None            # never two sets at a time
            cache["weights"] = _compute_weights(setup, st, cg_ext, wenv)

    def step_full(fl1, frc, stress):
        return phys_inplace(step_adv(fl1), frc, stress)

    return StepBundle(step_full, step_adv, step_phys, refresh_currents,
                      cfl_diagnostics=cfl, phys_inplace=phys_inplace)


def initial_stress(setup, frc) -> dict:
    """First-guess stress state before the first physics call: the
    BUILDSTRESS no-restart path (buildstress.F90:236-242) — CDUSTARZ0's
    Hersbach-2011 CD(U10) (cdustarz0.F90:68-72) with TAUW = 0.1·u*² and
    TAUWDIR = the wind direction.  ``frc`` holds host (n,) arrays
    ``wswave``/``wdwave``; returns tensors on the setup's device."""
    wspmin = 1.0                       # userin.F90:917 default
    u10 = np.maximum(np.asarray(frc["wswave"], np.float64), wspmin)
    cd = np.minimum((c.C1CD + c.C2CD * u10**c.P1CD) * u10**c.P2CD,
                    c.CDMAX)
    ustar = np.maximum(np.sqrt(cd) * u10, c.EPSUS)
    z0 = np.maximum(
        pp.XNLEV / (np.exp(pp.XKAPPA
                           * np.minimum(u10 / ustar, 100.0)) - 1.0),
        1.0e-6)
    out = dict(ufric=ustar, tauw=0.1 * ustar**2,
               tauwdir=np.asarray(frc["wdwave"], np.float64), z0m=z0,
               z0b=np.zeros(u10.shape[0]),
               chrnck=np.maximum(c.G * z0 / ustar**2,
                                 setup.phys.params.alpha))
    return {k: torch.as_tensor(v, dtype=setup.dtype, device=setup.device)
            for k, v in out.items()}
