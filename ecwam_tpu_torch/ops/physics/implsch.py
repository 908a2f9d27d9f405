"""Semi-implicit source-term integration — one physics step.

Port of ``ecwam_tpu/ops/physics/implsch.py``: SINFLX (sinflx.F90:190-260)
and IMPLSCH (implsch.F90:120-360) in plain PyTorch — the reference
version that the CUDA kernel of :mod:`.implsch_cuda` is held against.

The chain: depth limit → means → 2×SINFLX → SDISSIP → SNONLIN → SDIWBK →
SBOTTOM → implicit update with growth limiter → means → IMPHFTAIL →
SETICE, and in full mode (the output dates) WNFLUXES and STOKESTRN.
Both input physics (iphys=1: SINPUT/SDISSIP ARD; iphys=0: Janssen's
SINPUT_JAN and the cycle-4 SDISSIP_JAN), all three DIA enhancements
(isnonlin 0/1/2), ECMWF's cycle-49/50 options (the gravity-capillary
closure LLGCBZ0 with HALPHAP on the first SINFLX call, LLNORMAGAM,
LLCAPCHNK, LCISCAL), the three sea-ice attenuation models (SDICE1/2/3,
LCIWA1/2/3), the sea-ice strain (LSTRN) and the LBIWBK, LICERUN and
LMASKICE switches are ported, with U10 forcing (icode_wnd 3) and u*
forcing (icode_wnd 1/2: AIRSEA's U10 from the log profile feeds the rest
of the chain and the state's ``wswave``).

Layout: fl1 (nang, nfre, npts).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ecwam_tpu_torch.core import constants as c
from ecwam_tpu_torch.core import physparams as pp
from ecwam_tpu_torch.ops.physics import tables as tables_mod
from ecwam_tpu_torch.ops.physics import airsea as airsea_mod
from ecwam_tpu_torch.ops.physics import const
from ecwam_tpu_torch.ops.physics import dia as dia_mod
from ecwam_tpu_torch.ops.physics import fluxes as fluxes_mod
from ecwam_tpu_torch.ops.physics import gc as gc_mod
from ecwam_tpu_torch.ops.physics import means as means_mod
from ecwam_tpu_torch.ops.physics import sdice as sdice_mod
from ecwam_tpu_torch.ops.physics import sdissip as sdissip_mod
from ecwam_tpu_torch.ops.physics import shallow as shallow_mod
from ecwam_tpu_torch.ops.physics import sinput as sinput_mod
from ecwam_tpu_torch.ops.physics import stokes as stokes_mod
from ecwam_tpu_torch.ops.physics import stress as stress_mod
from ecwam_tpu_torch.ops.physics.tail_ice import FLMIN, imphftail, setice

XIMP = 1.0               # implicitness factor (yowstat.F90:94)


def derive_stokfac(wavnum, depth, tb):
    """STOKFAC from (k, d) (initdpthflds.F90 fills it from the same
    dispersion formulas), so the per-frequency row block need not be
    stored."""
    om = const(tb.zpifr, wavnum)[:, None]
    akd = wavnum * depth[None, :]
    akd_s = torch.clamp(akd, max=10.0)
    sh = 2.0 * c.G * wavnum**2 / (om * torch.tanh(2.0 * akd_s))
    dp = (2.0 / c.G) * om**3
    return torch.where(akd <= 10.0, sh, dp)


def derive_cgroup(wavnum, depth, tb):
    """Group speed from (k, d) (the formulas of core.dispersion); only the
    sea-ice attenuation consumes it, so the kernel's env need not store
    it."""
    om = const(tb.zpifr, wavnum)[:, None]
    akd = wavnum * depth[None, :]
    akd_s = torch.clamp(akd, max=10.0)
    sh = 0.5 * torch.sqrt(c.G * torch.tanh(akd_s) / wavnum) * (
        1.0 + 2.0 * akd_s / torch.sinh(2.0 * akd_s))
    dp = (c.G / (4.0 * c.PI)) / (om / c.ZPI)
    return torch.where(akd <= 10.0, sh, dp)


@dataclasses.dataclass(frozen=True)
class PhysicsConfig:
    """Static configuration of the physics step."""

    tables: Any               # SpectralTables
    params: pp.PhysParams
    dia: dia_mod.DiaTables
    sat_indices: np.ndarray
    sat_weights: np.ndarray
    x0tauhf: float
    wtauhf: np.ndarray
    idelt: float              # physics timestep (s)
    nfre_red: int
    icode_wnd: int = 3        # wind forcing code: 3=U10, 1=u*, 2=stress
    isnonlin: int = 1
    lbiwbk: bool = True
    licerun: bool = True
    lmaskice: bool = True
    lciscal: bool = False
    lcflx: bool = True        # compute ocean fluxes (implsch.F90:187 LCFLX)
    lwvflx_snl: bool = True   # include SNL in the flux source (mpuserin:715)
    lwamrsetci: bool = True   # sea-ice flux adjustments (mpuserin.F90:790)
    lstokes: bool = True      # surface Stokes drift (STOKESTRN)
    lstrn: bool = False       # sea-ice mean-square strain (CIMSSTRN)
    lciwa1: bool = False      # sea-ice attenuation models (SDICE1/2/3)
    lciwa2: bool = False
    lciwa3: bool = False


def make_physics_config(tables, params: pp.PhysParams, idelt: float,
                        *, nfre_red: int | None = None,
                        **kw) -> PhysicsConfig:
    nsdsnth, sat_idx, sat_w = pp.saturation_weights(
        tables.nang, tables.th, tables.delth)
    dia_tb = dia_mod.build_dia_tables(
        tables.nang, tables.nfre, tables.fr, tables.delth, tables.fratio)
    return PhysicsConfig(
        tables=tables, params=params, dia=dia_tb,
        sat_indices=sat_idx, sat_weights=sat_w,
        x0tauhf=tables_mod.x0_tauhf(params),
        wtauhf=tables_mod.wtauhf(params),
        idelt=idelt, nfre_red=nfre_red or tables.nfre_red, **kw)


def check_ported(cfg: PhysicsConfig, *, srl: bool = False) -> None:
    """Raise for what a path does not take: u*-driven forcing
    (icode_wnd 1/2) runs on the compact spectrum of the dense model only;
    the SRL fast path (``srl``) takes U10 forcing, as the reference's
    fast path does."""
    if cfg.icode_wnd not in (1, 2, 3):
        raise ValueError(f"invalid ICODE_WND={cfg.icode_wnd}")
    if srl and cfg.icode_wnd != 3:
        raise NotImplementedError("the SRL fast path takes U10 forcing "
                                  "(icode_wnd 3), not icode_wnd 1/2")


def growth_factor(wswave, params: pp.PhysParams):
    """RNFAC, the wind-dependent growth factor of LLNORMAGAM with
    LLCAPCHNK (sinflx.F90:92-98); 1 otherwise."""
    if params.llnormagam and params.llcapchnk:
        return 1.0 + params.dthrn_a * (
            1.0 + torch.tanh(wswave - params.dthrn_u))
    return torch.ones_like(wswave)


def sinflx(icall, ncall, cfg: PhysicsConfig, fl1, env, frc, flm, fmean,
           halp, ufric, tauw, tauwdir, z0m, z0b, chrnck):
    """One stress/input iteration (sinflx.F90:190-260).

    Returns dict with updated fl1 (tail floor applied on call 1), stress
    state, input source arrays, the prognostic cut and, under LLGCBZ0,
    ``halp`` (HALPHAP, taken on call 1 and kept) and ``gc_margin`` (the
    closure's decision margin, :func:`.airsea.taut_z0_gc`, and the
    distance of the TAU_PHI_HF cut-off index from its step).
    """
    params = cfg.params
    tb = cfg.tables
    raorw = torch.clamp(frc["aird"], min=1.0) * c.ROWATERM1
    th = const(tb.th, fl1)[:, None]
    coswdif = torch.cos(th - frc["wdwave"][None, :])
    sinwdif2 = torch.sin(th - frc["wdwave"][None, :]) ** 2
    rnfac = growth_factor(frc["wswave"], params)

    if icall == 1:
        # raise the tail noise floor (sinflx.F90:112-115)
        fl1 = torch.cat([fl1[:, :-1, :],
                         torch.maximum(fl1[:, -1:, :], flm[:, None, :])],
                        dim=1)
        if params.llgcbz0:
            halp = gc_mod.halphap(fl1, env["wavnum"], coswdif, tb, params)
    wswave, ufric, z0m, z0b, chrnck, gc_margin = airsea_mod.airsea(
        frc["wswave"], frc["wdwave"], tauw, tauwdir, ufric, params,
        icode_wnd=cfg.icode_wnd, iusfg=0 if icall == 1 else 1, halp=halp,
        rnfac=rnfac, with_margin=True)
    if cfg.icode_wnd in (1, 2):
        # u*-driven forcing: AIRSEA derives U10 from the log profile
        # (airsea.F90 ICODE 1/2) and the new U10 feeds the rest of the
        # chain (the reference's INOUT WSWAVE)
        frc = dict(frc, wswave=wswave)
    if params.llgcbz0:
        gc_margin = torch.minimum(
            gc_margin, gc_mod.ns_gc_tie(ufric, gc_mod.gc_tables()))

    ngst = 1 if icall < ncall else 2
    llsneg = icall >= ncall
    llphiwa = icall >= ncall
    sinput = (sinput_mod.sinput_ard if params.iphys == 1
              else sinput_mod.sinput_jan)
    fld, sl, spos, xllws, margin = sinput(
        fl1, env["wavnum"], env["cinv"], env["xk2cg"],
        frc["wdwave"], frc["wswave"], ufric, z0m,
        coswdif, sinwdif2, raorw, frc["wstar"], rnfac,
        tb, params, ngst=ngst, llsneg=llsneg)

    _, fmeanws = means_mod.femeanws(fl1, xllws, tb)
    frcut = stress_mod.frcut_argument(fmean, fmeanws, ufric, tb, params)
    mij, rhowgdfth = stress_mod.frcutindex(
        fmean, fmeanws, ufric, frc["cicover"], tb, params)
    tauw, tauwdir, phiwa = stress_mod.stresso(
        fl1, sl, spos, env["cinv"], mij, rhowgdfth,
        frc["wdwave"], ufric, z0m, frc["aird"], rnfac, coswdif, sinwdif2,
        tb, params, x0tauhf=cfg.x0tauhf, wtauhf=cfg.wtauhf, llphiwa=llphiwa)

    return dict(
        fl1=fl1, wswave=frc["wswave"], ufric=ufric, tauw=tauw,
        tauwdir=tauwdir, z0m=z0m, z0b=z0b, chrnck=chrnck,
        fld=fld, sl=sl, spos=spos, xllws=xllws, xllws_margin=margin,
        mij=mij, rhowgdfth=rhowgdfth, fmeanws=fmeanws, phiwa=phiwa,
        frcut=frcut, halp=halp, gc_margin=gc_margin,
        coswdif=coswdif, raorw=raorw)


def implsch(cfg: PhysicsConfig, fl1, env, frc,
            ufric, tauw, tauwdir, z0m, z0b, chrnck):
    """One physics step of Δt=idelt (implsch.F90:120-360).

    Returns (fl1_new, state_dict) where state_dict carries the updated
    stress fields, the mean-parameter diagnostics, the windsea mask
    ``xllws``, ``frcut_tie`` — the distance of FRCUTINDEX's argument from
    its rounding tie (x.5), the smaller over the two SINFLX calls; where
    it is tiny the cut, and with it the stress, flips on a last-bit
    change of the inputs — ``xllws_margin``, the signed distance of each
    mask bin from the mask's edge in the second SINFLX call (see
    :func:`.sinput.sinput_ard`), with ISNONLIN=2 ``peak_margin``, the
    relative gap of PEAK_ANG's peak over the next direction maximum
    (:func:`.dia.peak_margin`), under u* forcing ``z0_margin``, Z0WAVE's
    smaller relative gap (u*² − τw)/u*² of the two calls (rounding is
    amplified by its inverse) — and, with ``cfg.lcflx``/``cfg.lstokes``
    (full mode), the WNFLUXES and STOKESTRN fields.
    """
    check_ported(cfg)
    tb = cfg.tables
    delt = cfg.idelt
    deltm = 1.0 / delt
    delt5 = XIMP * delt

    if cfg.lbiwbk:
        fl1 = means_mod.sdepthlim(fl1, env["emaxdpt"], tb)

    emean, fmean, f1mean, akmean, xkmean = means_mod.fkmean(
        fl1, env["wavnum"], tb)

    th = const(tb.th, fl1)[:, None]
    coswdif = torch.cos(th - frc["wdwave"][None, :])
    flm = (1.0 - 0.9 * torch.clamp(frc["cicover"], max=0.99))[None, :] * \
        FLMIN * torch.clamp(coswdif, min=0.0) ** 2        # (nang, npts)

    st = None
    ties, gc_margins = [], []
    halp = torch.zeros_like(fmean)
    for icall in (1, 2):
        st = sinflx(icall, 2, cfg, fl1, env, frc, flm, fmean, halp,
                    ufric, tauw, tauwdir, z0m, z0b, chrnck)
        ties.append((st["frcut"] - torch.floor(st["frcut"]) - 0.5).abs())
        gc_margins.append(st["gc_margin"])
        halp = st["halp"]
        fl1, ufric, tauw, tauwdir = (
            st["fl1"], st["ufric"], st["tauw"], st["tauwdir"])
        if cfg.icode_wnd in (1, 2):
            frc = dict(frc, wswave=st["wswave"])
        z0m, z0b, chrnck = st["z0m"], st["z0b"], st["chrnck"]
    fld, sl = st["fld"], st["sl"]
    mij, xllws, fmeanws = st["mij"], st["xllws"], st["fmeanws"]
    xllws_margin = st["xllws_margin"]

    if cfg.params.iphys == 1:
        fld, sl = sdissip_mod.sdissip_ard(
            fl1, fld, sl, env["wavnum"], env["xk2cg"], ufric,
            st["coswdif"], st["raorw"], tb, cfg.params, cfg.sat_indices,
            cfg.sat_weights)
    else:
        fld, sl = sdissip_mod.sdissip_jan(
            fl1, fld, sl, env["wavnum"], emean, f1mean, xkmean, tb,
            cfg.params)
    peak = dia_mod.peak_margin(fl1) if cfg.isnonlin == 2 else None
    # the flux-relevant source contribution (implsch.F90:281-306)
    ssource = sl if (cfg.lcflx and not cfg.lwvflx_snl) else None
    fld, sl = dia_mod.snonlin(
        fl1, fld, sl, env["wavnum"], env["depth"], akmean, tb, cfg.dia,
        isnonlin=cfg.isnonlin)
    if cfg.lcflx and cfg.lwvflx_snl:
        # modulated by the implicit factor (implsch.F90:297-305)
        ssource = sl / torch.clamp(1.0 - delt5 * fld, min=1.0)
    fld, sl = shallow_mod.sdiwbk(
        fl1, fld, sl, env["depth"], env["emaxdpt"], emean, f1mean,
        cfg.nfre_red, lbiwbk=cfg.lbiwbk)
    if cfg.licerun and cfg.lciscal:
        # the sources scale with the open-water fraction (implsch.F90)
        beta = (1.0 - frc["cicover"])[None, None, :]
        sl = beta * sl
        fld = beta * fld
    if cfg.licerun and (cfg.lciwa1 or cfg.lciwa2 or cfg.lciwa3):
        cithick = frc.get("cithick", torch.zeros_like(frc["cicover"]))
        cgroup = env.get("cgroup")
        if cgroup is None:
            cgroup = derive_cgroup(env["wavnum"], env["depth"], tb)
        fld, sl, _ = sdice_mod.sdice(
            fl1, fld, sl, env["wavnum"], cgroup, frc["cicover"], cithick,
            tb, cfg.idelt, lciwa1=cfg.lciwa1, lciwa2=cfg.lciwa2,
            lciwa3=cfg.lciwa3)
    fld, sl = shallow_mod.sbottom(
        fl1, fld, sl, env["wavnum"], env["depth"], cfg.nfre_red)

    # ---- semi-implicit update with growth limiter (implsch.F90:260-300)
    cofrm4 = const(tb.cofrm4, fl1)[None, :, None]
    usfm = (ufric * torch.maximum(fmeanws, fmean))[None, None, :]
    temp = usfm * (cofrm4 * delt)
    gtemp1 = torch.clamp(1.0 - delt5 * fld, min=1.0)
    gtemp2 = delt * sl / gtemp1
    flhab = torch.minimum(torch.abs(gtemp2), temp)
    fl1 = fl1 + torch.sign(gtemp2) * flhab
    fl1 = torch.maximum(fl1, flm[:, None, :])
    flmax = const(_flmax(tb, cfg.params), fl1)[None, :, None]
    if ssource is not None:
        # the cap's contribution enters the flux source (implsch.F90:375,390)
        ssource = ssource + deltm * torch.clamp(flmax - fl1, max=0.0)
    fl1 = torch.minimum(fl1, flmax)

    flux_diag = {}
    if cfg.lcflx:
        flux_diag = fluxes_mod.wnfluxes(
            ssource, env["cinv"], st["rhowgdfth"], frc["cicover"],
            st["phiwa"], emean, f1mean, frc["wswave"], frc["wdwave"],
            ufric, frc["aird"], tb, cfg.params,
            licerun=cfg.licerun, lwamrsetci=cfg.lwamrsetci)

    emean, fmean, f1mean, akmean, xkmean = means_mod.fkmean(
        fl1, env["wavnum"], tb)
    emeanws, fmeanws = means_mod.femeanws(fl1, xllws, tb)

    fl1 = imphftail(fl1, mij, flm, env["wavnum"], env["xk2cg"])

    small = emeanws < c.WSEMEAN_MIN
    wsemean = torch.where(small, torch.full_like(emeanws, c.WSEMEAN_MIN),
                          emeanws)
    wsfmean = torch.where(small, torch.full_like(fmeanws, 2.0 * tb.fr[-1]),
                          fmeanws)

    if cfg.licerun and cfg.lmaskice:
        fl1 = setice(fl1, frc["cicover"], st["coswdif"])

    state = dict(
        **({"wswave": frc["wswave"]} if cfg.icode_wnd in (1, 2) else {}),
        ufric=ufric, tauw=tauw, tauwdir=tauwdir, z0m=z0m, z0b=z0b,
        chrnck=chrnck, mij=mij, xllws=xllws, phiwa=st["phiwa"],
        emean=emean, fmean=fmean, f1mean=f1mean, akmean=akmean,
        xkmean=xkmean, emeanws=emeanws, fmeanws=fmeanws,
        wsemean=wsemean, wsfmean=wsfmean, frcut_tie=torch.minimum(*ties),
        xllws_margin=xllws_margin,
        **flux_diag)
    if cfg.icode_wnd in (1, 2):
        state["z0_margin"] = torch.minimum(*gc_margins)
    elif cfg.params.llgcbz0:
        state["gc_margin"] = torch.minimum(*gc_margins)
    if peak is not None:
        state["peak_margin"] = peak
    if cfg.lstokes:
        cithick = frc.get("cithick", torch.zeros_like(frc["cicover"]))
        stokfac = env.get("stokfac")
        if stokfac is None:
            stokfac = derive_stokfac(env["wavnum"], env["depth"], tb)
        state.update(stokes_mod.stokestrn(
            fl1, env["wavnum"], stokfac, env["depth"],
            frc["wswave"], frc["wdwave"], frc["cicover"], cithick, tb,
            licerun=cfg.licerun, lwamrsetci=cfg.lwamrsetci,
            lstrn=cfg.lstrn))
        state.setdefault("strnms", torch.zeros_like(ufric))
    return fl1, state


def _flmax(tb, params: pp.PhysParams) -> np.ndarray:
    """Spectral cap FLMAX(m) = (ALPHAPMAX/π)/((2π)⁴g⁻²·fr⁵) (initmdl.F90:468)."""
    return (params.alphapmax / c.PI) / (c.ZPI4GM2 * tb.fr5)
