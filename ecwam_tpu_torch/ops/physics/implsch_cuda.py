"""Fused IMPLSCH physics: CUDA kernel + plain version, two layouts.

Kernels B and C of the port, one CUDA source (``csrc/implsch.cu``):
  * :func:`implsch_srl`, the counterpart of
    ``ecwam_tpu/ops/physics/implsch_pallas.py: implsch_pallas_srl``, on
    SRL rows, in minimal (between output dates) or full mode;
  * :func:`implsch_compact`, the counterpart of ``implsch_pallas`` there,
    on the compact (nang, nfre, n) spectrum — the same kernel through a
    point stride and a bin stride.
Each launches the kernel for CUDA tensors and runs its plain version
(:func:`implsch_srl_plain`, :func:`implsch_compact_plain`: the plain
PyTorch chain of :mod:`.implsch`) for CPU tensors.

Layouts (point index fastest in every row block, no lane pad):
  f_srl (nsrl, nang·nfre_red)  k-major advected spectrum rows
  tail  (nsrl, nang·(nfre−nfre_red)) k-major diagnostic tail rows, or
        None when nfre == nfre_red
  fl1   (nang, nfre, n)         the compact spectrum
  env2d (3·nfre, n)             [wavnum; cinv; xk2cg] row blocks
  scal  (14, n)                 SCAL_IN rows
Minimal mode returns the 6 STRESS_KEYS rows; full mode (the output-date
diagnostics) the 30 SCAL_OUT_FULL rows — those that ``cfg``'s lcflx or
lstokes switch off are 0 — and the windsea mask xllws (nang, nfre, n) as
float 0/1.

ECMWF's cycle-49/50 physics options (the gravity-capillary closure
LLGCBZ0 with HALPHAP, LLNORMAGAM, LLCAPCHNK, LCISCAL and the SDICE3
sea-ice attenuation LCIWA3) run in a separate instantiation of the kernel
(``OPTS``), so the default configuration's code is untouched by them.
The rest of the physics (iphys=0's Janssen input and cycle-4
dissipation, ISNONLIN 0/2, SDICE1/2, the sea-ice strain LSTRN, the
LBIWBK/LICERUN/LMASKICE switches off and, in full mode, LCFLX, LSTOKES
or LWVFLX_SNL off) runs in the ``EXT`` instantiations (with ``JAN`` for
iphys=0), so that neither earlier instantiation changes.  u*-driven
forcing (icode_wnd 1/2), which only the dense model's compact spectrum
takes, runs in the ``UST`` instantiations (alone under the default
physics; with ``OPTS`` where another bit is set, and with ``EXT``/``JAN``
where those bits are set), in either mode, and returns
one more row, the log profile's U10 (:data:`SCAL_OUT_UST`,
:data:`SCAL_OUT_UST_MIN`).  Up to 64 directions (and, in full mode, 64
frequencies) run in the default build of the source; up to 128
directions, or more frequencies, in its wide build (:data:`WIDE_LIB`).
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import numpy as np
import torch

from ecwam_tpu_torch.core import constants as c
from ecwam_tpu_torch.core import physparams as pp
from ecwam_tpu_torch.core import spectral as sp
from ecwam_tpu_torch.core.dispersion import BATHYMAX
from ecwam_tpu_torch.ops.physics import tables
from ecwam_tpu_torch import _build
from ecwam_tpu_torch.ops.physics import dia as dia_mod
from ecwam_tpu_torch.ops.physics import fluxes as fluxes_mod
from ecwam_tpu_torch.ops.physics import gc as gc_mod
from ecwam_tpu_torch.ops.physics import implsch as impl
from ecwam_tpu_torch.ops.physics import sdice as sdice_mod
from ecwam_tpu_torch.ops.physics import sdissip as sdissip_mod
from ecwam_tpu_torch.ops.physics import sinput as sinput_mod
from ecwam_tpu_torch.ops.physics import stokes as stokes_mod
from ecwam_tpu_torch.ops.physics.airsea import EPS1, WSPMIN_DEFAULT
from ecwam_tpu_torch.ops.physics.shallow import DEPTHTRS
from ecwam_tpu_torch.ops.physics.stress import CITHRSH_TAIL
from ecwam_tpu_torch.ops.physics.tail_ice import CITHRSH, FLMIN

# packed per-point scalar input rows (forcing + env + stress state)
SCAL_IN = ("wswave", "wdwave", "aird", "wstar", "cicover", "cithick",
           "depth", "emaxdpt",
           "ufric", "tauw", "tauwdir", "z0m", "z0b", "chrnck")
N_FRC = 6                     # leading forcing rows
STRESS_KEYS = ("ufric", "tauw", "tauwdir", "z0m", "z0b", "chrnck")
# per-frequency env fields → row blocks of the (3·nfre, n) matrix
ENV_FIELDS = ("wavnum", "cinv", "xk2cg")

# minimal-mode outputs: exactly the state that feeds the next step
SCAL_OUT_MIN = STRESS_KEYS
# full-mode diagnostics (implsch state keys, io/products.py consumers);
# mij rides as float in the packed rows (cast back by unpack_scal_out)
SCAL_OUT_FULL = STRESS_KEYS + (
    "mij", "phiwa", "emean", "fmean", "f1mean", "akmean", "xkmean",
    "emeanws", "fmeanws", "wsemean", "wsfmean",
    "tauxd", "tauyd", "tauocxd", "tauocyd", "tauoc",
    "phiocd", "phieps", "phiaw", "em_oc", "f1_oc",
    "ustokes", "vstokes", "strnms")
# u* forcing: U10 from the log profile after the mode's rows
SCAL_OUT_UST = SCAL_OUT_FULL + ("wswave",)
SCAL_OUT_UST_MIN = SCAL_OUT_MIN + ("wswave",)

# scalar parameter block of the kernel, in the order of csrc/implsch.cu's
# Par enum (P_<NAME>)
PAR_NAMES = (
    "delt", "delt5", "delth", "delt25", "delt2", "coef1",
    "zalp", "fpmh", "fppm", "flogsprdm1", "alphaog", "alphamin",
    "const1", "tauwshelter", "z0rat", "z0tubmax", "swellf4", "swellf7m1",
    "x0g", "tmp03", "tpiinv", "dal1", "dal2",
    "g", "gm1", "xkappa", "xlogxl", "rnum", "rnu4", "two_nu",
    "epsmin", "epsus", "eps1p", "acd", "bcd", "cdmax",
    "c1cd", "c2cd", "p1cd", "p2cd", "p2c1", "p12", "half_kappa", "ln10",
    "swf16", "swf5_2", "fu", "fud", "ssdsc2", "ssdsc4", "ssdsc6",
    "one_m_ssdsc6",
    "flmin", "cithrsh", "cithrsh_tail", "bathymax", "dkmax", "depthtrs",
    "rowaterm1", "zpi4gm2", "sbot_c", "abmin", "delabm1", "enh_min",
    "enh_max", "nsdsnth",
    # full mode only
    "deltm", "zpi4gm1", "coefa", "coefx", "wsemean_min",
    "lwamrsetci", "zcithrs", "cithrsh_inv", "zmaxexp", "efd_fac", "ffd_fac",
    "efd_min", "efd_max", "cdb_c1", "cdb_c2", "cdb_p1", "cdb_p2", "cdb_max",
    "epsu10", "epsus3", "tauocmin", "tauocmax", "phiepsmin", "phiepsmax",
    "phioc_ice", "phiaw_ice", "twog", "twogm1", "stokes_c", "stmax",
    "cithrsh_stokes",
    # the cycle-49/50 options
    "alpha", "chnkmin_u", "ang_gc_a", "ang_gc_b", "ang_gc_c", "bmaxokap",
    "rn1_rn", "dthrn_a", "dthrn_u", "gamnconst", "alphapmax", "xnlev",
    "rnukappam1", "sqrtgosurft", "xkm0", "xlogkratiom1", "acdlin", "bcdlin",
    "alphamax", "constn", "cdice2", "logfr_last", "fr_nm3", "halp_tail",
    "g4pi",
    # iphys=0, ISNONLIN 0/2, SDICE1/2 and CIMSSTRN
    "conss", "delta_sdis", "cvis", "const3", "xkappad", "nsh", "coef_fr2",
    "xkdmin", "ticmin", "dtic", "nict", "hicmin", "dhic", "nich", "cdicwa",
    "ficstf_c", "rdh_c", "aki_max", "f1lim")

# option bits of the kernel's ``opts`` argument, in the order of
# csrc/implsch.cu's Opt enum: the cycle-49/50 options (the OPTS
# instantiation), then those of the EXT instantiations — iphys=0 (JAN),
# ISNONLIN 0/2, SDICE1/2, LSTRN, the three switches switched off and full
# mode's three flux/Stokes switches switched off — then u* forcing (the
# UST instantiations)
OPT_FLAGS = ("llgcbz0", "llnormagam", "llcapchnk", "lciwa3", "lciscal",
             "iphys0", "isnonlin0", "isnonlin2", "lciwa1", "lciwa2", "lstrn",
             "no_lbiwbk", "no_licerun", "no_lmaskice", "no_lcflx",
             "no_lstokes", "no_lwvflx_snl", "ustar")
UST_BIT = 1 << OPT_FLAGS.index("ustar")
EXT_BITS = sum(1 << i for i in range(5, OPT_FLAGS.index("ustar")))
LSTRN_BIT = 1 << OPT_FLAGS.index("lstrn")
# the bits that only full mode sets (the tables are the same for both)
MODE_BITS = LSTRN_BIT | sum(1 << OPT_FLAGS.index(f) for f in (
    "no_lcflx", "no_lstokes", "no_lwvflx_snl"))
# the default build takes nang <= KPL_DEFAULT·32 (and full mode nfre <=
# 64), the wide build any nang and nfre whose row and tables fit one
# block's shared memory (shared_bytes <= SMEM_BLOCK)
KPL_DEFAULT = 2
WIDE_LIB = "implsch_wide"
# the shared memory one block may opt in to on the H100 (227 KB)
SMEM_BLOCK = 232448
# csrc/implsch.cu's table and row constants: the per-frequency tables
# (FreqTab), the tail-integral nodes, the gc tables staged (NGCSTAGE) and
# the directions whose W is staged (GRP of the wide build)
NFREQTAB, JTOT, NGCSTAGE, GRP_WIDE = 12, 19, 5, 128
# gravity-capillary tables the kernel reads, NWAV values each, in the
# order of csrc/implsch.cu's GcTab enum
GC_TABLES = ("logxk", "cm", "om3gmkm", "xkmsqrtvgoc2", "delkcc_omxkm3",
             "c2osqrtvg", "dns_omxkm3", "omega")


def minimal_config(cfg: impl.PhysicsConfig) -> impl.PhysicsConfig:
    """A PhysicsConfig stripped of the pure-diagnostic work (fluxes,
    Stokes) for between-output-date steps — the prognostic state
    (fl1 + stress) is the same; only output-time diagnostics are
    skipped (wamodel.F90 computes them for output/coupling)."""
    return dataclasses.replace(cfg, lcflx=False, lstokes=False, lstrn=False)


def _row_keys(full: bool, ustar: bool) -> tuple:
    if full:
        return SCAL_OUT_UST if ustar else SCAL_OUT_FULL
    return SCAL_OUT_UST_MIN if ustar else SCAL_OUT_MIN


def out_keys(cfg: impl.PhysicsConfig, full: bool) -> tuple:
    """The output rows of a step: the stress rows (minimal mode) or the
    full mode's, and under u* forcing U10 after them."""
    return _row_keys(full, cfg.icode_wnd in (1, 2))


def unpack_scal_out(so, *, full: bool) -> dict:
    """(NSO, n) packed output rows → state dict (mij back to int64); u*
    forcing's extra row comes out as ``wswave``."""
    keys = _row_keys(full, so.shape[0] == len(_row_keys(full, True)))
    out = {k: so[i] for i, k in enumerate(keys)}
    if "mij" in out:
        out["mij"] = out["mij"].to(torch.int64)
    return out


def pack_scal_out(state: dict, *, full: bool):
    """A chain's state dict → (NSO, n) rows; keys the configuration does
    not compute are zero, as in the TPU kernel; u* forcing's ``wswave``
    (in the state only then) after the mode's rows."""
    keys = _row_keys(full, "wswave" in state)
    like = state["ufric"]
    return torch.stack([state[k].to(like.dtype) if k in state
                        else torch.zeros_like(like) for k in keys])


def option_bits(cfg: impl.PhysicsConfig, full: bool = False) -> int:
    """The ``opts`` bit mask of the configuration (OPT_FLAGS order): 0
    runs the default instantiation, bits of EXT_BITS the EXT ones, the
    u* bit the UST ones.  The flux/Stokes switches count in full mode
    (``full``) only: minimal mode computes neither."""
    p = cfg.params
    on = (p.llgcbz0, p.llnormagam, p.llcapchnk, cfg.lciwa3, cfg.lciscal,
          p.iphys == 0, cfg.isnonlin == 0, cfg.isnonlin == 2, cfg.lciwa1,
          cfg.lciwa2, cfg.lstrn, not cfg.lbiwbk, not cfg.licerun,
          not cfg.lmaskice, full and not cfg.lcflx,
          full and not cfg.lstokes,
          full and cfg.lcflx and not cfg.lwvflx_snl,
          cfg.icode_wnd in (1, 2))
    return sum(1 << i for i, v in enumerate(on) if v)


def library(cfg: impl.PhysicsConfig, full: bool,
            compact: bool = False) -> str:
    """The build of csrc/implsch.cu that takes the configuration on the
    SRL entry or the ``compact`` one: the default width up to 64
    directions (full mode: and 64 frequencies), else the wide one
    (:data:`WIDE_LIB`); each entry's instantiations are a library of
    their own (``_build.VARIANTS``)."""
    tb = cfg.tables
    narrow = tb.nang <= 32 * KPL_DEFAULT and not (full and tb.nfre > 64)
    return ("implsch" if narrow else WIDE_LIB) + (
        "_compact" if compact else "")


def shared_bytes(cfg: impl.PhysicsConfig, full: bool = False) -> int:
    """Bytes of shared memory a block of the kernel needs for its tables
    and one row: csrc/implsch.cu's ``table_floats`` + ``row_floats`` for
    the build :func:`library` picks and the instantiation the options
    pick (OPTS stages the gc tables; EXT's LWVFLX_SNL off keeps three
    more sums a row)."""
    tb = cfg.tables
    nang, nfre = tb.nang, tb.nfre
    ml = int(cfg.dia.mlsthg)
    wide = library(cfg, full) == WIDE_LIB
    bits = option_bits(cfg, full)
    opts = bool(bits & ~UST_BIT)
    pre = bool(full and bits & (1 << OPT_FLAGS.index("no_lwvflx_snl")))

    def up32(n):
        return (n + 31) & ~31
    staged_w = nang * nang if not wide or nang <= GRP_WIDE else 0
    table = up32(len(PAR_NAMES) + NFREQTAB * nfre + 3 * nang + staged_w
                 + JTOT + 26 * ml
                 + (NGCSTAGE * int(gc_mod.gc_tables().nwav) if opts else 0)
                 + 9 * ml + 8)
    dx = 4 * nfre if full and nfre > nang else 4 * nang
    row = (3 * nang * (nfre | 1) + 5 * nfre + max(2 * nfre, ml) + 3 * nang
           + dx + (nang * ((nfre + 31) >> 5) if full and wide else 0)
           + (3 * nfre if pre else 0))
    return 4 * (table + up32(row))


def kernel_supports(cfg: impl.PhysicsConfig, full: bool = False, *,
                    compact: bool = False) -> None:
    """Raise for configurations the kernel does not take: u* forcing
    (icode_wnd 1/2) on the SRL entry (the compact one, ``compact``, takes
    it with every option), an unknown ISNONLIN, a WSPMIN other than 1, and
    a row whose bin arrays and tables do not fit one block's shared
    memory (:func:`shared_bytes` > SMEM_BLOCK: at 36 frequencies, past
    461 directions in minimal mode and 453 in full mode, by default)."""
    impl.check_ported(cfg, srl=not compact)
    if cfg.isnonlin not in (0, 1, 2):
        raise ValueError(f"unknown ISNONLIN={cfg.isnonlin}")
    need = shared_bytes(cfg, full)
    if need > SMEM_BLOCK:
        tb = cfg.tables
        raise NotImplementedError(
            f"the physics kernel's row of nang={tb.nang} × nfre={tb.nfre} "
            f"with its tables takes {need} bytes of shared memory; a block "
            f"holds {SMEM_BLOCK} (ROADMAP C2)")
    if WSPMIN_DEFAULT != 1.0:
        raise NotImplementedError("the physics kernel assumes WSPMIN=1")


def _parameters(cfg: impl.PhysicsConfig) -> np.ndarray:
    tb, p, dia = cfg.tables, cfg.params, cfg.dia
    fr = tb.fr
    v = dict(
        delt=cfg.idelt, delt5=impl.XIMP * cfg.idelt, delth=tb.delth,
        delt25=sp.WETAIL * fr[-1] * tb.delth, delt2=sp.FRTAIL * tb.delth,
        coef1=sp.WP1TAIL * tb.delth * fr[-1] ** 2,
        zalp=p.zalp, fpmh=p.tailfactor / fr[0],
        fppm=p.tailfactor_pm * c.G / (sp.FRIC * tb.zpifr[0]),
        flogsprdm1=tb.flogsprdm1, alphaog=p.alpha * c.GM1,
        alphamin=p.alphamin, const1=p.betamaxoxkappa2,
        tauwshelter=p.tauwshelter, z0rat=p.z0rat, z0tubmax=p.z0tubmax,
        swellf4=p.swellf4, swellf7m1=p.swellf7m1,
        x0g=cfg.x0tauhf * c.G, tmp03=1.0 / (pp.SDSBR * pp.MICHE),
        tpiinv=1.0 / c.ZPI, dal1=dia.dal1, dal2=dia.dal2,
        g=c.G, gm1=c.GM1, xkappa=pp.XKAPPA, xlogxl=math.log(pp.XNLEV),
        rnum=pp.RNUM, rnu4=4.0 / pp.RNU, two_nu=2.0 * pp.RNU,
        epsmin=c.EPSMIN, epsus=c.EPSUS, eps1p=1.0 + EPS1, acd=c.ACD,
        bcd=c.BCD, cdmax=c.CDMAX, c1cd=c.C1CD, c2cd=c.C2CD, p1cd=c.P1CD,
        p2cd=c.P2CD, p2c1=c.P2CD * c.C1CD, p12=c.P1CD + c.P2CD,
        half_kappa=0.5 * pp.XKAPPA, ln10=math.log(10.0),
        swf16=-pp.SWELLF * 16.0, swf5_2=-pp.SWELLF5 * 2.0,
        fu=abs(pp.SWELLF3), fud=pp.SWELLF2, ssdsc2=pp.SSDSC2,
        ssdsc4=pp.SSDSC4, ssdsc6=pp.SSDSC6, one_m_ssdsc6=1.0 - pp.SSDSC6,
        flmin=FLMIN, cithrsh=CITHRSH, cithrsh_tail=CITHRSH_TAIL,
        bathymax=BATHYMAX, dkmax=c.DKMAX, depthtrs=DEPTHTRS,
        rowaterm1=c.ROWATERM1, zpi4gm2=c.ZPI4GM2,
        sbot_c=-2.0 * 0.038 * c.GM1, abmin=tables.ABMIN,
        delabm1=tables.IAB / (tables.ABMAX - tables.ABMIN),
        enh_min=dia_mod.ENH_MIN, enh_max=dia_mod.ENH_MAX,
        nsdsnth=(cfg.sat_indices.shape[1] - 1) // 2,
        deltm=1.0 / cfg.idelt, zpi4gm1=c.ZPI4GM1,
        coefa=sp.FRTAIL * tb.delth * math.sqrt(c.G) / c.ZPI,
        coefx=sp.WP1TAIL * tb.delth * fr[-1] ** 2 * c.ZPI / math.sqrt(c.G),
        wsemean_min=c.WSEMEAN_MIN, lwamrsetci=float(cfg.lwamrsetci),
        efd_min=fluxes_mod.EFD_MIN, efd_max=fluxes_mod.EFD_MAX,
        cdb_c1=fluxes_mod._C1, cdb_c2=fluxes_mod._C2, cdb_p1=fluxes_mod._P1,
        cdb_p2=fluxes_mod._P2, cdb_max=fluxes_mod._CDMAX,
        epsu10=c.EPSU10, epsus3=c.EPSUS * math.sqrt(c.EPSUS),
        tauocmin=c.TAUOCMIN, tauocmax=c.TAUOCMAX, phiepsmin=c.PHIEPSMIN,
        phiepsmax=c.PHIEPSMAX, phioc_ice=fluxes_mod.PHIOC_ICE,
        phiaw_ice=fluxes_mod.PHIAW_ICE, twog=2.0 * c.G, twogm1=2.0 / c.G,
        stokes_c=stokes_mod.stokes_const(tb), stmax=stokes_mod.STMAX,
        cithrsh_stokes=0.3, **fluxes_mod.ice_constants(p),
        alpha=p.alpha, chnkmin_u=p.chnkmin_u, ang_gc_a=p.ang_gc_a,
        ang_gc_b=p.ang_gc_b, ang_gc_c=p.ang_gc_c, bmaxokap=p.bmaxokap,
        rn1_rn=p.rn1_rn, dthrn_a=p.dthrn_a, dthrn_u=p.dthrn_u,
        gamnconst=p.gamnconst(), alphapmax=p.alphapmax, xnlev=pp.XNLEV,
        rnukappam1=0.04 * pp.RNU / pp.XKAPPA, sqrtgosurft=c.SQRTGOSURFT,
        xkm0=gc_mod.gc_tables().xkm[0], xlogkratiom1=gc_mod.XLOGKRATIOM1_GC,
        acdlin=c.ACDLIN, bcdlin=c.BCDLIN, alphamax=pp.ALPHAMAX,
        constn=tb.delth / (pp.XKAPPA * c.ZPI), cdice2=2.0 * sdice_mod.CDICE,
        logfr_last=math.log(fr[-1]), fr_nm3=fr[tb.nfre - 3],
        halp_tail=c.ZPI4GM2 * fr[-1] ** 5, g4pi=c.G / (4.0 * c.PI),
        conss=p.cdis * c.ZPI, delta_sdis=p.delta_sdis,
        cvis=pp.RNU * p.cdisvis,
        const3=sinput_mod.IDAMPING * 2.0 * pp.XKAPPA / p.betamaxoxkappa2,
        xkappad=1.0 / pp.XKAPPA, nsh=dia_mod.peak_window(tb),
        coef_fr2=sp.WP2TAIL * tb.delth * fr[-1] ** 3, xkdmin=dia_mod.XKDMIN,
        **{k: float(v) for k, v in sdice_mod.load_cideac().items()
           if k != "cideac"},
        cdicwa=sdice_mod.CDICWA * sdice_mod.ZALPFACB,
        ficstf_c=stokes_mod.YMICE / (12.0 * (1.0 - stokes_mod.RMUICE**2))
        / c.ROWATER,
        rdh_c=stokes_mod.RHOI / c.ROWATER, aki_max=stokes_mod.AKI_MAX,
        f1lim=FLMIN / tb.delth)
    return np.array([v[k] for k in PAR_NAMES], np.float64)


def _gc_block() -> np.ndarray:
    """The GC_TABLES rows (len(GC_TABLES), NWAV), float64."""
    g = gc_mod.gc_tables()
    rows = dict(logxk=np.log(g.xk), cm=g.cm, om3gmkm=g.om3gmkm,
                xkmsqrtvgoc2=g.xkmsqrtvgoc2, delkcc_omxkm3=g.delkcc_omxkm3,
                c2osqrtvg=g.c2osqrtvg, dns_omxkm3=g.delkcc_ns * g.omxkm3,
                omega=g.omega)
    return np.stack([rows[k] for k in GC_TABLES])


def pack_tables(cfg: impl.PhysicsConfig, device) -> dict:
    """The kernel's parameter block and tables as two device arrays, in
    the layout csrc/implsch.cu's ``implsch_launch`` unpacks (the same for
    both modes and layouts)."""
    tb, dia = cfg.tables, cfg.dia
    if int(tables.JTOT_TAUHF) != 19:
        raise ValueError("the physics kernel integrates JTOT=19 nodes")
    swellft = tables.tabu_swellft()
    ftabs = [tb.fr, tb.dfim, tb.dfimofr, tb.dfimfr, tb.zpifr, tb.fr5,
             tb.cofrm4, tb.rhowg_dfim, impl._flmax(tb, cfg.params),
             tb.dfim_sim, np.asarray(tb.fr) ** 4.5, tb.dfimfr2]
    wmat = sdissip_mod.saturation_matrix(tb.nang, cfg.sat_indices,
                                         cfg.sat_weights)
    # the kernel sums W(k, j) over j = k−NSDSNTH..k+NSDSNTH only
    ns = (cfg.sat_indices.shape[1] - 1) // 2
    off = (np.arange(tb.nang)[None, :] - np.arange(tb.nang)[:, None]) \
        % tb.nang
    if 2 * ns + 1 > tb.nang or np.any(
            wmat[np.minimum(off, tb.nang - off) > ns] != 0.0):
        raise ValueError("the physics kernel sums the saturation over "
                         "2·NSDSNTH+1 directions")
    ftab = np.concatenate(
        [_parameters(cfg)] + [np.asarray(a, np.float64) for a in ftabs]
        + [tb.th, tb.sinth, tb.costh, wmat.reshape(-1), swellft,
           np.asarray(cfg.wtauhf, np.float64), _gc_block().reshape(-1),
           dia.af11,
           np.asarray(dia.rnl, np.float64).reshape(-1),
           dia_mod.enhancement_xk(dia, tb),
           sdice_mod.load_cideac()["cideac"].reshape(-1)])
    # the kernel reads the target bins of each MC before it writes them
    nfre = tb.nfre
    for j in range(int(dia.mlsthg)):
        t = [j] if j < nfre else []
        t += [int(x) - 1 for x in (dia.ikm[j], dia.ikm1[j], dia.ikp[j],
                                   dia.ikp1[j]) if 1 <= x <= nfre]
        if len(set(t)) != len(t):
            raise ValueError("the physics kernel takes DIA steps whose "
                             "target frequencies differ")
    shifts = dia_mod.build_dia_projection(dia).shifts
    itab = np.concatenate(
        [dia.ic, dia.ip, dia.ip1, dia.im, dia.im1, dia.ikm, dia.ikm1,
         dia.ikp, dia.ikp1, shifts.reshape(-1)])
    return dict(
        tab=torch.as_tensor(ftab.astype(np.float32), device=device),
        itab=torch.as_tensor(itab.astype(np.int32), device=device),
        mlsthg=int(dia.mlsthg), niab=int(swellft.shape[0]),
        nwav=int(gc_mod.gc_tables().nwav),
        opts=option_bits(cfg) & ~MODE_BITS)




def _unpack_inputs(cfg, env2d, scal):
    """(env, frc, stress tuple in STRESS_KEYS order) of the plain chain
    from the packed env and scalar rows."""
    nfre = cfg.tables.nfre
    si = {k: scal[i] for i, k in enumerate(SCAL_IN)}
    env = {k: env2d[i * nfre:(i + 1) * nfre] for i, k in
           enumerate(ENV_FIELDS)}
    env["depth"], env["emaxdpt"] = si["depth"], si["emaxdpt"]
    frc = {k: si[k] for k in SCAL_IN[:N_FRC]}
    return env, frc, tuple(si[k] for k in STRESS_KEYS)


def srl_inputs(cfg, f_srl, env2d, scal, tail, *, nang: int,
               nfre_red: int):
    """SRL-row inputs → the arguments of :func:`.implsch.implsch`:
    (fl1 (nang, nfre, nsrl), env, frc, stress tuple in STRESS_KEYS
    order)."""
    nfre = cfg.tables.nfre
    nsrl = f_srl.shape[0]
    fl = f_srl.reshape(nsrl, nang, nfre_red).permute(1, 2, 0)
    if tail is not None:
        fl = torch.cat([fl, tail.reshape(nsrl, nang, nfre - nfre_red)
                        .permute(1, 2, 0)], dim=1)
    return (fl,) + _unpack_inputs(cfg, env2d, scal)


def _outputs(state, full: bool):
    return pack_scal_out(state, full=full), (state["xllws"] if full
                                             else None)


def implsch_srl_plain(cfg, f_srl, env2d, scal, tail, *, nang: int,
                      nfre_red: int, full: bool = False):
    """The plain PyTorch chain (:func:`.implsch.implsch`) on SRL rows:
    (f_srl, stress6, tail), or in full mode (f_srl, scal_out (30, nsrl),
    tail, xllws (nang, nfre, nsrl)).  U10 forcing only, as the kernel."""
    impl.check_ported(cfg, srl=True)
    nsrl = f_srl.shape[0]
    fl, env, frc, stress = srl_inputs(cfg, f_srl, env2d, scal, tail,
                                      nang=nang, nfre_red=nfre_red)
    out, state = impl.implsch(cfg, fl, env, frc, *stress)
    rows = out.permute(2, 0, 1)
    f_new = rows[:, :, :nfre_red].reshape(nsrl, -1).contiguous()
    t_new = (rows[:, :, nfre_red:].reshape(nsrl, -1).contiguous()
             if tail is not None else None)
    so, xllws = _outputs(state, full)
    return (f_new, so, t_new) + ((xllws,) if full else ())


def implsch_compact_plain(cfg, fl1, env2d, scal, *, full: bool = False):
    """The plain PyTorch chain on the compact (nang, nfre, n) spectrum:
    (fl1, stress6), or in full mode (fl1, scal_out (30, n), xllws); under
    u* forcing the U10 row after the mode's rows."""
    env, frc, stress = _unpack_inputs(cfg, env2d, scal)
    out, state = impl.implsch(cfg, fl1, env, frc, *stress)
    so, xllws = _outputs(state, full)
    return (out, so) + ((xllws,) if full else ())


def frcut_tie(cfg, f_srl, env2d, scal, tail, *, nang: int, nfre_red: int):
    """Per SRL row, the plain chain's distance of the FRCUTINDEX argument
    from its rounding tie (``frcut_tie`` of :func:`.implsch.implsch`)."""
    fl, env, frc, stress = srl_inputs(cfg, f_srl, env2d, scal, tail,
                                      nang=nang, nfre_red=nfre_red)
    return impl.implsch(cfg, fl, env, frc, *stress)[1]["frcut_tie"]


def gc_margin(cfg, f_srl, env2d, scal, tail, *, nang: int, nfre_red: int):
    """Per SRL row, the plain chain's decision margin of the
    gravity-capillary closure (``gc_margin`` of :func:`.implsch.implsch`;
    +inf without LLGCBZ0)."""
    fl, env, frc, stress = srl_inputs(cfg, f_srl, env2d, scal, tail,
                                      nang=nang, nfre_red=nfre_red)
    st = impl.implsch(cfg, fl, env, frc, *stress)[1]
    return st.get("gc_margin", torch.full_like(st["ufric"], torch.inf))


def xllws_margin(cfg, fl1, env2d, scal):
    """Per bin of the compact (nang, nfre, n) spectrum, the plain chain's
    signed distance of the windsea-mask test from its edge
    (``xllws_margin`` of :func:`.implsch.implsch`; the bit is set where it
    is positive)."""
    env, frc, stress = _unpack_inputs(cfg, env2d, scal)
    return impl.implsch(cfg, fl1, env, frc, *stress)[1]["xllws_margin"]


def _check(name, t, shape, device):
    if t.device != device or t.dtype != torch.float32:
        raise TypeError(f"{name}: {t.dtype} on {t.device}, expected "
                        f"torch.float32 on {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _no_kernel(t):
    if t.device.type != "cuda":
        raise ValueError(f"no physics kernel for device {t.device}")


def _lib(name: str = "implsch"):
    fn = _build.load(name).implsch_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 2
                       + [ctypes.c_long] * 2 + [ctypes.c_void_p] * 8
                       + [ctypes.c_int] * 9 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _launch(cfg, full, fin, fout, f_ps, f_bs, tin, tout, env2d, scal, *,
            nrows: int, nang: int, nfr: int, tables_dev):
    """Check the common inputs, allocate the outputs and launch
    ``implsch_launch``; returns (out rows, xllws or None)."""
    kernel_supports(cfg, full, compact=f_bs != 1)
    dev = fin.device
    nfre = cfg.tables.nfre
    _check("env2d", env2d, (len(ENV_FIELDS) * nfre, nrows), dev)
    _check("scal", scal, (len(SCAL_IN), nrows), dev)
    if tables_dev is None:
        tables_dev = pack_tables(cfg, dev)
    if tables_dev["tab"].device != dev:
        raise ValueError("physics tables on another device")
    opts = option_bits(cfg, full)
    if tables_dev["opts"] != opts & ~MODE_BITS:
        raise ValueError("physics tables packed for other options")
    keys = out_keys(cfg, full)
    out = torch.empty((len(keys), nrows), dtype=torch.float32, device=dev)
    xllws = (torch.empty((nang, nfre, nrows), dtype=torch.float32,
                         device=dev) if full else None)
    with torch.cuda.device(dev):
        err = _lib(library(cfg, full, f_bs != 1))(
            int(full), fin.data_ptr(), fout.data_ptr(), f_ps, f_bs,
            tin.data_ptr() if tin is not None else None,
            tout.data_ptr() if tout is not None else None,
            env2d.data_ptr(), scal.data_ptr(), out.data_ptr(),
            xllws.data_ptr() if full else None,
            tables_dev["tab"].data_ptr(), tables_dev["itab"].data_ptr(),
            nrows, nang, nfre, nfr, cfg.nfre_red, tables_dev["mlsthg"],
            tables_dev["niab"], tables_dev["nwav"], opts,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"implsch kernel launch failed: CUDA error {err}")
    return out, xllws


def implsch_srl(cfg, f_srl, env2d, scal, tail=None, *, nang: int,
                nfre_red: int, full: bool = False,
                tables_dev: dict | None = None):
    """One physics step on SRL rows (see the module docstring).  On CUDA
    the kernel updates ``f_srl`` and ``tail`` in place (as the TPU kernel
    aliases them) and returns them with the output rows (and xllws in
    full mode); ``tables_dev`` is :func:`pack_tables`' result, built here
    if None.  Counts its launches in ``implsch_srl.launches`` (minimal)
    and ``implsch_srl.full_launches``."""
    if f_srl.device.type == "cpu":
        return implsch_srl_plain(cfg, f_srl, env2d, scal, tail, nang=nang,
                                 nfre_red=nfre_red, full=full)
    _no_kernel(f_srl)
    nfre = cfg.tables.nfre
    if (nfre > nfre_red) != (tail is not None):
        raise ValueError("tail block required iff nfre > nfre_red")
    dev, nsrl = f_srl.device, f_srl.shape[0]
    _check("f_srl", f_srl, (nsrl, nang * nfre_red), dev)
    if tail is not None:
        _check("tail", tail, (nsrl, nang * (nfre - nfre_red)), dev)
    out, xllws = _launch(cfg, full, f_srl, f_srl, nang * nfre_red, 1, tail,
                         tail, env2d, scal, nrows=nsrl, nang=nang,
                         nfr=nfre_red, tables_dev=tables_dev)
    if full:
        implsch_srl.full_launches += 1
        return f_srl, out, tail, xllws
    implsch_srl.launches += 1
    return f_srl, out, tail


implsch_srl.launches = 0
implsch_srl.full_launches = 0


def implsch_compact(cfg, fl1, env2d, scal, *, full: bool = False,
                    tables_dev: dict | None = None, out=None):
    """One physics step on the compact (nang, nfre, n) spectrum, the
    counterpart of ``implsch_pallas``: (fl1_new, stress6; 7 rows under
    u*) or in full mode (fl1_new, scal_out (30, n; 31 under u*), xllws).  On CUDA the same
    kernel as :func:`implsch_srl` reads bin (k, m) of point p at
    (k·nfre + m)·s + p, where s is fl1's bin stride: fl1 may be a view of
    n points of a wider spectrum (a chunk, no copy), and ``out`` (a new
    spectrum by default) takes the result in fl1's layout; it may be fl1
    itself (in place: each point reads its bins before it writes them).
    On the CPU the plain version runs and is copied into ``out``."""
    if fl1.device.type == "cpu":
        res = implsch_compact_plain(cfg, fl1, env2d, scal, full=full)
        if out is not None:
            res = (out.copy_(res[0]),) + res[1:]
        return res
    _no_kernel(fl1)
    nang, nfre, n = cfg.tables.nang, cfg.tables.nfre, fl1.shape[-1]
    bs = _check_compact("fl1", fl1, (nang, nfre, n))
    if out is None:
        if bs != n:
            raise ValueError("a strided fl1 needs out= in its layout")
        out = torch.empty_like(fl1)
    elif out.stride() != fl1.stride():
        raise ValueError(f"out has strides {out.stride()}, fl1 "
                         f"{fl1.stride()}")
    _check_compact("out", out, (nang, nfre, n))
    rows, xllws = _launch(cfg, full, fl1, out, 1, bs, None, None, env2d,
                          scal, nrows=n, nang=nang, nfr=nfre,
                          tables_dev=tables_dev)
    implsch_compact.launches += 1
    return (out, rows) + ((xllws,) if full else ())


def _check_compact(name, t, shape) -> int:
    """A compact (nang, nfre, n) float32 tensor on the card whose points
    are contiguous and whose bins lie a stride s >= n apart (a whole
    spectrum or a view of n of its points); returns s."""
    if t.dtype != torch.float32 or t.device.type != "cuda":
        raise TypeError(f"{name}: {t.dtype} on {t.device}, expected "
                        "torch.float32 on the card")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    bs = t.stride(1)
    if t.stride(2) != 1 or t.stride(0) != shape[1] * bs or bs < shape[2]:
        raise ValueError(f"{name} has strides {t.stride()}: points must "
                         "be contiguous and bins a stride apart")
    return bs


implsch_compact.launches = 0
