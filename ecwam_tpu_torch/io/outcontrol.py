"""Output-parameter control: the FFLAG/GFLAG/NFLAG machinery.

Copied from ``ecwam_tpu/io/outcontrol.py`` (numpy only, no
JAX), with its imports pointed at ``ecwam_tpu_torch``: the port
imports nothing of the JAX package.

Re-derivation of the reference's integrated-parameter output control:

  - the 89-entry parameter registry (JPPFLAG = 75 + 3*NTRAIN + 5) with GRIB
    paramId, period bounds and masking attributes — MPCRTBL
    (mpcrtbl.F90:93-467, DEFINE_PARAMETER :560-586);
  - per-parameter file/GRIB/norm flags FFLAG/GFLAG/NFLAG, the active-output
    count NIPRMOUT, the parameter→output-slot map ITOBOUT and the
    parameter→writer-rank table IPFGTBL (mpcrtbl.F90:470-553);
  - the USERIN consistency rules: GRIB restarts force wind
    direction/CD/U10 output on (userin.F90:413-436), altimeter parameters
    off without assimilation (userin.F90:450-457), output interval must
    divide into the advection/physics steps (userin.F90:1683-1712);
  - the output masking pass OUTSETWMASK (outsetwmask.F90:58-76): sea-ice
    mask to missing, shallow/boundary points to missing.

Shape: a frozen registry + a small host-side control object.
The BOUT block array of the reference dissolves into the jitted product
catalog (io/products.py); this module decides *which* catalog entries run,
who writes them, and how they are masked afterwards.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ecwam_tpu_torch.core import constants as c

NTRAIN = 3                       # yowcout.F90:19
JPPFLAG = 75 + 3 * NTRAIN + 5    # yowcout.F90:20


@dataclasses.dataclass(frozen=True)
class ParamDef:
    """One row of the MPCRTBL registry (DEFINE_PARAMETER arguments)."""

    idx: int                 # 1-based parameter number
    name: str                # GRIB short name / catalog key
    paramid: int             # GRIB paramId (table*1000 + parameter)
    reflevel: int = 0        # GRIB reference level (m)
    tmin: int = 0            # min wave period for which defined (s)
    tmax: int = 0            # max wave period (s)
    ice_mask: bool = False   # sea-ice mask imposed on output
    shallow_missing: bool = False   # too-shallow points set to missing
    description: str = ""


def _p(idx, name, paramid, reflevel=0, tmin=0, tmax=0, ice=False,
       shal=False, desc=""):
    return ParamDef(idx, name, paramid, reflevel, tmin, tmax, ice, shal,
                    desc)


# mpcrtbl.F90:93-467 verbatim registry (IZLEV=10 is the wind reference
# height used for dwi/cdww/wind)
_IZLEV = 10
PARAMS: tuple = tuple([
    _p(1, "swh", 140229, 0, 0, 0, True, True, "SIGNIFICANT WAVE HEIGHT"),
    _p(2, "mwd", 140230, 0, 0, 0, True, True, "MEAN WAVE DIRECTION"),
    _p(3, "mwp", 140232, 0, 0, 0, True, True, "WAVE MEAN PERIOD (-1)"),
    _p(4, "ustar", 140084, 0, 0, 0, False, True, "FRICTION VELOCITY"),
    _p(5, "dwi", 140249, _IZLEV, 0, 0, False, False,
       "WAVE MODEL WIND DIRECTION"),
    _p(6, "pp1d", 140231, 0, 0, 0, True, True, "WAVE PEAK PERIOD"),
    _p(7, "cdww", 140233, _IZLEV, 0, 0, False, False, "DRAG COEFFICIENT"),
    _p(8, "tauw_over_ust2", 140083, 0, 0, 0, True, True,
       "NORMALISED WAVE STRESS"),
    _p(9, "msqs", 140244, 0, 0, 0, True, True, "MEAN SQUARE SLOPE"),
    _p(10, "wind", 140245, _IZLEV, 0, 0, False, False,
       "WAVE MODEL WIND SPEED"),
    _p(11, "shww", 140234, 0, 0, 0, True, True, "WIND SEA WAVE HEIGHT"),
    _p(12, "shts", 140237, 0, 0, 0, True, True, "TOTAL SWELL WAVE HEIGHT"),
    _p(13, "mdww", 140235, 0, 0, 0, True, True, "WIND SEA MEAN DIRECTION"),
    _p(14, "mdts", 140238, 0, 0, 0, True, True,
       "TOTAL SWELL WAVE MEAN DIRECTION"),
    _p(15, "mpww", 140236, 0, 0, 0, True, True, "WIND SEA MEAN PERIOD (-1)"),
    _p(16, "mpts", 140239, 0, 0, 0, True, True,
       "TOTAL SWELL MEAN PERIOD (-1)"),
    _p(17, "p017", 140246, 0, 0, 0, True, True, "ALTIMETER WAVE HEIGHT"),
    _p(18, "p018", 140247, 0, 0, 0, True, True, "CORRECTED ALT WAVE HEIGHT"),
    _p(19, "p019", 140248, 0, 0, 0, True, True,
       "ALTIMETER RANGE CORRECTION"),
    _p(20, "mp1", 140220, 0, 0, 0, True, True, "WAVE MEAN PERIOD (1)"),
    _p(21, "mp2", 140221, 0, 0, 0, True, True, "WAVE MEAN PERIOD (2)"),
    _p(22, "wdw", 140222, 0, 0, 0, True, True, "WAVE DIRECTIONAL SPREAD"),
    _p(23, "p1ww", 140223, 0, 0, 0, True, True, "WIND SEA MEAN PERIOD (1)"),
    _p(24, "p1ps", 140226, 0, 0, 0, True, True,
       "TOTAL SWELL MEAN PERIOD (1)"),
    _p(25, "p2ww", 140224, 0, 0, 0, True, True, "WIND SEA MEAN PERIOD (2)"),
    _p(26, "p2ps", 140227, 0, 0, 0, True, True,
       "TOTAL SWELL MEAN PERIOD (2)"),
    _p(27, "dwww", 140225, 0, 0, 0, True, True,
       "WIND SEA DIRECTIONAL SPREAD"),
    _p(28, "dwps", 140228, 0, 0, 0, True, True,
       "TOTAL SWELL DIRECTIONAL SPREAD"),
    _p(29, "wsk", 140252, 0, 0, 0, True, True, "WAVE SPECTRAL KURTOSIS"),
    _p(30, "bfi", 140253, 0, 0, 0, True, True, "BENJAMIN-FEIR INDEX"),
    _p(31, "wsp", 140254, 0, 0, 0, True, True, "WAVE SPECTRAL PEAKEDNESS"),
    _p(32, "wmb", 140219, 0, 0, 0, False, True, "BATHYMETRY"),
    _p(33, "hmax", 140218, 0, 0, 0, True, True,
       "ENVELOP MAXIMUM WAVE HEIGHT"),
    _p(34, "tmax", 140217, 0, 0, 0, True, True, "MAXIMUM WAVE PERIOD"),
    _p(35, "ust", 140215, 0, 0, 0, True, True,
       "U-COMP SURFACE STOKES DRIFT"),
    _p(36, "vst", 140216, 0, 0, 0, True, True,
       "V-COMP SURFACE STOKES DRIFT"),
    _p(37, "ocu", 262140, 0, 0, 0, False, True, "U-COMP SURFACE CURRENT"),
    _p(38, "vcu", 262139, 0, 0, 0, False, True, "V-COMP SURFACE CURRENT"),
    _p(39, "p039", 140212, 0, 0, 0, False, True,
       "NORMALISED ENERGY FLUX TO OCEAN"),
    _p(40, "p040", 140211, 0, 0, 0, False, True,
       "NORMALISED ENERGY FLUX TO WAVES"),
    _p(41, "p041", 140214, 0, 0, 0, False, True,
       "NORMALISED MOMENTUM FLUX TO OCEAN"),
    _p(42, "p042", 140121, 0, 0, 0, True, True,
       "SWELL PARTITION 1 WAVE HEIGHT"),
    _p(43, "p043", 140122, 0, 0, 0, True, True,
       "SWELL PARTITION 1 DIRECTION"),
    _p(44, "p044", 140123, 0, 0, 0, True, True,
       "SWELL PARTITION 1 MEAN PERIOD"),
    _p(45, "p045", 140124, 0, 0, 0, True, True,
       "SWELL PARTITION 2 WAVE HEIGHT"),
    _p(46, "p046", 140125, 0, 0, 0, True, True,
       "SWELL PARTITION 2 DIRECTION"),
    _p(47, "p047", 140126, 0, 0, 0, True, True,
       "SWELL PARTITION 2 MEAN PERIOD"),
    _p(48, "p048", 140127, 0, 0, 0, True, True,
       "SWELL PARTITION 3 WAVE HEIGHT"),
    _p(49, "p049", 140128, 0, 0, 0, True, True,
       "SWELL PARTITION 3 DIRECTION"),
    _p(50, "p050", 140129, 0, 0, 0, True, True,
       "SWELL PARTITION 3 MEAN PERIOD"),
    _p(51, "p051", 140210, 0, 0, 0, False, True,
       "MEAN SQUARE STRAIN IN ICE"),
    _p(52, "p052", 140120, 0, 10, 0, True, True,
       "WAVE HEIGHT WITH PERIOD > 10s"),
    _p(53, "p053", 140209, 0, 0, 0, False, False, "SURFACE AIR DENSITY"),
    _p(54, "p054", 140208, 0, 0, 0, False, False,
       "CONVECTIVE VELOCITY SCALE"),
    _p(55, "ci", 128031, 0, 0, 0, False, True, "SEA ICE COVER"),
    _p(56, "p056", 262000, 0, 0, 0, False, True, "SEA ICE THICKNESS"),
    _p(57, "p057", 140207, 0, 0, 0, True, True, "SPECTRAL SKEWNESS"),
    _p(58, "sic", 3091, 0, 0, 0, False, False, "NEMO SEA ICE COVER"),
    _p(59, "p059", 3092, 0, 0, 0, False, False, "NEMO SEA ICE THICKNESS"),
    _p(60, "ucurr", 3049, 0, 0, 0, False, False, "NEMO ZONAL CURRENT"),
    _p(61, "vcurr", 3050, 0, 0, 0, False, False, "NEMO MERIDIONAL CURRENT"),
    _p(62, "p062", 140112, 0, 0, 0, True, True,
       "WAVE ENERGY FLUX MAGNITUDE"),
    _p(63, "p063", 140113, 0, 0, 0, True, True,
       "WAVE ENERGY FLUX DIRECTION"),
    _p(64, "p064", 140114, 0, 10, 12, True, True,
       "SIG. WAVE HEIGHT 10<=T<=12"),
    _p(65, "p065", 140115, 0, 12, 14, True, True,
       "SIG. WAVE HEIGHT 12<=T<=14"),
    _p(66, "p066", 140116, 0, 14, 17, True, True,
       "SIG. WAVE HEIGHT 14<=T<=17"),
    _p(67, "p067", 140117, 0, 17, 21, True, True,
       "SIG. WAVE HEIGHT 17<=T<=21"),
    _p(68, "p068", 140118, 0, 21, 25, True, True,
       "SIG. WAVE HEIGHT 21<=T<=25"),
    _p(69, "p069", 140119, 0, 25, 30, True, True,
       "SIG. WAVE HEIGHT 25<=T<=30"),
    _p(70, "p070", 140098, 0, 0, 0, True, True,
       "WAVE INDUCED SEA LEVEL CORRECTION"),
    _p(71, "p071", 140099, 0, 0, 0, True, True, "SPECTRAL WIDTH INDEX"),
    _p(72, "p072", 140100, 0, 0, 0, True, True,
       "NUMBER OF FREAK WAVES EVENT"),
    _p(73, "p073", 140101, 0, 0, 0, False, True,
       "U-COMP ATMOSPHERIC STRESS"),
    _p(74, "p074", 140102, 0, 0, 0, False, True,
       "V-COMP ATMOSPHERIC STRESS"),
    _p(75, "p075", 140103, 0, 0, 0, False, True,
       "U-COMP STRESS INTO OCEANS"),
    _p(76, "p076", 140104, 0, 0, 0, False, True,
       "V-COMP STRESS INTO OCEANS"),
    _p(77, "p077", 140105, 0, 0, 0, False, True,
       "TURB ENERGY FLUX INTO OCEANS"),
    _p(78, "tdcmax", 140131, 0, 0, 0, True, True,
       "TIME DOMAIN MAXIMUM CREST HEIGHT"),
    _p(79, "tdhmax", 140132, 0, 0, 0, True, True,
       "TIME DOMAIN MAXIMUM WAVE HEIGHT"),
    _p(80, "stcmax", 140133, 0, 0, 0, True, True,
       "SPACE TIME MAXIMUM CREST HEIGHT"),
    _p(81, "sthmax", 140134, 0, 0, 0, True, True,
       "SPACE TIME MAXIMUM WAVE HEIGHT"),
    _p(82, "sibm", 262025, 0, 0, 0, True, True, "SEA ICE BREAK UP MEMORY"),
    _p(83, "xwrs", 140149, 0, 0, 0, True, True,
       "U-COMP WAVE RADIATIVE STRESS TO SEA ICE"),
    _p(84, "ywrs", 140150, 0, 0, 0, True, True,
       "V-COMP WAVE RADIATIVE STRESS TO SEA ICE"),
] + [
    # 5 spare extra fields (mpcrtbl.F90:464-469)
    _p(JPPFLAG - 5 + i, f"{JPPFLAG - 5 + i:03d}", 140079 + i, 0, 0, 0,
       False, False, f"EXTRA_FIELD {JPPFLAG - 5 + i:03d}")
    for i in range(1, 6)
])

BY_NAME = {p.name: p for p in PARAMS}
BY_IDX = {p.idx: p for p in PARAMS}

# catalog aliases accepted in configs (products.py keeps both spellings)
_ALIASES = {"mwp1": "mp1", "mwp2": "mp2", "mss": "msqs"}

# restart-required GRIB fields (userin.F90:413-436): wind direction, drag
# coefficient, wind speed must be encoded so BUILDSTRESS can reconstruct
# the LAW* state from GRIB output
_RESTART_REQUIRED = ("dwi", "cdww", "wind")
_ALTIMETER = ("p017", "p018", "p019")


class OutputControl:
    """Resolved per-parameter output flags for one run.

    fflag: binary/file output; gflag: GRIB output; nflag: norms in
    statistics.log; uflag: user-requested (any of the above).
    """

    def __init__(self, fflag, gflag, nflag, *, nproc: int = 1,
                 nwrtoutwam: int = 1, lfdb: bool = False):
        self.fflag = np.asarray(fflag, bool).copy()
        self.gflag = np.asarray(gflag, bool).copy()
        self.nflag = np.asarray(nflag, bool).copy()
        for a in (self.fflag, self.gflag, self.nflag):
            if a.shape != (JPPFLAG,):
                raise ValueError("flag arrays must have shape (JPPFLAG,)")
        self.uflag = self.fflag | self.gflag | self.nflag

        # NIPRMOUT / ITOBOUT / IPFGTBL (mpcrtbl.F90:470-553)
        itobout = np.zeros(JPPFLAG, dtype=np.int32)
        ipfgtbl = np.zeros(JPPFLAG + 1, dtype=np.int32)
        n = 0
        ir = 1
        for i in range(JPPFLAG):
            if self.uflag[i]:
                if self.fflag[i]:
                    ipfgtbl[i] = 1            # non-GRIB → rank 1
                elif self.gflag[i]:
                    if lfdb:
                        ipfgtbl[i] = ir       # round-robin writer ranks
                        ir += nwrtoutwam
                        if ir > nproc:
                            ir = 1
                    else:
                        ipfgtbl[i] = 1
                else:
                    ipfgtbl[i] = -1           # norms-only, no writer
                n += 1
                itobout[i] = n
            # else both stay 0
        ipfgtbl[JPPFLAG] = 1                  # restart writer (":548")
        self.itobout = itobout
        self.ipfgtbl = ipfgtbl
        self.niprmout = n

    # ---- constructors -----------------------------------------------------
    @classmethod
    def from_names(cls, names, *, fmt: str = "grib", norms=None,
                   nproc: int = 1, nwrtoutwam: int = 1, lfdb: bool = False,
                   grib_restart: bool = False, iassi: int = 0):
        """Build flags from a config field list (the YAML `fields:` block).

        ``fmt``: 'grib' sets GFLAG, 'binary' sets FFLAG for every listed
        field.  ``norms``: field names to include in statistics.log;
        defaults to every listed field (NFLAG).  USERIN consistency rules
        are then applied.
        """
        fflag = np.zeros(JPPFLAG, bool)
        gflag = np.zeros(JPPFLAG, bool)
        nflag = np.zeros(JPPFLAG, bool)

        def resolve(nm):
            nm = _ALIASES.get(nm, nm)
            p = BY_NAME.get(nm)
            if p is None:
                raise KeyError(f"unknown output parameter {nm!r}")
            return p.idx - 1

        for nm in names:
            i = resolve(nm)
            (gflag if fmt == "grib" else fflag)[i] = True
        for nm in (names if norms is None else norms):
            nflag[resolve(nm)] = True

        # USERIN rules
        if grib_restart:
            for nm in _RESTART_REQUIRED:      # userin.F90:413-436
                gflag[BY_NAME[nm].idx - 1] = True
        if iassi != 1:                        # userin.F90:450-457
            for nm in _ALTIMETER:
                gflag[BY_NAME[nm].idx - 1] = False
                fflag[BY_NAME[nm].idx - 1] = False

        return cls(fflag, gflag, nflag, nproc=nproc,
                   nwrtoutwam=nwrtoutwam, lfdb=lfdb)

    # ---- queries ----------------------------------------------------------
    def _names(self, mask):
        return tuple(p.name for p in PARAMS if mask[p.idx - 1])

    def output_names(self):
        """Every parameter that must be computed into the output block
        (BOUT role): FFLAG | GFLAG | NFLAG, in registry order."""
        return self._names(self.uflag)

    def file_names(self):
        return self._names(self.fflag)

    def grib_names(self):
        return self._names(self.gflag)

    def norm_names(self):
        return self._names(self.nflag)

    def writer_rank(self, name: str) -> int:
        """0-based writer rank for a field (IPFGTBL), -1 if norms-only."""
        r = int(self.ipfgtbl[BY_NAME[_ALIASES.get(name, name)].idx - 1])
        return r - 1 if r > 0 else r

    # ---- validation (userin.F90:1683-1712) ---------------------------------
    def check_output_interval(self, idelint: float, idelpro: float,
                              idelt: float):
        """Output cadence must be a positive multiple of both the
        advection and the physics timestep."""
        if (self.fflag.any() or self.gflag.any()):
            if idelint <= 0:
                raise ValueError("output requested but output interval <= 0")
            if idelint % idelpro != 0:
                raise ValueError(
                    f"output interval {idelint} not a multiple of the "
                    f"advection step {idelpro}")
            if idelint % idelt != 0:
                raise ValueError(
                    f"output interval {idelint} not a multiple of the "
                    f"physics step {idelt}")


def apply_output_masks(fields: dict, *, cicover=None, iodp=None,
                       licerun: bool = False, llsource: bool = True,
                       cithrsh: float = 0.3) -> dict:
    """OUTSETWMASK (outsetwmask.F90:58-76): set ice-covered points of
    ice-masked parameters and non-open points of shallow-masked parameters
    to ZMISS.  Host-side NumPy at output cadence.

    ``iodp``: open-depth mask (1=normal sea point, 0=boundary/dry), the
    YOWSHAL IODP table; defaults to all-open.
    """
    out = {}
    for name, vals in fields.items():
        p = BY_NAME.get(_ALIASES.get(name, name))
        v = np.asarray(vals, np.float64).copy()
        if p is not None:
            if (licerun and llsource and p.ice_mask
                    and cicover is not None):
                v[np.asarray(cicover)[: v.shape[0]] > cithrsh] = c.ZMISS
            if p.shallow_missing and iodp is not None:
                m = np.asarray(iodp)[: v.shape[0]].astype(np.float64)
                v = v * m + (1.0 - m) * c.ZMISS
        out[name] = v
    return out
