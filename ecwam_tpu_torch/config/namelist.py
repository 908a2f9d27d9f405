"""Fortran-namelist user interface: the MPUSERIN surface.

Copied from ``ecwam_tpu/config/namelist.py`` (numpy only, no
JAX), with its imports pointed at ``ecwam_tpu_torch``: the port
imports nothing of the JAX package.

The reference model is configured through Fortran namelists read by
MPUSERIN (src/ecwam/mpuserin.F90:178-262): the big
``&NALINE`` group (~170 variables spanning grid setup, timesteps,
physics options, output flags, GRIB headers, coupling and assimilation
switches) plus the repeatable date groups ``&NAOT`` (field-output
dates), ``&NAOS`` (restart/spectra dates), ``&NAAT`` (analysis output
dates), ``&NAWI`` (wind input/output date + steps) and ``&NAOUTP``
(point-output coordinates).

This module gives this build the same user surface:

  * :func:`parse_namelist` — a tolerant parser for the Fortran namelist
    syntax actually used by the reference run scripts (groups, scalar
    and array values, ``n*value`` repeats, ``VAR(i)=`` indexed sets,
    ``.TRUE./.F./T`` logicals, quoted strings, ``!`` comments,
    repeated groups collected in file order).
  * :data:`NALINE_VARS` — the full registry of NALINE variables with
    their kinds, so every reference namelist parses and every variable
    is classified (mapped / accepted-no-op / rejected) instead of
    silently ignored.
  * :func:`namelist_to_config` — maps the parsed surface onto the
    native :class:`ecwam_tpu.config.schema.RunConfig` + the
    FFLAG/GFLAG/NFLAG output-control vectors + explicit output/restart/
    wind/point-output date lists, mirroring USERIN's post-processing
    (userin.F90 date-list defaulting from IDELINT/IDELRES).
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
import re

from ecwam_tpu_torch.config import schema

# ---------------------------------------------------------------------------
# parser
# ---------------------------------------------------------------------------

_TOK = re.compile(
    r"""
    \s*(?:
      (?P<comment>![^\n]*) |
      (?P<end>/|(?i:\$END|&END)(?![A-Za-z0-9_])) |
      (?P<begin>&[A-Za-z_][A-Za-z0-9_]*) |
      (?P<name>[A-Za-z_][A-Za-z0-9_%]*(?:\(\s*\d+\s*(?:,\s*\d+\s*)*\))?\s*=) |
      (?P<str>'(?:[^']|'')*'|"(?:[^"]|"")*") |
      (?P<val>[^\s,!/]+) |
      (?P<sep>,)
    )
    """,
    re.VERBOSE,
)

_LOGICAL = {"T": True, ".TRUE.": True, "TRUE": True,
            "F": False, ".FALSE.": False, "FALSE": False}


def _coerce(tok: str):
    """One namelist value token → python value."""
    if len(tok) >= 2 and tok[0] in "'\"" and tok[-1] == tok[0]:
        return tok[1:-1].replace(tok[0] * 2, tok[0])   # n*'H' repeats
    up = tok.upper().rstrip(",")
    if up in _LOGICAL:
        return _LOGICAL[up]
    try:
        return int(tok)
    except ValueError:
        pass
    try:
        # Fortran exponents: 1.D0 / 2.5E+1
        return float(tok.upper().replace("D", "E"))
    except ValueError:
        pass
    return tok


def parse_namelist(text: str) -> dict:
    """Parse namelist text → {group: [instance, ...]} (lowercase keys).

    Each instance is a dict; arrays become lists; ``VAR(i)=v`` sets
    1-based element i of a list.  Groups repeat in file order (the
    reference reads &NAOT/&NAOS/&NAWI/&NAOUTP in loops until EOF,
    mpuserin.F90:249-262).
    """
    groups: dict[str, list] = {}
    cur: dict | None = None
    cur_name: str | None = None
    pending: str | None = None          # variable awaiting values
    pend_idx: int | None = None
    vals: list = []

    def flush():
        nonlocal pending, pend_idx, vals
        if pending is None:
            return
        if pend_idx is not None:
            arr = cur.setdefault(pending, [])
            if not isinstance(arr, list):
                arr = [arr]
                cur[pending] = arr
            while len(arr) < pend_idx + len(vals):
                arr.append(None)
            for j, v in enumerate(vals):
                arr[pend_idx + j] = v
        elif len(vals) == 1:
            cur[pending] = vals[0]
        else:
            cur[pending] = list(vals)
        pending, pend_idx, vals = None, None, []

    for m in _TOK.finditer(text):
        kind = m.lastgroup
        tok = m.group(kind)
        if kind == "comment":
            continue
        if kind == "begin":
            cur_name = tok[1:].lower()
            cur = {}
            continue
        if cur is None:
            continue
        if kind == "end":
            flush()
            groups.setdefault(cur_name, []).append(cur)
            cur, cur_name = None, None
            continue
        if kind == "name":
            flush()
            head = tok[:-1].strip()
            if "(" in head:
                base, idx = head[:-1].split("(")
                pending = base.strip().lower()
                pend_idx = int(idx.split(",")[0]) - 1
            else:
                pending = head.lower()
                pend_idx = None
            continue
        if kind == "str":
            q = tok[0]
            vals.append(tok[1:-1].replace(q + q, q))
            continue
        if kind == "val":
            if "*" in tok and not tok.startswith("*"):
                n, _, v = tok.partition("*")
                try:
                    vals.extend([_coerce(v)] * int(n))
                    continue
                except ValueError:
                    pass
            vals.append(_coerce(tok))
            continue
    if cur is not None:                  # unterminated group: accept
        flush()
        groups.setdefault(cur_name, []).append(cur)
    return groups


# ---------------------------------------------------------------------------
# the NALINE variable registry (mpuserin.F90:178-247)
# ---------------------------------------------------------------------------
# kind: i int, f float, b bool, s str, xa array of x.
# class: 'map'    — drives the model configuration
#        'accept' — recognized, recorded in extras, no model effect here
#                   (GRIB headers, ecFlow/ODB/assimilation, NEMO switches,
#                   SWAMP-case knobs, legacy/unused)
#        'reject' — asking for a subsystem this build does not run
_M, _A, _R = "map", "accept", "reject"

NALINE_VARS = {
    # header / domain / spectral setup
    "clheader": ("s", _A), "cldomain": ("s", _A),
    "nang": ("i", _M), "ifre1": ("i", _M), "fr1": ("f", _M),
    "nfre": ("i", _M), "nfre_red": ("i", _M),
    # dates
    "cbpltdt": ("s", _M), "cepltdt": ("s", _M), "cdatef": ("s", _M),
    # timesteps
    "ifrelfmax": ("i", _M), "delpro_lf": ("f", _M), "idelpro": ("i", _M),
    "idelt": ("i", _M), "idelwo": ("i", _M), "idelwi": ("i", _M),
    "clmtsu": ("sa", _M), "idelalt": ("i", _A), "idelint": ("i", _M),
    "idelres": ("i", _M), "idelcur": ("i", _M), "cdatecura": ("s", _M),
    "llcflcuroff": ("b", _M), "clotsu": ("sa", _M),
    "cdater": ("s", _M), "cdates": ("s", _M),
    # output flags
    "fflag": ("ba", _M), "gflag": ("ba", _M), "nflag": ("ba", _M),
    "xkmss_cutoff": ("f", _M),
    "lfdb": ("b", _A), "lgribin": ("b", _M), "lgribout": ("b", _M),
    "lfdbioout": ("b", _A), "lrstparalw": ("b", _M),
    "lrstparalr": ("b", _M), "lrstinfdat": ("b", _M),
    "lwamanout": ("b", _A), "nwrtoutwam": ("i", _M),
    "lsecondorder": ("b", _M),
    # model options
    "icase": ("i", _M), "ishallo": ("i", _A), "itest": ("i", _A),
    "itestb": ("i", _A), "irest": ("i", _M), "iassi": ("i", _A),
    "ipropags": ("i", _M), "irefra": ("i", _M), "iphys": ("i", _M),
    "isnonlin": ("i", _M), "idamping": ("i", _M), "lbiwbk": ("b", _M),
    "lmaskice": ("b", _M), "lwamrsetci": ("b", _A),
    "ndepth": ("i", _M), "r8_deptha": ("f", _M), "r8_depthd": ("f", _M),
    "deptha": ("f", _M), "depthd": ("f", _M), "tooshallow": ("f", _M),
    # boundary nesting
    "ibounc": ("i", _M), "ibounf": ("i", _M), "idelbc": ("i", _M),
    "cbcpref": ("s", _M),
    # paths / GRIB headers
    "userid": ("s", _A), "runid": ("s", _A), "path": ("s", _A),
    "yclass": ("s", _A), "yexpver": ("s", _A), "cpath": ("s", _M),
    "ngrib_version": ("i", _M),
    "nensfnb": ("i", _A), "ntotens": ("i", _A), "nsysnb": ("i", _A),
    "nmetnb": ("i", _A),
    # coupling
    "lwcou": ("b", _A), "lwcouast": ("b", _A), "lnocdin": ("b", _A),
    "lodbralt": ("b", _A),
    # altimeter / SAR assimilation (stubbed in the reference too,
    # yowassi.F90:23-29)
    "laltcor": ("b", _A), "l4vtype": ("b", _A), "lfrstfld": ("b", _M),
    "laltas": ("b", _A), "lsaras": ("b", _A), "lsarinv": ("b", _A),
    "xkappa2": ("f", _A), "ibufrsat": ("ia", _A), "csatname": ("sa", _A),
    # SWAMP idealized-case knobs
    "swampwind": ("f", _A), "swampwind2": ("f", _A),
    "swampcifr": ("f", _A), "swampcith": ("f", _A),
    "dtnewwind": ("f", _A), "lturn90": ("b", _A),
    "laltlrgr": ("b", _A), "hscoefcor": ("f", _A), "hsconscor": ("f", _A),
    "altsdthrsh": ("f", _A), "altbgthrsh": ("f", _A),
    "altgrthrsh": ("f", _A), "hsaltcut": ("f", _A),
    "istream": ("i", _A), "nlocgrb": ("i", _A), "irefdate": ("i", _A),
    "nconsensus": ("i", _A), "ndwd": ("i", _A), "nmfr": ("i", _A),
    "nncep": ("i", _A), "nukm": ("i", _A),
    "lgust": ("b", _A), "laden": ("b", _A), "lrelwind": ("b", _A),
    "laltgrdout": ("b", _A), "lsubgrid": ("b", _M), "laltpas": ("b", _A),
    "llsource": ("b", _M), "lnsestart": ("b", _A),
    # UNWAM (aborts in the reference main path, propag_wam.F90:150-157)
    "llunstr": ("b", _R), "lpreproc": ("b", _A), "lvector": ("b", _A),
    "ivector": ("i", _A), "wae_solverthr": ("f", _A),
    "jgs_diff_solverthr": ("f", _A), "limplicit": ("b", _A),
    "source_impl": ("b", _A), "lnonl": ("b", _A),
    "block_gauss_seidel": ("b", _A), "llimt": ("b", _A),
    "l_solver_norm": ("b", _A), "lchkconv": ("b", _A), "lbcwa": ("b", _A),
    # ecFlow meters
    "lsmssig_wam": ("b", _A), "cmeter": ("s", _A), "cevent": ("s", _A),
    "llwswave": ("b", _A), "llwdwave": ("b", _A),
    # blocking / norms
    "nproma_wam": ("i", _M), "ll1d": ("b", _A), "lgrhdifs": ("b", _A),
    "lnewlvtp": ("b", _A), "ll_grid_simple_matrix": ("b", _A),
    "llrstgribparam": ("b", _M),
    "lwcounorms": ("b", _A), "llnormifs2wam": ("b", _A),
    "llnormwam2ifs": ("b", _A), "llnormwamout": ("b", _M),
    "llnormwamout_global": ("b", _M), "cnormwamout_file": ("s", _M),
    # sea ice
    "licerun": ("b", _M), "lciwa1": ("b", _M), "lciwa2": ("b", _M),
    "lciwa3": ("b", _M), "lciscal": ("b", _M), "liceth": ("b", _M),
    "zalpfacb": ("f", _A), "zalpfacx": ("f", _A), "zalpwrs": ("f", _A),
    "zibrw_thrsh": ("f", _A), "lwvflx_snl": ("b", _A),
    # NEMO coupling switches (surface exists, coupling.py; the I/O
    # server transport does not run here)
    "lwnemocou": ("b", _A), "nemofrco": ("i", _A),
    "lwnemocousend": ("b", _A), "lwnemocoustk": ("b", _A),
    "lwnemocoustrn": ("b", _A), "lwnemocouwrs": ("b", _A),
    "lwnemotauoc": ("b", _A), "lwnemocourecv": ("b", _A),
    "lwnemocoucic": ("b", _A), "lwnemocoucit": ("b", _A),
    "lwnemocoucur": ("b", _A), "lwnemocouibr": ("b", _A),
    "lwnemocoudebug": ("b", _A),
    # stress closure options
    "llcapchnk": ("b", _M), "llgcbz0": ("b", _M), "llnormagam": ("b", _M),
    "lwam_use_io_serv": ("b", _A), "loutmdldcp": ("b", _A),
    # physical constants overrides
    "roair": ("f", _M), "rowater": ("f", _M), "gam_surf": ("f", _A),
    "imdlgrbid_g": ("i", _A), "imdlgrbid_m": ("i", _A),
    # wind file
    "cwdfile": ("s", _A), "rwfac": ("f", _A),
    "idelwi_lst": ("ia", _A), "idelwo_lst": ("ia", _A),
    "cdtw_lst": ("sa", _A), "ndelw_lst": ("i", _A),
}


def _step_unit(units, i) -> float:
    """CLMTSU/CLOTSU step-unit factor ('S' seconds, 'H' hours)."""
    if not units:
        return 1.0
    if isinstance(units, str):
        u = units
    else:
        u = units[min(i, len(units) - 1)] or "S"
    return 3600.0 if str(u).strip().upper().startswith("H") else 1.0


def _date(s):
    if s is None:
        return None
    s = str(s).strip()
    if not s or set(s) == {"0"}:
        return None
    return _dt.datetime.strptime(s.ljust(14, "0"), schema.DATE_FMT)


@dataclasses.dataclass
class NamelistConfig:
    """Everything MPUSERIN would have set, in native form."""

    run: schema.RunConfig
    flags: dict                 # fflag/gflag/nflag lists (or None)
    output_dates: list          # explicit &NAOT dates
    restart_dates: list         # explicit &NAOS dates
    analysis_dates: list        # explicit &NAAT dates
    wind_dates: list            # (date, idelwi, idelwo) from &NAWI
    point_outputs: list         # (lat, lon) from &NAOUTP
    extras: dict                # accepted-but-inert variables, verbatim
    warnings: list


def namelist_to_config(text: str) -> NamelistConfig:
    """Parse a reference namelist file into the native configuration.

    Unknown NALINE variables raise; 'reject'-class variables raise when
    enabled; 'accept'-class variables are recorded in ``extras`` with a
    warning so nothing is silently dropped.
    """
    g = parse_namelist(text)
    nl = {}
    for inst in g.get("naline", []):
        nl.update(inst)

    warnings, extras = [], {}
    for k, v in list(nl.items()):
        if k not in NALINE_VARS:
            raise ValueError(f"unknown NALINE variable {k.upper()!r}")
        kind, cls = NALINE_VARS[k]
        if cls == _R and v:
            raise ValueError(
                f"{k.upper()} requests a subsystem this build does not "
                "run (UNWAM aborts in the reference main path too)")
        if cls == _A:
            extras[k] = v
            warnings.append(f"{k.upper()} accepted but has no effect")

    begin = _date(nl.get("cbpltdt"))
    end = _date(nl.get("cepltdt"))
    if begin is None or end is None:
        raise ValueError("NALINE must set CBPLTDT and CEPLTDT")

    mts = nl.get("clmtsu")
    idelpro = float(nl.get("idelpro", 900)) * _step_unit(mts, 0)
    idelt = float(nl.get("idelt", idelpro)) * _step_unit(mts, 1)
    # unit-scale the raw user values only; missing variables default
    # from the already-converted seconds values (mpuserin.F90:1020-1023)
    idelwi = (float(nl["idelwi"]) * _step_unit(mts, 3)
              if "idelwi" in nl else idelt)
    idelwo = (float(nl["idelwo"]) * _step_unit(mts, 2)
              if "idelwo" in nl else idelwi)
    ots = nl.get("clotsu")
    idelint = float(nl.get("idelint", 0)) * _step_unit(ots, 0)
    idelres = float(nl.get("idelres", 0)) * _step_unit(ots, 1)

    ifrelfmax = int(nl.get("ifrelfmax", 0))
    raw = {
        "grid": str(nl.get("cldomain", "g")).strip(),
        "directions": int(nl.get("nang", 24)),
        "frequencies": int(nl.get("nfre", 29)),
        **({"nfre_red": int(nl["nfre_red"])} if "nfre_red" in nl else {}),
        "begin": begin.strftime(schema.DATE_FMT),
        "end": end.strftime(schema.DATE_FMT),
        "advection": {"timestep": idelpro},
        "physics": {"timestep": idelt},
        "iphys": int(nl.get("iphys", 1)),
        "irefra": int(nl.get("irefra", 0)),
        "llgcbz0": bool(nl.get("llgcbz0", False)),
        "llnormagam": bool(nl.get("llnormagam", False)),
        "llcapchnk": bool(nl.get("llcapchnk", False)),
        "lciwa3": bool(nl.get("lciwa3", False)),
        "lciscal": bool(nl.get("lciscal", False)),
        "lsecondorder": bool(nl.get("lsecondorder", True)),
        "nproma": int(nl.get("nproma_wam", 32)),
    }
    if ifrelfmax > 0:
        raw["advection"]["fast_waves"] = {
            "timestep": float(nl.get("delpro_lf", idelpro)),
            "max_frequency": ifrelfmax}
    if nl.get("idelcur"):
        raw["currents"] = {
            "input_step": float(nl["idelcur"]) * _step_unit(mts, 1)}

    # forcing window over the whole run at IDELWI
    if idelwi > 0:
        raw["forcings"] = {"at": [{
            "begin": begin.strftime(schema.DATE_FMT),
            "end": end.strftime(schema.DATE_FMT),
            "timestep": idelwi}]}

    # field output: explicit &NAOT dates win over IDELINT cadence
    out_dates = [d for d in
                 (_date(i.get("clout")) for i in g.get("naot", []))
                 if d is not None]
    rst_dates = [d for d in
                 (_date(i.get("clsout")) for i in g.get("naos", []))
                 if d is not None]
    ana_dates = [d for d in
                 (_date(i.get("claout")) for i in g.get("naat", []))
                 if d is not None]
    wind_dates = [( _date(i.get("clwout")),
                    float(i.get("idwi", idelwi)),
                    float(i.get("idwo", idelwo)))
                  for i in g.get("nawi", [])]
    points = [(float(i.get("zoutlat", 0.0)), float(i.get("zoutlong", 0.0)))
              for i in g.get("naoutp", [])]

    fmt = "grib" if bool(nl.get("lgribout", True)) else "binary"
    # FFLAG/GFLAG select the output field set (userin.F90 → MPCRTBL);
    # map set bits to registry names so the run loop outputs them
    field_names: list = []
    for key in ("gflag", "fflag"):
        v = nl.get(key)
        if v is None:
            continue
        from ecwam_tpu_torch.io import outcontrol as _oc
        bits = [bool(x) for x in (v if isinstance(v, list) else [v])]
        for p in _oc.PARAMS:
            if p.idx - 1 < len(bits) and bits[p.idx - 1] \
                    and p.name not in field_names:
                field_names.append(p.name)
    if out_dates:
        # explicit &NAOT dates win over the IDELINT cadence
        # (mpuserin.F90:249-262): one zero-length window per date
        raw["output"] = {"fields": {
            "name": field_names, "format": fmt,
            "at": [{"begin": d.strftime(schema.DATE_FMT),
                    "end": d.strftime(schema.DATE_FMT),
                    "timestep": 1} for d in sorted(set(out_dates))]}}
    elif idelint > 0:
        raw["output"] = {"fields": {
            "name": field_names, "format": fmt,
            "at": [{"timestep": idelint}]}}
    rst = {}
    if rst_dates:
        rst = {"at": [{"time": d.strftime(schema.DATE_FMT)}
                      for d in rst_dates]}
    elif idelres > 0 and int(nl.get("irest", 1)):
        last = _date(nl.get("cdater")) or end
        rst = {"at": [{"time": last.strftime(schema.DATE_FMT)}]}
    if rst:
        rst["format"] = "grib" if bool(nl.get("lgribout", True)) \
            else "binary"
        raw.setdefault("output", {})["restart"] = rst

    run = schema.RunConfig.from_dict(raw)

    def _flags(key):
        v = nl.get(key)
        if v is None:
            return None
        return [bool(x) for x in (v if isinstance(v, list) else [v])]

    flags = {"fflag": _flags("fflag"), "gflag": _flags("gflag"),
             "nflag": _flags("nflag")}
    for k in ("ndepth", "deptha", "depthd", "r8_deptha", "r8_depthd",
              "tooshallow", "xkmss_cutoff", "roair", "rowater",
              "isnonlin", "idamping", "lbiwbk", "lmaskice", "licerun",
              "lciwa1", "lciwa2", "liceth", "icase", "ipropags",
              "nwrtoutwam", "lgribin", "lrstparalw", "lrstparalr",
              "lrstinfdat", "llcflcuroff", "cpath", "ngrib_version",
              "llnormwamout", "llnormwamout_global", "cnormwamout_file",
              "llrstgribparam", "lfrstfld", "llsource", "lsubgrid",
              "irest", "ibounc", "ibounf", "idelbc", "cbcpref",
              "cdatef", "cdatecura", "ifre1", "fr1"):
        if k in nl:
            extras[k] = nl[k]

    return NamelistConfig(
        run=run, flags=flags, output_dates=sorted(set(out_dates)),
        restart_dates=sorted(set(rst_dates)),
        analysis_dates=sorted(set(ana_dates)),
        wind_dates=wind_dates, point_outputs=points,
        extras=extras, warnings=warnings)
