"""Run configuration: the reference YAML test-config schema, verbatim.

Copied from ``ecwam_tpu/config/schema.py`` (numpy only, no
JAX), with its imports pointed at ``ecwam_tpu_torch``: the port
imports nothing of the JAX package.

Parses the exact surface of the reference's ``tests/*.yml`` run configs
(tests/etopo1_oper_an_fc_O48.yml and friends, consumed by
share/ecwam/scripts/ecwam_run_model.sh:211-280 → namelist), including
``${var}`` interpolation, ``HH:MM[:SS]`` timesteps, the fast-wave block,
forcing windows, output/restart scheduling, option overrides
(iphys/irefra/llgcbz0/…) and the validation block.
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
import re

import yaml

DATE_FMT = "%Y%m%d%H%M%S"
_VAR_RE = re.compile(r"^\$\{([^}]+)\}$")


def _interp(value, flat: dict):
    """Resolve ${key} references against the flattened raw mapping."""
    if isinstance(value, str):
        m = _VAR_RE.match(value.strip())
        if m:
            return _interp(flat[m.group(1)], flat)
    return value


def _flatten(d, prefix=""):
    out = {}
    for k, v in d.items():
        key = f"{prefix}{k}"
        out[key] = v
        if isinstance(v, dict):
            out.update(_flatten(v, key + "."))
    return out


def parse_time(v) -> _dt.datetime:
    if isinstance(v, _dt.datetime):
        return v
    if isinstance(v, _dt.date):
        return _dt.datetime(v.year, v.month, v.day)
    s = str(v).strip()
    for fmt in ("%Y-%m-%d %H:%M:%S", "%Y-%m-%d %H:%M", "%Y-%m-%d",
                DATE_FMT):
        try:
            return _dt.datetime.strptime(s, fmt)
        except ValueError:
            continue
    raise ValueError(f"unparseable time {v!r}")


def parse_timestep(v) -> float:
    """Seconds from int/float or 'HH:MM[:SS]' (run-script convention)."""
    if isinstance(v, (int, float)):
        return float(v)
    parts = str(v).strip().split(":")
    if len(parts) == 1:
        return float(parts[0])
    h, m = int(parts[0]), int(parts[1])
    s = int(parts[2]) if len(parts) > 2 else 0
    return float(h * 3600 + m * 60 + s)


def _bool(v) -> bool:
    if isinstance(v, bool):
        return v
    return str(v).strip().upper() in ("T", "TRUE", "YES", "1", ".TRUE.")


@dataclasses.dataclass(frozen=True)
class Window:
    begin: _dt.datetime
    end: _dt.datetime
    timestep: float            # seconds


@dataclasses.dataclass(frozen=True)
class OutputFields:
    names: tuple
    format: str                # 'grib' | 'binary'
    windows: tuple             # Window or bare timestep applied to run span


@dataclasses.dataclass(frozen=True)
class RunConfig:
    grid: str
    directions: int
    frequencies: int
    bathymetry: str            # 'aqua' | 'ETOPO1' | path
    adv_timestep: float
    phys_timestep: float
    fast_waves_timestep: float | None
    fast_waves_max_frequency: int
    begin: _dt.datetime
    end: _dt.datetime
    analysis_begin: _dt.datetime | None
    analysis_end: _dt.datetime | None
    forcings_file: str | None
    forcing_windows: tuple     # tuple[Window]
    currents_input_step: float | None
    output_fields: OutputFields | None
    restart_format: str
    restart_times: tuple       # tuple[datetime]
    # advected frequency count NFRE_RED ≤ NFRE; None = all.  The reference
    # run script pins NFRE=36 and advects only the YAML `frequencies`
    # (ecwam_run_model.sh:213-214); set `physics_frequencies: 36` in YAML
    # (or NFRE+NFRE_RED in the namelist) to reproduce that split.
    nfre_red: int | None = None
    # option overrides (namelist surface)
    iphys: int = 1
    irefra: int = 0
    llgcbz0: bool = False
    llnormagam: bool = False
    llcapchnk: bool = False
    lciwa3: bool = False
    lciscal: bool = False
    # second-order correction of output spectra (mpuserin.F90:594 default)
    lsecondorder: bool = True
    # propagation engine: 'auto' (→ 'fused', the fast path), 'cached'
    # dense weights, 'otf' per-block recompute, 'fused' single-pass
    # weights+stencil.  Round 2 showed the dense default stalls/OOMs
    # beyond O96-class grids; reference YAMLs now get the fused engine
    weights_mode: str = "auto"
    nproma: int = 32           # accepted for compat; this build ignores it
    validation: dict = dataclasses.field(default_factory=dict)
    raw: dict = dataclasses.field(default_factory=dict, repr=False)

    # ---- constructors ----------------------------------------------------
    @classmethod
    def from_yaml(cls, path_or_text: str) -> "RunConfig":
        if "\n" in path_or_text or ":" not in path_or_text.split("\n")[0]:
            try:
                with open(path_or_text) as f:
                    raw = yaml.safe_load(f)
            except (OSError, ValueError):
                raw = yaml.safe_load(path_or_text)
        else:
            raw = yaml.safe_load(path_or_text)
        return cls.from_dict(raw)

    @classmethod
    def from_dict(cls, raw: dict) -> "RunConfig":
        flat = _flatten(raw)

        def get(key, default=None):
            v = flat.get(key, default)
            return _interp(v, flat)

        begin = parse_time(get("begin"))
        end = parse_time(get("end"))

        adv = raw.get("advection", {})
        fw = adv.get("fast_waves", {}) if isinstance(adv, dict) else {}

        fwin = []
        frc = raw.get("forcings", {}) or {}
        for w in frc.get("at", []):
            fwin.append(Window(
                begin=parse_time(_interp(w["begin"], flat)),
                end=parse_time(_interp(w["end"], flat)),
                timestep=parse_timestep(_interp(w["timestep"], flat))))

        out = (raw.get("output", {}) or {}).get("fields")
        output_fields = None
        if out:
            wins = []
            for w in out.get("at", []):
                if "timestep" in w:
                    wins.append(Window(
                        begin=parse_time(_interp(
                            w.get("begin", get("begin")), flat)),
                        end=parse_time(_interp(w.get("end", get("end")),
                                               flat)),
                        timestep=parse_timestep(_interp(w["timestep"],
                                                        flat))))
            output_fields = OutputFields(
                names=tuple(out.get("name", [])),
                format=out.get("format", "grib"),
                windows=tuple(wins))

        rst = (raw.get("output", {}) or {}).get("restart", {}) or {}
        rst_times = tuple(
            parse_time(_interp(w["time"], flat))
            for w in rst.get("at", []) if "time" in w)

        cur = raw.get("currents", {}) or {}

        ana_b = get("analysis.begin")
        ana_e = get("analysis.end")
        freqs = int(raw.get("frequencies", 29))
        nfre_red = None
        if "physics_frequencies" in raw:
            # YAML `frequencies` is the advected count NFRE_RED; physics
            # runs the full NFRE (ecwam_run_model.sh:213-214 semantics)
            nfre_red, freqs = freqs, int(raw["physics_frequencies"])
        if "nfre_red" in raw:
            nfre_red = int(raw["nfre_red"])
        return cls(
            grid=str(raw["grid"]).strip(),
            directions=int(raw.get("directions", 24)),
            frequencies=freqs,
            nfre_red=nfre_red,
            bathymetry=str(raw.get("bathymetry", "aqua")).strip(),
            adv_timestep=parse_timestep(adv.get("timestep", 900)),
            phys_timestep=parse_timestep(
                (raw.get("physics", {}) or {}).get("timestep", 900)),
            fast_waves_timestep=(parse_timestep(fw["timestep"])
                                 if "timestep" in fw else None),
            fast_waves_max_frequency=int(fw.get("max_frequency", 0)),
            begin=begin, end=end,
            analysis_begin=parse_time(ana_b) if ana_b else None,
            analysis_end=parse_time(ana_e) if ana_e else None,
            forcings_file=frc.get("file"),
            forcing_windows=tuple(fwin),
            currents_input_step=(parse_timestep(cur["input_step"])
                                 if "input_step" in cur else None),
            output_fields=output_fields,
            restart_format=rst.get("format", "binary"),
            restart_times=rst_times,
            iphys=int(raw.get("iphys", 1)),
            irefra=int(raw.get("irefra", 0)),
            llgcbz0=_bool(raw.get("llgcbz0", False)),
            llnormagam=_bool(raw.get("llnormagam", False)),
            llcapchnk=_bool(raw.get("llcapchnk", False)),
            lciwa3=_bool(raw.get("lciwa3", False)),
            lciscal=_bool(raw.get("lciscal", False)),
            lsecondorder=_bool(raw.get("lsecondorder", True)),
            weights_mode=str(raw.get("weights_mode", "auto")),
            nproma=int(raw.get("nproma", 32)),
            validation=raw.get("validation", {}) or {},
            raw=raw)

    # ---- derived ----------------------------------------------------------
    def build_kwargs(self) -> dict:
        """kwargs for model.setup.build_model."""
        kw = dict(
            grid_name=self.grid, nang=self.directions,
            nfre=self.frequencies, nfre_red=self.nfre_red,
            idelpro=self.adv_timestep, idelt=self.phys_timestep,
            iphys=self.iphys, irefra=self.irefra,
            llgcbz0=self.llgcbz0, llnormagam=self.llnormagam,
            llcapchnk=self.llcapchnk,
            lciwa3=self.lciwa3, lciscal=self.lciscal,
            weights_mode=("fused" if self.weights_mode == "auto"
                          else self.weights_mode))
        if self.fast_waves_timestep:
            kw["delpro_lf"] = self.fast_waves_timestep
            kw["ifrelfmax"] = self.fast_waves_max_frequency
        return kw

    def forcing_timestep_at(self, when: _dt.datetime) -> float | None:
        for w in self.forcing_windows:
            if w.begin <= when <= w.end:
                return w.timestep
        return None

    def output_dates(self) -> list:
        """All scheduled field-output datetimes within [begin, end]."""
        dates = set()
        if self.output_fields:
            for w in self.output_fields.windows:
                t = w.begin
                while t <= w.end:
                    dates.add(t)
                    t += _dt.timedelta(seconds=w.timestep)
        return sorted(d for d in dates if self.begin <= d <= self.end)

    def forcing_dates(self) -> list:
        dates = set()
        for w in self.forcing_windows:
            t = w.begin
            while t <= w.end:
                dates.add(t)
                t += _dt.timedelta(seconds=w.timestep)
        return sorted(d for d in dates if self.begin <= d <= self.end)
