"""statistics.log — the validation norms contract.

Copied unchanged from ``ecwam_tpu/io/norms.py`` (numpy only, no
JAX), with its imports pointed at ``ecwam_tpu_torch``: the port
imports nothing of the JAX package.

Writes per-date avg/min/max of each output field in decimal + IEEE-754 hex,
whitespace-separated exactly as parsed by the reference validator
(share/ecwam/scripts/ecwam_validation.py:38-50; produced by
outwnorm.F90:112 format).  Also provides the comparator used against the
reference YAML ``validation:`` blocks.
"""

from __future__ import annotations

import struct

import numpy as np

# output-parameter index in the reference JPPFLAG table (yowcout.F90);
# used only for the cosmetic IDX column
PARAM_INDEX = {"swh": 1, "mwd": 2, "mwp": 3, "ustar": 4, "dwi": 5,
               "pp1d": 6, "cdww": 7, "tauw_over_ust2": 8, "mss": 9,
               "msqs": 9, "wind": 10, "shww": 11, "shts": 12, "mdww": 13,
               "mdts": 14, "mpww": 15, "mpts": 16, "mp1": 20, "mwp1": 20,
               "mp2": 21, "mwp2": 21, "wdw": 22, "p1ww": 23, "p1ps": 24,
               "p2ww": 25, "p2ps": 26, "dwww": 27, "dwps": 28, "wsk": 29,
               "bfi": 30, "wsp": 31, "wmb": 32, "hmax": 33, "tmax": 34,
               "ust": 35, "vst": 36, "ocu": 37, "vcu": 38, "p039": 39,
               "p040": 40, "p041": 41, "p042": 42, "p043": 43, "p044": 44,
               "p045": 45, "p046": 46, "p047": 47, "p048": 48, "p049": 49,
               "p050": 50, "p051": 51, "p052": 52, "p053": 53, "p054": 54,
               "ci": 55, "p056": 56, "p057": 57, "p062": 62, "p063": 63,
               "p064": 64, "p065": 65, "p066": 66, "p067": 67, "p068": 68,
               "p069": 69, "p070": 70, "p071": 71, "p072": 72, "p073": 73,
               "p074": 74, "p075": 75, "p076": 76, "p077": 77}


def ieee_hex(x: float) -> str:
    """'0x' + big-endian IEEE-754 double bit pattern (outwnorm.F90:112)."""
    return "0x" + struct.pack(">d", float(x)).hex().upper()


def norm_entry(name: str, date14: str, values: np.ndarray,
               missing_mask=None) -> dict:
    v = np.asarray(values, dtype=np.float64)
    if missing_mask is not None:
        v = v[~np.asarray(missing_mask, bool)]
    if v.size == 0:
        return dict(time=date14, index=PARAM_INDEX.get(name, 0), name=name,
                    average=0.0, minimum=0.0, maximum=0.0,
                    non_missing_points=0)
    return dict(
        time=date14, index=PARAM_INDEX.get(name, 0), name=name,
        average=float(v.mean()), minimum=float(v.min()),
        maximum=float(v.max()), non_missing_points=int(v.size))


def format_line(e: dict) -> str:
    return (f"{e['time']} {e['index']} {e['name']} "
            f"{e['average']:.16E} {ieee_hex(e['average'])} "
            f"{e['minimum']:.16E} {ieee_hex(e['minimum'])} "
            f"{e['maximum']:.16E} {ieee_hex(e['maximum'])} "
            f"{e['non_missing_points']}")


class StatisticsLog:
    """Accumulates norm entries and writes statistics.log."""

    def __init__(self):
        self.entries: list[dict] = []

    def add(self, name, date14, values, missing_mask=None):
        self.entries.append(norm_entry(name, date14, values, missing_mask))

    def write(self, path: str):
        with open(path, "w") as f:
            f.write("# DATE IDX NAME AVERAGE(DEC,HEX) MINIMUM(DEC,HEX) "
                    "MAXIMUM(DEC,HEX) NON_MISSING_POINTS\n")
            for e in self.entries:
                f.write(format_line(e) + "\n")

    def filter(self, **kw):
        out = [e for e in self.entries
               if all(e.get(k) == v for k, v in kw.items())]
        return out


def validate_report(entries: list[dict],
                    validation_list: list[dict]) -> dict:
    """Compare entries against a reference YAML validation block
    (tests/etopo1_oper_an_fc_O48.yml:52-116 schema), replicating
    ecwam_validation.py:118-181: per spec, the FIRST norm key present is
    tolerance-checked, and the IEEE-hex ``hashes`` list counts exact
    bit-identical matches (informational, never pass/fail).

    Returns dict(failures=[...], passed=N, bit_identical=N, missing=N).
    """
    failures = []
    passed = bit_identical = missing = 0
    for spec in validation_list:
        name = spec["name"]
        t14 = str(spec["time"]).replace("-", "").replace(":", "").replace(
            " ", "")
        matches = [e for e in entries
                   if e["name"] == name and e["time"] == t14]
        if not matches:
            missing += 1
            failures.append(dict(spec=spec, reason="no matching entry"))
            continue
        e = matches[-1]
        rtol = float(spec.get("relative_tolerance", 0.0))
        norm_type = next((k for k in ("average", "minimum", "maximum")
                          if k in spec), None)
        if norm_type is None:
            continue
        ref = float(spec[norm_type])
        got = e[norm_type]
        if abs(got - ref) > rtol * abs(ref):
            failures.append(dict(
                spec=spec, reason=f"{norm_type}: got {got}, want {ref} "
                f"(rtol {rtol})"))
        else:
            passed += 1
            if ieee_hex(got) in spec.get("hashes", []):
                bit_identical += 1
    return dict(failures=failures, passed=passed,
                bit_identical=bit_identical, missing=missing)


def validate(entries: list[dict], validation_list: list[dict]) -> list[dict]:
    """Failure list only (empty = pass); see validate_report."""
    return validate_report(entries, validation_list)["failures"]
