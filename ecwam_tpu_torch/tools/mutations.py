"""Deliberately broken copies of csrc/implsch.cu against the card limits.

    python3 ecwam_tpu_torch/tools/mutations.py

Run from the repository root on a machine with one CUDA card.  For the
sound kernel and for each entry of MUTATIONS (one text change in the
full-mode part of the kernel source) it copies the package, chip_smoke.py
and the golden statistics into a temporary directory outside the
repository, applies the change there, builds it and reads every
full-mode check of chip_smoke.py with its limits: the golden and shallow
physics steps, the golden statistics.log trajectory and the O320 slice.
Prints one JSON line per kernel: the readings and the checks it fails.
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
KERNEL = os.path.join("ecwam_tpu_torch", "csrc", "implsch.cu")

MUTATIONS = {
    "sound": None,
    # the FLMAX cap's term left out of the flux source
    "no_cap_flux": (
        "if (FULL) W.fld[b] = P[P_DELTM] * fminf(T.flmax[m] - f, 0.f);",
        "if (FULL) W.fld[b] = 0.f;"),
    # the Stokes drift's f^-5 tail term left out
    "no_stokes_tail": (
        "us = warp_sum(us) + P[P_STOKES_C] * warp_sum(ut);",
        "us = warp_sum(us) + 0.f * warp_sum(ut);"),
    # PHIWA without the tail's energy flux PHIHF
    "no_phihf": (
        "phiwa += f1dcos2 * (aird * P[P_ZPI4GM1] * T.fr5[mij]) * sqrtz0og * acc;",
        "phiwa += 0.f * acc;"),
    # the flux source without the implicit factor 1/max(1 − δ·fld, 1)
    "no_implicit_factor": (
        "const float ss = W.sl[b] / fmaxf(1.f - P[P_DELT5] * W.fld[b], 1.f);",
        "const float ss = W.sl[b];"),
    # the windsea mask's test moved by 1e-3 in zlog (the growth term kept)
    "mask_edge_moved": (
        "if (active) xll[q] = 1.f;",
        "if (active && zlog < -1e-3f) xll[q] = 1.f;"),
    # one bin of the written mask dropped: direction 0, frequency nfre/2
    "mask_bit_dropped": (
        "(float)((xbits[q] >> m) & 1ull);",
        "(float)((xbits[q] >> m) & (k == 0 && m == nfre / 2 ? 0ull : 1ull));"),
}


def readings() -> dict:
    """The full-mode checks of chip_smoke.py on the tree at sys.path[0]."""
    import torch
    import chip_smoke as cs
    from ecwam_tpu_torch.model import cases
    dev = torch.device("cuda")
    out, fails = {}, []
    for name, kw in (("golden", cases.golden_kw()),
                     ("shallow", cases.shallow_kw())):
        f = cases.full_kernel_vs_plain(kw, dev, width=cs.MASK_WIDTH)
        worst = max(f["rows"], key=f["rows"].get)
        out[name] = dict(spec=f["spec"], worst=worst, rows=f["rows"][worst],
                         xllws=f["xllws"], xllws_off=f["off_edge"],
                         margin=f["margin"])
        if f["spec"] > cs.PHYS_TOL:
            fails.append(f"{name} spectrum")
        if f["rows"][worst] > cs.FULL_ROW_TOL:
            fails.append(f"{name} rows")
        if (f["off_edge"] > 0
                or f["xllws"] > cs.XLLWS_SHARE * f["bins"]):
            fails.append(f"{name} xllws")
    gold = cases.golden_statistics_error(cases.golden_statistics(dev),
                                         cs.GOLDEN)
    worst = max(gold, key=gold.get)
    out["statistics"] = dict(worst=worst, rel=gold[worst])
    if gold[worst] > cs.GOLDEN_RTOL:
        fails.append("golden statistics")
    ms, model = cs.o320_model(dev)
    model.advance(4)
    r = cs.slice_check(ms, model, dev, True, above_cut=0.0)
    worst = max(r["rows"], key=r["rows"].get)
    out["o320"] = dict(spec=r["spec_rel"], stress=r["stress_rel"],
                       worst=worst, rows=r["rows"][worst], xllws=r["xllws"],
                       xllws_off=r["xllws_off"], margin=r["margin"],
                       n_off=r["n_off"], n_tie=r["n_tie"])
    try:
        cs.check_slice(r, True, "o320")
    except AssertionError:
        fails.append("o320 slice")
    out["fails"] = fails
    return out


def main():
    if sys.argv[1:] == ["--readings"]:
        sys.path.insert(0, os.getcwd())
        print(json.dumps(readings()), flush=True)
        return
    for name, change in MUTATIONS.items():
        tmp = tempfile.mkdtemp(prefix=f"implsch_{name}_")
        try:
            shutil.copytree(os.path.join(HERE, "ecwam_tpu_torch"),
                            os.path.join(tmp, "ecwam_tpu_torch"),
                            ignore=shutil.ignore_patterns("__pycache__"))
            shutil.copy(os.path.join(HERE, "chip_smoke.py"), tmp)
            os.makedirs(os.path.join(tmp, "tests", "golden"))
            shutil.copy(os.path.join(HERE, "tests", "golden",
                                     "statistics_golden.json"),
                        os.path.join(tmp, "tests", "golden"))
            if change is not None:
                path = os.path.join(tmp, KERNEL)
                with open(path) as f:
                    src = f.read()
                if src.count(change[0]) != 1:
                    raise RuntimeError(f"{name}: the text to change is not "
                                       "in the kernel exactly once")
                with open(path, "w") as f:
                    f.write(src.replace(change[0], change[1]))
            res = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--readings"],
                cwd=tmp, capture_output=True, text=True, timeout=900)
            if res.returncode != 0:
                raise RuntimeError(f"{name}:\n{res.stderr[-3000:]}")
            line = json.loads(res.stdout.strip().splitlines()[-1])
            print(json.dumps(dict(kernel=name, **line)), flush=True)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
