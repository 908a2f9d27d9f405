"""Kernel A's time split by stage, from copies with a stage taken out.

    python3 ecwam_tpu_torch/tools/advect_stages.py [--reps 10]

Run from the repository root on a machine with one CUDA card.  ``ncu``
does not run there, so the stages of ``csrc/advect.cu`` are timed apart
by building copies of the source with one text change each (in a
temporary directory) and timing each copy's all-band pass on the O320
state, default (``chip_smoke.o320_model``) and with currents
(``cases.o320_options``), with CUDA events, in two rounds:
  sound        the kernel as it is;
  no_fir       phase 2 without its FIR loops over the dn/up windows;
  no_phase2    no outputs computed: staging, phase 1 and the pad blocks;
  staging      neither phase: the copies into shared memory, the
               barriers and the pad blocks;
  per_item     the sound kernel on one CTA per work item in place of the
               persistent grid (its output is right).
The other copies' output is wrong, so only their time is read: the
difference to the sound kernel is what the stage costs where it does not
overlap the rest.  Prints one JSON line per run with the card's name and power
limit.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NO_PHASE2 = ("if (rgi < rg && (CFL || calc || copy)) {", "if (false) {")
NO_PHASE1 = ("    if (band == 0) {\n      // ---- phase 1",
             "    if (false) {\n      // ---- phase 1")
VARIANTS = {
    "sound": (),
    "no_fir": (("for (int e = 0; e < ext; ++e) {",
                "for (int e = 0; e < 0; ++e) {"),
               ("for (int e = 0; e < cur.ed; ++e) {",
                "for (int e = 0; e < 0; ++e) {"),
               ("for (int e = 0; e < cur.eu; ++e) {",
                "for (int e = 0; e < 0; ++e) {")),
    "no_phase2": (NO_PHASE2,),
    "staging": (NO_PHASE2, NO_PHASE1),
    "per_item": (("  grid = grid < a.nitems ? grid : a.nitems;",
                  "  grid = a.nitems;"),),
}


def build(tmp: str) -> dict:
    """Every variant's library, built in parallel under ``tmp``."""
    from ecwam_tpu_torch import _build
    with open(os.path.join(_build.CSRC, "advect.cu")) as f:
        src = f.read()
    procs = {}
    for name, changes in VARIANTS.items():
        text = src
        for old, new in changes:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the text to change is not in "
                                   "the kernel exactly once")
            text = text.replace(old, new)
        cu = os.path.join(tmp, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        out = os.path.join(tmp, f"{name}.so")
        procs[name] = (subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", out, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out)
    libs = {}
    for name, (p, out) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log[-3000:]}")
        libs[name] = out
    return libs


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import torch
    import chip_smoke as cs
    from ecwam_tpu_torch import _build
    from ecwam_tpu_torch.model import cases
    from ecwam_tpu_torch.ops import propagation_cuda as pcu
    dev = torch.device("cuda")
    card = cs.card_line()
    with tempfile.TemporaryDirectory(prefix="advect_stages_") as tmp:
        libs = {name: ctypes.CDLL(path) for name, path in build(tmp).items()}
        for config, make in (("default", cs.o320_model),
                             ("options", cases.o320_options)):
            ms, model = make(dev)
            fp = model.fp
            f0 = model._f_srl.clone()
            for rnd in range(2):
                for name, lib in libs.items():
                    _build._libs["advect"] = lib
                    n0 = pcu.advect.launches
                    ms_k = cs.cuda_ms(
                        lambda _: fp._pass(f0, fp.nfre_red, fp.lc),
                        args.reps)
                    if pcu.advect.launches == n0:
                        raise AssertionError("the pass bypassed kernel A")
                    print(json.dumps(dict(config=config, variant=name,
                                          round=rnd, ms=ms_k, card=card)),
                          flush=True)
            del ms, model, fp, f0
            torch.cuda.empty_cache()
    _build._libs.pop("advect", None)


if __name__ == "__main__":
    main()
