"""Kernel B's time split by stage, from copies with a stage taken out.

    python3 ecwam_tpu_torch/tools/implsch_stages.py [--reps 5]
    python3 ecwam_tpu_torch/tools/implsch_stages.py --root OTHER --variants parent

Run from the repository root on a machine with one CUDA card.  ``ncu``
does not run there, so the stages of ``csrc/implsch.cu`` are timed apart
by building copies of the source with one text change each (in a
temporary directory) and timing each copy in minimal mode on every SRL
row of the O320 state after two steps, default
(``chip_smoke.o320_model``) and with the cycle-50r1 options
(``cases.o320_options``), with CUDA events, in two rounds:
  sound           the kernel as it is;
  no_sinput       SINPUT left out of both SINFLX calls;
  no_taut_z0      the TAUT_Z0 / TAUT_Z0_GC solves left out;
  no_stress_tail  STRESSO's tail integrals (TAU_PHI_HF) left out;
  no_sdissip      SDISSIP left out;
  no_snonlin      SNONLIN (DIA) left out;
  no_sdiwbk       SDIWBK's Newton solve and the per-bin SDIWBK/SBOTTOM
                  (with the options also LCISCAL/SDICE3) pass left out;
  no_update       the semi-implicit update, IMPHFTAIL and SETICE left out;
  no_stages       the load and the store only;
  half_warps      the sound kernel on half the warps a block (half the
                  rows in flight);
  two_rows_a_warp the sound kernel with 16 lanes a row and two rows a
                  warp (the rows in flight as many, the warps half).
The last two copies' output is right.
The other copies' output is wrong, so only their time is read: the difference
to the sound kernel is what the stage costs where it does not overlap the
rest; a stage whose removal changes the data the later stages see (the
cut index, the dissipation) moves their time too, so the differences need
not add up to the whole.  ``--root OTHER`` times the kernel of another
checkout (imported from there, its own package and tables), and
``--variants parent`` takes the text changes written for the kernel this
one replaced (``ecwam_tpu_torch/csrc/implsch.cu`` at the parent of its
redesign), so that the parent's table can be made again from that tree
unpacked with ``git archive``.  Prints the sound build's registers and
spills, then one JSON line per run with the card's name and power limit.
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

# the stages of the kernel before its redesign for Hopper (one warp per
# row, the tables read from global memory)
PARENT = {
    "sound": (),
    "no_sinput": (("    else\n      sinput_ard<FULL, OPTS>(",
                   "    else if (false)\n      sinput_ard<FULL, OPTS>("),),
    "no_taut_z0": (("    if (opts & OPT_LLGCBZ0)\n      taut_z0_gc(",
                    "    if (false)\n      taut_z0_gc("),
                   ("    else\n      taut_z0<OPTS>(",
                    "    else if (false)\n      taut_z0<OPTS>(")),
    "no_stress_tail": (
        ("  for (int j = 0; j < JTOT; ++j) {\n"
         "    const float y = expf(zinf + (float)j * delz);",
         "  for (int j = 0; j < 0; ++j) {\n"
         "    const float y = expf(zinf + (float)j * delz);"),
        ("    for (int j = 0; j < JTOT; ++j) {\n"
         "      const float y = expf(zinf + (float)j * delz_phi);",
         "    for (int j = 0; j < 0; ++j) {\n"
         "      const float y = expf(zinf + (float)j * delz_phi);")),
    "no_sdissip": (("  else\n    sdissip_ard(T, W, lane);",
                    "  else if (false)\n    sdissip_ard(T, W, lane);"),),
    "no_snonlin": (("  snonlin<EXT>(T, W, lane, depth, enhfr, xnu, sig_th);",
                    "  if (false) snonlin<EXT>(T, W, lane, depth, enhfr, "
                    "xnu, sig_th);"),),
    "no_sdiwbk": (
        ("    for (int it = 0; it < 15; ++it) {",
         "    for (int it = 0; it < 0; ++it) {"),
        ("  if (!OPTS) {\n    for (int b = lane; b < nb; b += 32) {",
         "  if (!OPTS) {\n    for (int b = lane; b < 0; b += 32) {"),
        ("    for (int b = lane; b < nb; b += 32) {\n"
         "      const int m = b % nfre;\n      const bool low",
         "    for (int b = lane; b < 0; b += 32) {\n"
         "      const int m = b % nfre;\n      const bool low")),
    "no_update": (
        ("  for (int b = lane; b < nb; b += 32) {\n"
         "    const int k = b / nfre, m = b - k * nfre;\n"
         "    const float temp = usfm",
         "  for (int b = lane; b < 0; b += 32) {\n"
         "    const int k = b / nfre, m = b - k * nfre;\n"
         "    const float temp = usfm"),
        ("  for (int b = lane; b < nb; b += 32) {\n"
         "    const int k = b / nfre, m = b - k * nfre;\n"
         "    if (m <= mij) continue;",
         "  for (int b = lane; b < 0; b += 32) {\n"
         "    const int k = b / nfre, m = b - k * nfre;\n"
         "    if (m <= mij) continue;"),
        ("    for (int b = lane; b < nb; b += 32) {\n"
         "      const float c2 = fmaxf(0.f, W.cosw[b / nfre]);",
         "    for (int b = lane; b < 0; b += 32) {\n"
         "      const float c2 = fmaxf(0.f, W.cosw[b / nfre]);")),
    "no_stages": (
        ("  float z0b = sc(12), chrnck = sc(13);\n  __syncwarp();\n",
         "  float z0b = sc(12), chrnck = sc(13);\n  __syncwarp();\n"
         "  if (!FULL) {\n"
         "    float* fd = Lo.fout + p * Lo.f_ps;\n"
         "    float* td = nt ? Lo.tout + p * (long)(nang * nt) : nullptr;\n"
         "    for (int b = lane; b < nb; b += 32) {\n"
         "      const int k = b / nfre, m = b - k * nfre;\n"
         "      if (m < nfr) fd[fidx(k, m)] = W.fl[b];\n"
         "      else td[k * nt + (m - nfr)] = W.fl[b];\n"
         "    }\n"
         "    if (lane < 6) out[lane * (long)nrows + p] = sc(8 + lane);\n"
         "    return;\n"
         "  }\n"),),
}

# the stages of the kernel redesigned for Hopper (two rows a warp, the
# tables in shared memory, SDISSIP between the SINFLX calls)
VARIANTS = {
    "sound": (),
    "no_sinput": (("    else\n      sinput_ard<FULL, OPTS>(",
                   "    else if (false)\n      sinput_ard<FULL, OPTS>("),),
    "no_taut_z0": (("    else if (opts & OPT_LLGCBZ0)\n      taut_z0_gc(",
                    "    else if (false)\n      taut_z0_gc("),
                   PARENT["no_taut_z0"][1]),
    "no_stress_tail": PARENT["no_stress_tail"],
    "no_sdissip": (("    if (!JAN && !second) sdissip_ard(T, W, lane);",
                    "    if (false) sdissip_ard(T, W, lane);"),),
    "no_snonlin": PARENT["no_snonlin"],
    "no_sdiwbk": (
        ("    for (int it = 0; it < 15; ++it) {",
         "    for (int it = 0; it < 0; ++it) {"),
        ("    if (bottom)\n      for (int m = lane; m < T.nred; m += RL)",
         "    if (false)\n      for (int m = lane; m < T.nred; m += RL)"),
        ("      if (m >= T.nred) return;", "      return;"),
        ("      if (bottom && m < T.nred)\n", "      if (false)\n"),
        ("      if (ice) {\n", "      if (false) {\n"),
        ("      const bool low = m < T.nred;",
         "      return;\n      const bool low = m < T.nred;")),
    "no_update": (
        ("    const float temp = usfm * (T.cofrm4[m] * P[P_DELT]);",
         "    return;\n    const float temp = usfm * (T.cofrm4[m] * P[P_DELT]);"),
        ("  for (int m = mij + 1 + lane; m < nfre; m += RL)",
         "  for (int m = mij + 1 + lane; m < 0; m += RL)"),
        ("    if (m <= mij) return;", "    return;"),
        ("      const float c2 = fmaxf(0.f, W.cosw[k]);",
         "      return;\n      const float c2 = fmaxf(0.f, W.cosw[k]);")),
    "half_warps": (("constexpr int MAX_WARPS = 12;",
                    "constexpr int MAX_WARPS = 6;"),),
    "two_rows_a_warp": (("constexpr int RL = 32; ", "constexpr int RL = 16; "),
                        ("constexpr int MAX_WARPS = 12;",
                         "constexpr int MAX_WARPS = 8; ")),
    "no_stages": (
        ("  float z0b = sc(12), chrnck = sc(13);\n  __syncwarp();\n",
         "  float z0b = sc(12), chrnck = sc(13);\n  __syncwarp();\n"
         "  if (!FULL) {\n"
         "    if (live) {\n"
         "      float* fd = Lo.fout + p * Lo.f_ps;\n"
         "      float* td = nt ? Lo.tout + p * (long)(nang * nt) : nullptr;\n"
         "      for_bins(T, [&](int b, int k, int m) {\n"
         "        if (m < nfr) fd[fidx(k, m)] = W.fl[b];\n"
         "        else td[k * nt + (m - nfr)] = W.fl[b];\n"
         "      });\n"
         "      if (lane < 6) out[lane * (long)nrows + p] = sc(8 + lane);\n"
         "    }\n"
         "    __syncwarp();\n"
         "    return;\n"
         "  }\n"),),
}
VARIANT_SETS = dict(current=VARIANTS, parent=PARENT)


def apply(src: str, changes) -> str:
    """``src`` with each (old, new) text change made; each old text must
    occur exactly once."""
    for old, new in changes:
        if src.count(old) != 1:
            raise RuntimeError("the text to change is not in the kernel "
                               f"exactly once: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def build(tmp: str, csrc: str, variants: dict, flags=()) -> tuple:
    """Every variant's library, built in parallel under ``tmp`` with the
    extra nvcc ``flags``, and the sound build's compiler log."""
    from ecwam_tpu_torch import _build
    with open(os.path.join(csrc, "implsch.cu")) as f:
        src = f.read()
    procs = {}
    for name, changes in variants.items():
        text = apply(src, changes)
        cu = os.path.join(tmp, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        out = os.path.join(tmp, f"{name}.so")
        procs[name] = (subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, *flags, "-o", out, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out)
    libs, sound_log = {}, ""
    for name, (p, out) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log[-3000:]}")
        libs[name] = out
        if name == "sound":
            sound_log = log
    return libs, sound_log


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--variants", choices=sorted(VARIANT_SETS),
                    default="current")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    import chip_smoke as cs
    from ecwam_tpu_torch import _build
    from ecwam_tpu_torch.model import cases
    from ecwam_tpu_torch.ops.physics import implsch_cuda as ipk
    dev = torch.device("cuda")
    card = cs.card_line()
    with tempfile.TemporaryDirectory(prefix="implsch_stages_") as tmp:
        # the shipped SRL library's flags (the parent's source has one
        # library and no defines)
        flags = (("-DIMPLSCH_SRL",) if args.variants == "current"
                 else ())
        paths, log = build(tmp, _build.CSRC, VARIANT_SETS[args.variants],
                           flags)
        print(json.dumps(dict(root=root, variants=args.variants,
                              registers=cs.register_lines(log),
                              card=card)), flush=True)
        libs = {name: ctypes.CDLL(path) for name, path in paths.items()}
        for config, make in (("default", cs.o320_model),
                             ("options", cases.o320_options)):
            ms, model = make(dev)
            model.advance(2)
            fp = model.fp
            cfg = ipk.minimal_config(ms.phys)
            tabs = ipk.pack_tables(cfg, dev)
            scal = torch.cat([model._frc6, model._denv, model._stress6])

            def fresh():
                return (model._f_srl.clone(), model._env2d, scal,
                        model._tail.clone())
            for rnd in range(2):
                for name, lib in libs.items():
                    _build._libs["implsch"] = lib
                    n0 = ipk.implsch_srl.launches
                    ms_k = cs.cuda_ms(lambda a: ipk.implsch_srl(
                        cfg, *a, nang=fp.nang, nfre_red=fp.nfre_red,
                        tables_dev=tabs), args.reps, fresh)
                    if ipk.implsch_srl.launches == n0:
                        raise AssertionError("the step bypassed kernel B")
                    print(json.dumps(dict(config=config, variant=name,
                                          round=rnd, rows=int(model._f_srl.shape[0]),
                                          ms=ms_k, card=card)),
                          flush=True)
            del ms, model, fp, scal
            torch.cuda.empty_cache()
    _build._libs.pop("implsch", None)


if __name__ == "__main__":
    main()
