"""Time kernels A and B on the O320 state: default, cy50r1 and legacy.

    python3 ecwam_tpu_torch/tools/time_physics.py               # this tree
    python3 ecwam_tpu_torch/tools/time_physics.py --ab OTHER    # A/B
    python3 ecwam_tpu_torch/tools/time_physics.py --wide        # + wide

Run from a repository root on a machine with one CUDA card.  For each
configuration — ``default``, ``chip_smoke.o320_model``, ``options``,
``cases.o320_options`` (cy50r1, irefra 2, polar ice), and ``legacy``,
``cases.o320_legacy`` (iphys=0, ISNONLIN=2, SDICE1, LSTRN) — the state is the
model's after two steps (one physics step); kernel B is timed in minimal
mode on every SRL row and in full mode over every row in chunks of 65,536
(the output date's launches), and kernel A as one all-band pass, each
with CUDA events over ``--reps`` runs on fresh copies.  With
``--ab OTHER`` (the root of another checkout, e.g. the parent commit
unpacked with ``git archive``) the two trees run in turns, each in its own
process, OTHER, this, this, OTHER, so that both are measured on one card.
``--wide`` times kernel B of the default configuration a second time
through the wide build of ``csrc/implsch.cu`` (``implsch_wide``, four
directions a lane) at the same 36 directions (``default_wide``), this
tree's runs only.  Prints one JSON line per run with the card's name and
power limit.
"""

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def run(root: str, reps: int, wide: bool = False) -> dict:
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch
    import chip_smoke as cs
    from ecwam_tpu_torch.model import cases
    dev = torch.device("cuda")
    out = dict(root=root, card=cs.card_line(), reps=reps)
    for name, build in (("default", cs.o320_model),
                        ("options", cases.o320_options),
                        ("legacy", cases.o320_legacy)):
        ms, model = build(dev)
        model.advance(2)
        out[name] = time_model(cs, ms, model, reps)
        if wide and name == "default":
            out["default_wide"] = time_wide(cs, ms, model, reps)
        del ms, model
        torch.cuda.empty_cache()
    return out


def time_wide(cs, ms, model, reps: int) -> dict:
    """:func:`time_model`'s kernel B times with the SRL entry's wide build
    loaded in place of the default one, and the largest difference of
    one minimal step's spectrum between the two builds over its maximum
    (``spec_rel``)."""
    import torch
    from ecwam_tpu_torch import _build
    from ecwam_tpu_torch.ops.physics import implsch_cuda as ipk
    cfg = ipk.minimal_config(ms.phys)
    scal = torch.cat([model._frc6, model._denv, model._stress6])

    def step():
        f = model._f_srl.clone()
        ipk.implsch_srl(cfg, f, model._env2d, scal, model._tail.clone(),
                        nang=model.fp.nang, nfre_red=model.fp.nfre_red)
        return f
    want = step()
    _build._libs["implsch"] = _build.load(ipk.WIDE_LIB)
    try:
        got = step()
        r = time_model(cs, ms, model, reps)
    finally:
        _build._libs.pop("implsch")
    rel = float((got - want).abs().max() / want.abs().max())
    return dict(library=ipk.WIDE_LIB, rows=r["rows"],
                minimal_all_rows_ms=r["minimal_all_rows_ms"],
                full_all_rows_ms=r["full_all_rows_ms"], spec_rel=rel)


def time_model(cs, ms, model, reps: int) -> dict:
    """Kernel B (minimal on all rows, full in chunks) and kernel A (one
    pass) on ``model``'s state after two steps."""
    import torch
    from ecwam_tpu_torch.ops import propagation_cuda as pcu
    from ecwam_tpu_torch.ops.physics import implsch_cuda as ipk
    dev = ms.device
    fp = model.fp
    cfg = ipk.minimal_config(ms.phys)
    tabs = ipk.pack_tables(cfg, dev)
    scal = torch.cat([model._frc6, model._denv, model._stress6])

    def fresh():
        return (model._f_srl.clone(), model._env2d, scal,
                model._tail.clone())
    ms_all = cs.cuda_ms(lambda a: ipk.implsch_srl(
        cfg, *a, nang=fp.nang, nfre_red=fp.nfre_red, tables_dev=tabs),
        reps, fresh)
    nsrl, chunk = model._f_srl.shape[0], 65536

    def full_all(a):
        for s0 in range(0, nsrl, chunk):
            r = slice(s0, min(nsrl, s0 + chunk))
            ipk.implsch_srl(ms.phys, a[0][r], a[1][:, r].contiguous(),
                            a[2][:, r].contiguous(), a[3][r],
                            nang=fp.nang, nfre_red=fp.nfre_red, full=True,
                            tables_dev=tabs)
    full_ms = cs.cuda_ms(full_all, reps, fresh)
    f0 = model._f_srl.clone()
    # through the step's own pass, whose arguments both trees share
    advect_ms = cs.cuda_ms(lambda _: fp._pass(f0, fp.nfre_red, fp.lc), reps)
    n0 = pcu.advect.launches
    fp._pass(f0, fp.nfre_red, fp.lc)
    if pcu.advect.launches != n0 + 1:
        raise AssertionError("the pass did not launch kernel A")
    return dict(rows=int(nsrl), minimal_all_rows_ms=ms_all,
                full_all_rows_ms=full_ms, advect_pass_ms=advect_ms)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--ab", metavar="OTHER")
    ap.add_argument("--wide", action="store_true")
    a = ap.parse_args()
    if a.ab:
        other = os.path.abspath(a.ab)
        for root in (other, HERE, HERE, other):
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--root", root, "--reps", str(a.reps)]
                           + (["--wide"] if a.wide and root == HERE
                              else []),
                           check=True, cwd=root, timeout=600)
        return
    print(json.dumps(run(a.root, a.reps, a.wide)), flush=True)


if __name__ == "__main__":
    main()
