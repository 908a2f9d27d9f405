"""Digests of kernel B's output on every O320 SRL row, to hold a change of
``csrc/implsch.cu`` to another tree's kernel bit for bit.

    python3 ecwam_tpu_torch/tools/implsch_digest.py [--nang 36 72]
    python3 ecwam_tpu_torch/tools/implsch_digest.py --root OTHER

Run from the repository root on a machine with one CUDA card.  For each
``--nang`` (36: the default build; 72: the wide build, four directions a
lane) it builds O320 36 frequencies / 29 advected (``chip_smoke.O320_KW``)
with ``chip_smoke.o320_wind``, steps the cold-started ``FastWaveModel``
twice, then runs kernel B once in minimal and once in full mode on every
SRL row of that state, and prints one JSON line with the SHA-256 of the
inputs and of each mode's outputs (spectrum rows, output rows, tail rows
and, in full mode, the windsea mask), the card's name and power limit.
``--root OTHER`` imports the package and ``chip_smoke`` of another
checkout (e.g. the parent commit unpacked with ``git archive``), so that
its kernel's digests are made the same way.  ``tests/test_torch_gpu.py``
holds the digests that the kernel must give.
"""

import argparse
import hashlib
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def sha(*tensors) -> str:
    """SHA-256 of the tensors' bytes, in order (None skipped)."""
    h = hashlib.sha256()
    for t in tensors:
        if t is not None:
            h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def digests(dev, nang: int = 36) -> dict:
    """{"in", "minimal", "full"}: the digests of kernel B's inputs and of
    its outputs in each mode on every SRL row of the O320 state after two
    steps at ``nang`` directions."""
    import torch
    import chip_smoke as cs
    from ecwam_tpu_torch.model import cases, driver
    from ecwam_tpu_torch.model import setup as setup_mod
    from ecwam_tpu_torch.ops.physics import implsch_cuda as ipk
    ms = setup_mod.build_model(device=dev, **dict(cs.O320_KW, nang=nang))
    wind = cs.o320_wind(ms.n_real)
    model = driver.FastWaveModel(ms, lambda date14: wind, cases.START)
    model.advance(2)
    fp = model.fp
    scal = torch.cat([model._frc6, model._denv, model._stress6])
    out = {"in": sha(model._f_srl, model._tail, model._env2d, scal)}
    for full in (False, True):
        cfg = ms.phys if full else ipk.minimal_config(ms.phys)
        r = ipk.implsch_srl(cfg, model._f_srl.clone(), model._env2d, scal,
                            model._tail.clone(), nang=fp.nang,
                            nfre_red=fp.nfre_red, full=full)
        out["full" if full else "minimal"] = sha(*r)
    del model, ms
    torch.cuda.empty_cache()
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--nang", type=int, nargs="*", default=[36, 72])
    a = ap.parse_args()
    root = os.path.abspath(a.root)
    sys.path.insert(0, root)
    import torch
    import chip_smoke as cs
    dev = torch.device("cuda")
    for nang in a.nang:
        print(json.dumps(dict(root=root, nang=nang, **digests(dev, nang),
                              card=cs.card_line())), flush=True)


if __name__ == "__main__":
    main()
