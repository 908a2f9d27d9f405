"""Registers and spills of a kernel library, built at more than one path.

    python3 ecwam_tpu_torch/tools/ptxas_registers.py                 # implsch
    python3 ecwam_tpu_torch/tools/ptxas_registers.py --library implsch \\
        --other build/parent --kernels "<0,0,0,0,0,0>" "<0,0,1,0,0,0>"

Run from a repository root on a machine with ``nvcc``.  ptxas can give
one kernel two register counts for one source: the anonymous namespace's
name, which nvcc derives from the file's path, reaches its decisions.  So
this compiles the library's source (``_build.source_and_flags``, the
flags of the real build) at ``--paths`` directory layouts under a
temporary directory, and with ``--other ROOT`` the same library name of
another checkout (its own source and flags, e.g. the parent commit
unpacked with ``git archive``) at the same layouts, all in parallel, and
prints one JSON line per build with the register lines of the kernels
whose names contain one of ``--kernels``.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
LAYOUTS = ("a/ecwam_tpu_torch/csrc", "checkout/b/ecwam_tpu_torch/csrc",
           "c/repository/ecwam_tpu_torch/csrc")


def _load(root: str, name: str):
    """Module ``name`` (a file path under ``root``) of a checkout."""
    spec = importlib.util.spec_from_file_location(
        f"_{abs(hash(root))}_{os.path.basename(name)}", os.path.join(
            root, name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def source_and_flags(root: str, library: str):
    """(source text, nvcc flags) of ``library`` in the checkout ``root``
    (a checkout without ``_build.VARIANTS`` builds ``csrc/<library>.cu``
    with its ``NVCC_FLAGS``)."""
    b = _load(root, "ecwam_tpu_torch/_build.py")
    if hasattr(b, "source_and_flags"):
        src, flags = b.source_and_flags(library)
    else:
        src, flags = (os.path.join(b.CSRC, library + ".cu"), b.NVCC_FLAGS)
    with open(src) as f:
        return f.read(), list(flags)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--library", default="implsch")
    ap.add_argument("--other", metavar="ROOT")
    ap.add_argument("--paths", type=int, default=2)
    ap.add_argument("--kernels", nargs="*",
                    default=["<0,0,0,0,0,0>", "<1,0,0,0,0,0>",
                             "<0,0,1,0,0,0>", "<1,0,1,0,0,0>"])
    a = ap.parse_args()
    sys.path.insert(0, HERE)
    import chip_smoke
    from ecwam_tpu_torch import _build
    roots = {"this": HERE}
    if a.other:
        roots["other"] = os.path.abspath(a.other)
    tmp = tempfile.mkdtemp()
    procs = {}
    for tree, root in roots.items():
        text, flags = source_and_flags(root, a.library)
        for layout in LAYOUTS[:a.paths]:
            d = os.path.join(tmp, tree, layout)
            os.makedirs(d)
            src = os.path.join(d, os.path.basename(a.library) + ".cu")
            with open(src, "w") as f:
                f.write(text)
            procs[(tree, layout)] = subprocess.Popen(
                [_build.nvcc_path(), *flags, "-o", os.path.join(d, "lib.so"),
                 src], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)
    for (tree, layout), p in procs.items():
        log, _ = p.communicate()
        lines = [line for line in chip_smoke.register_lines(log)
                 if any(k in line for k in a.kernels)]
        print(json.dumps(dict(tree=tree, root=roots[tree], path=layout,
                              library=a.library, rc=p.returncode,
                              registers=lines)), flush=True)


if __name__ == "__main__":
    main()
