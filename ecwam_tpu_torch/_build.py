"""Build the CUDA kernels in ``csrc/`` at first use and load them.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into its own shared library under
``build/ecwam_tpu_torch/`` at the repository root, keyed by a hash of the
source and the flags; the library is loaded with ``ctypes``.  A library
of VARIANTS is a build of a source with its own defines: kernel B/C's
source in four, its SRL and compact entries (``implsch``,
``implsch_compact``) at up to 64 directions and again in its wide build
(``implsch_wide``, ``implsch_wide_compact``: 128 directions), so that they
compile in parallel.  Nothing here runs at import time, so the package
imports on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "build", "ecwam_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
SOURCES = ("advect", "implsch", "implsch_compact", "implsch_wide",
           "implsch_wide_compact", "opclass")
# library name: (source, extra nvcc flags); the others are their source's
VARIANTS = {
    "implsch": ("implsch", ("-DIMPLSCH_SRL",)),
    "implsch_compact": ("implsch", ("-DIMPLSCH_COMPACT",)),
    "implsch_wide": ("implsch", ("-DIMPLSCH_WIDE", "-DIMPLSCH_SRL")),
    "implsch_wide_compact": ("implsch", ("-DIMPLSCH_WIDE",
                                         "-DIMPLSCH_COMPACT")),
}

_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built "
                           "on the machine with the card")
    return path


def source_and_flags(name: str) -> tuple:
    """(path of the .cu source, nvcc flags) of library ``name``."""
    src, extra = VARIANTS.get(name, (name, ()))
    return os.path.join(CSRC, src + ".cu"), NVCC_FLAGS + tuple(extra)


def library_path(name: str) -> str:
    src, flags = source_and_flags(name)
    with open(src, "rb") as f:
        h = hashlib.sha256(f.read() + " ".join(flags).encode())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def build(names=SOURCES) -> dict:
    """Compile every missing library in ``names``, one ``nvcc`` each, all
    started together.  Returns {name: (seconds, compiler log)}; raises
    with the compiler's output if any build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        src, flags = source_and_flags(name)
        cmd = [nvcc_path(), *flags, "-o", tmp, src]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT,
                                        text=True), tmp, out,
                       time.perf_counter())
    logs = {}
    failed = []
    for name, (p, tmp, out, t0) in procs.items():
        text, _ = p.communicate()
        logs[name] = (time.perf_counter() - t0, text)
        if p.returncode != 0:
            failed.append(f"--- {name} (rc {p.returncode})\n{text}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (``csrc/<name>.cu`` or a VARIANTS
    build), built if missing."""
    lib = _libs.get(name)
    if lib is None:
        path = library_path(name)
        if not os.path.exists(path):
            build([name])
        lib = ctypes.CDLL(path)
        _libs[name] = lib
    return lib
