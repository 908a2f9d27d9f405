"""Native (C++) components, built on demand with the system toolchain.

Copied from ``ecwam_tpu/native/__init__.py`` (numpy only, no JAX), with
one change: the library is built into ``build/ecwam_tpu_torch/native/``
at the repository root, keyed by a hash of the source, and never next
to the source, so the port neither loads nor writes the JAX package's
libraries.  ``grib1.cc`` and ``grib2.cc`` are copies of the reference's
sources.

The reference gets its native behavior from compiled Fortran + eccodes
(C); here the host-side codecs are C++ compiled at first use
(g++ -O2 -shared).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build",
                         "ecwam_tpu_torch", "native")
_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
_LOCK = threading.Lock()
_CACHE: dict = {}


def library_path(name: str) -> str:
    with open(os.path.join(_DIR, f"{name}.cc"), "rb") as f:
        h = hashlib.sha256(f.read() + " ".join(_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"_{name}-{h.hexdigest()[:16]}.so")


def load(name: str) -> ctypes.CDLL:
    """Compile (if missing) and dlopen the shared library for ``name``.cc."""
    with _LOCK:
        if name in _CACHE:
            return _CACHE[name]
        so = library_path(name)
        if not os.path.exists(so):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            cmd = ["g++", *_FLAGS, "-o", tmp,
                   os.path.join(_DIR, f"{name}.cc")]
            subprocess.run(cmd, check=True, capture_output=True)
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
        _CACHE[name] = lib
        return lib
