"""The port imports without JAX, and its kernel plumbing fails loudly.

``ecwam_tpu_torch`` and ``chip_smoke.py`` must import neither ``jax`` nor
any module of the JAX package ``ecwam_tpu`` (the port keeps its own copies
of the numpy modules it needs); its entry points run on the card unless
the CPU is asked for; and on a machine without ``nvcc`` or a card a kernel
build or launch must raise instead of degrading to the plain version.
"""

import os
import pkgutil
import re
import subprocess
import sys

import pytest
import torch

from ecwam_tpu_torch import _build
from ecwam_tpu_torch.device import resolve
from ecwam_tpu_torch.ops import propagation_cuda as pcu
from ecwam_tpu_torch.ops.physics import implsch_cuda as ipk

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "ecwam_tpu_torch")

# The tier-1 run (ROADMAP.md) runs 6 pytest workers.  PyTorch's default
# of one intra-op thread per core gives each worker as many spinning
# OpenMP threads as the machine has cores, and the port's CPU tests ran
# three times slower for it (their tensors are small).  Every worker
# imports every test module while it collects, so this sets one thread
# for the port's tests in all of them.
torch.set_num_threads(1)


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        [PKG], prefix="ecwam_tpu_torch."))


def test_every_module_imports_with_jax_blocked():
    """... and with the JAX package blocked too."""
    mods = _modules()
    assert {"ecwam_tpu_torch.model.driver", "ecwam_tpu_torch.cli.main",
            "ecwam_tpu_torch.__main__", "ecwam_tpu_torch.config.schema",
            "ecwam_tpu_torch.config.namelist", "ecwam_tpu_torch.native",
            "ecwam_tpu_torch.io.products", "ecwam_tpu_torch.io.extremes",
            "ecwam_tpu_torch.io.grib",
            "ecwam_tpu_torch.ops.secondorder",
            "ecwam_tpu_torch.coupling", "ecwam_tpu_torch.model.nesting",
            "ecwam_tpu_torch.model.assimilation",
            "ecwam_tpu_torch.io.outspec",
            "ecwam_tpu_torch.parallel.decomp",
            "ecwam_tpu_torch.parallel.decomp2d",
            "ecwam_tpu_torch.parallel.fused_shard",
            "ecwam_tpu_torch.parallel.multihost",
            "ecwam_tpu_torch.parallel.sharded"} <= set(mods)
    code = ("import sys, importlib; sys.modules['jax'] = None\n"
            "sys.modules['ecwam_tpu'] = None\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "import chip_smoke\n"
            "bad = [k for k, v in sys.modules.items() if v is not None and "
            "(k.split('.')[0] in ('jax', 'ecwam_tpu'))]\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def _sources():
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_no_source_imports_jax():
    pat = re.compile(r"^\s*(import jax|from jax)", re.M)
    for path in _sources():
        with open(path) as fh:
            assert not pat.search(fh.read()), path


def test_no_source_imports_the_jax_package():
    pat = re.compile(r"^\s*(from|import) ecwam_tpu([ .]|$)", re.M)
    for path in _sources():
        with open(path) as fh:
            assert not pat.search(fh.read()), path


def test_device_default_is_the_card():
    if torch.cuda.is_available():
        assert resolve(None) == torch.device("cuda")
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve(None)
    assert resolve("cpu") == torch.device("cpu")


@pytest.mark.parametrize("source,enum,names", [
    ("implsch.cu", r"enum Par \{(.*?)NPAR", ipk.PAR_NAMES),
    ("implsch.cu", r"enum Opt \{(.*?)\}", ipk.OPT_FLAGS),
    ("implsch.cu", r"enum GcTab \{(.*?)NGCTAB", ipk.GC_TABLES),
    ("advect.cu", r"enum Lc \{(.*?)NLC", pcu.LC_ROWS)])
def test_kernel_parameter_order_matches_wrapper(source, enum, names):
    with open(os.path.join(_build.CSRC, source)) as f:
        body = re.search(enum, f.read(), re.S).group(1)
    got = re.findall(r"\b[A-Z]+_([A-Z0-9_]+)\b", body)
    assert got == [n.upper() for n in names]


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    if _build.shutil.which("nvcc") or os.path.exists(
            "/usr/local/cuda/bin/nvcc"):
        pytest.skip("nvcc present: the build itself is exercised on the card")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.nvcc_path()
    # a library that is not built yet cannot load either
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "_libs", {})
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.load("advect")


def test_wrappers_refuse_devices_without_a_kernel():
    meta = torch.empty((384, 12), device="meta")
    with pytest.raises(ValueError, match="no advection kernel"):
        pcu.advect(meta, {}, {}, nang=12, nf=1, S=128, EW=4, irefra=0)
    with pytest.raises(ValueError, match="no physics kernel"):
        ipk.implsch_srl(None, meta, None, None, nang=12, nfre_red=1)


def test_full_mode_wrappers_refuse_devices_without_a_kernel():
    meta = torch.empty((384, 12), device="meta")
    with pytest.raises(ValueError, match="no physics kernel"):
        ipk.implsch_srl(None, meta, None, None, nang=12, nfre_red=1,
                        full=True)
    for full in (False, True):
        with pytest.raises(ValueError, match="no physics kernel"):
            ipk.implsch_compact(None, torch.empty((12, 1, 8), device="meta"),
                                None, None, full=full)

