"""The run's guard compares whole top-level module names: the port
``ecwam_tpu_torch`` begins with ``ecwam_tpu`` and is allowed."""

import os
import subprocess
import sys

from wavebench import guard

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def test_top_level_names_whole():
    assert guard.forbidden_modules(["ecwam_tpu_torch",
                                    "ecwam_tpu_torch.model.driver",
                                    "jaxtyping", "flaxen", "torch"]) == []
    assert guard.forbidden_modules(
        ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
         "ecwam_tpu", "ecwam_tpu.model", "numpy"]) == [
        "ecwam_tpu", "ecwam_tpu.model", "flax.linen", "jax", "jax.numpy",
        "jaxlib.xla_client"]


def test_harness_and_reference_load_no_jax():
    code = ("import wavebench.run, wavebench.program, wavebench.work, "
            "wavebench.reference.model, sys; "
            "from wavebench import guard; "
            "print(guard.forbidden_modules()); "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] == 'ecwam_tpu_torch'))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    forbidden, port = out.stdout.strip().splitlines()
    assert forbidden == "[]"
    # the reference and the harness's modules import none of the port at
    # import time; the program's adapter imports it when it runs
    assert port == "[]"


def test_reference_imports_nothing_of_the_port():
    ref = os.path.join(ROOT, "wavebench", "reference")
    for dirpath, _, files in os.walk(ref):
        for f in files:
            if f.endswith(".py"):
                text = open(os.path.join(dirpath, f)).read()
                assert "import ecwam_tpu" not in text, f
                assert "from ecwam_tpu" not in text, f
                assert "import jax" not in text, f


def test_run_without_a_card_prints_no_result():
    import torch
    if torch.cuda.is_available():
        return
    out = subprocess.run([sys.executable, "-m", "wavebench.run",
                          "--workload", "o640_oper.forecast", "--seed",
                          "4294967311", "--seconds", "1"], cwd=ROOT,
                         capture_output=True, text=True)
    assert out.returncode != 0
    assert out.stdout == ""
