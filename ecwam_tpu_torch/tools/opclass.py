"""Kernel D: the op-class micro-benchmark on the card.

    python -m ecwam_tpu_torch.tools.opclass            # K=64, 131,072 lanes
    python -m ecwam_tpu_torch.tools.opclass --k 8 --lanes 16384 --reps 2

The counterpart of ``scripts/mosaic_opclass.py`` (its ``make``/``make2``
Pallas kernels): each of the nine op classes (CLASSES) applied K times to
every (36, 40) column of a (36, 40, lanes) float32 array from
``default_rng(0)``, timed as the reference times it — ``reps`` calls,
each on the previous call's output, after one warm-up — and reported in
its unit, ns per application per 128-lane tile, beside the card's name
and power limit.  Run from a repository root on a machine with one CUDA
card; the kernel (``csrc/opclass.cu``) is built at first use.  Each class
is checked against the plain version at K=8 over 16,384 lanes and at the
run's size, then timed; it prints one JSON line per class with the
checks, the kernel's time, the plain version's
(:func:`opclass_plain`, the same K steps in PyTorch), the library
column (one PyTorch call per application, times K; None where no single
call computes the application) and the bounds (:func:`bounds`).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import numpy as np
import torch

from ecwam_tpu_torch import _build

# the op classes, in the order of csrc/opclass.cu's Cls enum
CLASSES = ("fma", "sub_shift", "sub_shift4", "lead_roll", "transpose2x",
           "lead_reduce", "sub_reduce", "lane_bcast", "exp")
# the classes that only move data: the kernel must equal the plain version
LAYOUT = ("sub_shift", "sub_shift4", "lead_roll", "transpose2x")
# the classes whose data stays in each thread's registers in the kernel's
# design (a line of a column a thread: a rotation or a register sum), so
# that no entry crosses lanes; transpose2x alone needs shared memory
IN_REGISTERS = ("sub_shift", "sub_shift4", "lead_roll", "lead_reduce",
                "sub_reduce")
NANG, MF = 36, 40
TILE = 128                       # lanes of the reference's tile

# H100 SXM rates at the 1.98 GHz that its 67 TFLOP/s float32 peak implies
# (132 SMs × 128 FP32 lanes × 2 × 1.98e9): each SM's shared memory moves
# 32 banks × 4 bytes a clock, and its special-function units give 16
# results a clock (ex2)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
SMEM_BYTES_PER_S = 132 * 128 * 1.98e9
SFU_OPS_PER_S = 132 * 16 * 1.98e9


# fma's constants as float32 values, the kernel's 1.0000001f and 1e-9f
FMA_MUL = float(np.float32(1.0000001))
FMA_ADD = float(np.float32(1e-9))


def _multiplier(x):
    """lane_bcast's (1, 40, 1) row 1e-6·m + 0.9999, in float32."""
    return (torch.arange(MF, dtype=torch.float32, device=x.device) * 1e-6
            + 0.9999)[None, :, None]


def _step(name: str, x, w):
    """One application of class ``name`` to x (36, 40, lanes)."""
    if name == "fma":
        # rounded once, as the kernel's FMA rounds it: the product and the
        # sum of these float32 values are exact in float64 (two roundings
        # drift from one by up to an ulp an application, past 1e-6 of the
        # maximum after 64)
        return (x.double() * FMA_MUL + FMA_ADD).to(x.dtype)
    if name == "sub_shift":
        return torch.roll(x, -1, dims=1)
    if name == "sub_shift4":
        return torch.roll(x, -4, dims=1)
    if name == "lead_roll":
        return torch.roll(x, -1, dims=0)
    if name == "transpose2x":
        t = x.transpose(0, 1).contiguous() * 1.0000001
        return t.transpose(0, 1).contiguous()
    if name == "lead_reduce":
        return x + torch.sum(x, dim=0, keepdim=True) * 1e-12
    if name == "sub_reduce":
        return x + torch.sum(x, dim=1, keepdim=True) * 1e-12
    if name == "lane_bcast":
        return x * w
    if name == "exp":
        return torch.exp(x * 1e-6)
    raise KeyError(name)


def opclass_plain(name: str, x, k: int):
    """The plain version: the same ``k`` applications in PyTorch."""
    w = _multiplier(x)
    for _ in range(k):
        x = _step(name, x, w)
    return x


def library_call(name: str, x):
    """One PyTorch call that computes one application of ``name``, or None
    where none does (the reductions and exp take two)."""
    c = torch.tensor(1.0000001, dtype=x.dtype, device=x.device)
    calls = dict(
        fma=lambda: torch.addcmul(torch.tensor(1e-9, dtype=x.dtype,
                                               device=x.device), x, c),
        sub_shift=lambda: torch.roll(x, -1, dims=1),
        sub_shift4=lambda: torch.roll(x, -4, dims=1),
        lead_roll=lambda: torch.roll(x, -1, dims=0),
        # writes the (40, 36) layout; the way back is a view
        transpose2x=lambda: torch.mul(x.transpose(0, 1), c),
        lane_bcast=lambda: torch.mul(x, _multiplier(x)))
    return calls.get(name)


def _lib():
    fn = _build.load("opclass").opclass_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 2
                       + [ctypes.c_long, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def opclass(name: str, x, k: int):
    """``k`` applications of class ``name`` to x (36, 40, lanes) float32:
    the kernel for a CUDA tensor (a new output array; lanes a multiple of
    32), the plain version for a CPU one.  Counts its launches in
    ``opclass.launches``."""
    if x.device.type == "cpu":
        return opclass_plain(name, x, k)
    if x.device.type != "cuda":
        raise ValueError(f"no op-class kernel for device {x.device}")
    if (x.dtype != torch.float32 or x.dim() != 3
            or tuple(x.shape[:2]) != (NANG, MF) or x.shape[2] % 32
            or not x.is_contiguous()):
        raise ValueError(f"op-class kernel takes a contiguous float32 "
                         f"(36, 40, 32·n) array, not {x.dtype} "
                         f"{tuple(x.shape)}")
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = _lib()(CLASSES.index(name), x.data_ptr(), out.data_ptr(),
                     x.shape[2], k,
                     torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"opclass kernel launch failed: CUDA error {err}")
    opclass.launches += 1
    return out


opclass.launches = 0


def bounds(name: str, lanes: int, k: int) -> dict:
    """The least time (ms) of one call for the class's own work: ``hbm``
    (the array read and written once), ``ops`` (float32 operations at the
    FP32 peak: 2 an element and application for fma — one FMA — and for
    the reductions — the add into the line's sum and the add of the
    scaled sum — 1 for lane_bcast and transpose2x's scaling; for exp the
    ex2 at the special-function rate), ``smem`` (transpose2x only: each of
    its two transposes moves every element across threads, at least one
    shared-memory round trip, a write and a read, an element and
    application; a shift along a line a thread holds needs no on-chip
    movement, a register rotation, and a reduction along it none across
    lanes), and ``bound`` (the largest) with ``by`` its name.
    ``smem_first`` is the first design's shared-memory bound of the five
    IN_REGISTERS classes (each application reads and writes each element
    in shared memory, a reduction reads it once more), kept beside it."""
    n = NANG * MF * lanes
    t = dict(hbm=2 * 4 * n / HBM_BYTES_PER_S * 1e3, ops=0.0, smem=0.0,
             smem_first=0.0)
    if name in ("fma", "lead_reduce", "sub_reduce"):
        t["ops"] = 2 * n * k / FP32_OPS_PER_S * 1e3
    elif name in ("lane_bcast", "transpose2x"):
        t["ops"] = n * k / FP32_OPS_PER_S * 1e3
    elif name == "exp":
        t["ops"] = n * k / SFU_OPS_PER_S * 1e3
    if name == "transpose2x":
        t["smem"] = 4 * 4 * n * k / SMEM_BYTES_PER_S * 1e3
    elif name in IN_REGISTERS:
        trips = 3 if name.endswith("reduce") else 2
        t["smem_first"] = trips * 4 * n * k / SMEM_BYTES_PER_S * 1e3
    t["by"] = max(("hbm", "ops", "smem"), key=lambda key: t[key])
    t["bound"] = t[t["by"]]
    return t


def cuda_ms(fn, reps: int) -> float:
    """Mean device time (ms) of ``fn(y)`` chained ``reps`` times from
    ``fn``'s first (warm-up) result, as the reference times its calls."""
    y = fn(None)
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for _ in range(reps):
        y = fn(y)
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def start(lanes: int, device) -> torch.Tensor:
    """The reference's input: uniform [0, 1) from default_rng(0)."""
    return torch.as_tensor(np.random.default_rng(0).random(
        (NANG, MF, lanes)), dtype=torch.float32, device=device)


def check(name: str, x, k: int) -> dict:
    """The kernel against the plain version on x: max|k−p| and its ratio
    to max|p|; ``ok`` is equality for the layout classes and 1e-6 of the
    maximum for the others."""
    got, want = opclass(name, x, k), opclass_plain(name, x, k)
    d = float((got - want).abs().max())
    rel = d / float(want.abs().max())
    ok = bool(torch.isfinite(got).all()) and (
        d == 0.0 if name in LAYOUT else rel <= 1e-6)
    return dict(max_abs_err=d, max_rel_err=rel, ok=ok)


def measure(name: str, x, k: int, reps: int) -> dict:
    """One class at x's size: kernel, plain and library times (ms a call
    of k applications), ns per application per 128-lane tile, bounds."""
    lanes = x.shape[2]
    ms = cuda_ms(lambda y: opclass(name, x if y is None else y, k), reps)
    plain = cuda_ms(lambda y: opclass_plain(name, x if y is None else y, k),
                    max(1, reps // 4))
    lib = library_call(name, x)
    lib_ms = (cuda_ms(lambda y: lib(), reps) * k) if lib else None
    b = bounds(name, lanes, k)
    return dict(name=name, k=k, lanes=lanes, ms=ms, plain_ms=plain,
                library_ms=lib_ms,
                ns_per_app_tile=ms * 1e6 / (k * lanes / TILE),
                bound_ms=b["bound"], bound_by=b["by"],
                share=b["bound"] / ms, hbm_ms=b["hbm"], ops_ms=b["ops"],
                smem_ms=b["smem"], smem_first_ms=b["smem_first"])


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--k", type=int, default=64)
    ap.add_argument("--lanes", type=int, default=128 * 1024)
    ap.add_argument("--reps", type=int, default=8)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("opclass: no CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    _build.build(["opclass"])
    x = start(a.lanes, torch.device("cuda"))
    for name in CLASSES:
        small = check(name, x[..., :min(a.lanes, 16384)].contiguous(), 8)
        big = check(name, x, a.k)
        r = measure(name, x, a.k, a.reps)
        print(json.dumps(dict(r, card=card, check=small, check_full=big)),
              flush=True)
        if not (small["ok"] and big["ok"]):
            raise SystemExit(f"opclass {name}: kernel disagrees")


if __name__ == "__main__":
    main()
