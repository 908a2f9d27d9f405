"""CTU advection pass on the SRL spectrum: CUDA kernel + plain version.

Kernel A of the port (``csrc/advect.cu``), the counterpart of
``ecwam_tpu/ops/propagation_pallas.py: advect_pallas``.  :func:`advect`
launches the kernel for a CUDA tensor and runs :func:`advect_plain` (the
plain PyTorch algebra of :mod:`.propagation_fused`) for a CPU tensor.

Semantics shared by both: ``f_in`` is (nsrl, nang·nft) with k-major
lanes ``k·nft + m``; lanes with ``m < nf`` get one CTU pass (wrap slots
must be current, rows outside the body and invalid rows come out zero),
lanes with ``m >= nf`` are copied through — so a fast-wave sub-band
pass (nf = ifrelfmax) needs no gather/scatter around it.  irefra 0 and
1 only; current refraction is not ported.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ecwam_tpu_torch.core import constants as c
from ecwam_tpu_torch import _build
from ecwam_tpu_torch.ops import propagation_fused as pfz

# lane-constant rows the kernel reads, in the order of csrc/advect.cu's Lc
LC_ROWS = ("s", "cth", "east", "north", "dt", "sp", "sm", "sd_p", "cd_p",
           "sd_m", "cd_m")
CMTODEG = 360.0 / c.CIRC

_F32_TABLES = ("cg_srl", "cg_land", "taps_dn", "taps_up", "sea_own",
               "cgland", "geom", "valid", "obs")


def lane_tensors(lc_np: dict, dtype, device) -> dict:
    """Lane constants (numpy, from :func:`propagation_fused.lane_consts`)
    as tensors, plus ``rows``: the (len(LC_ROWS), L) block the kernel
    reads."""
    out = {k: torch.as_tensor(v, dtype=dtype, device=device)
           for k, v in lc_np.items() if isinstance(v, np.ndarray)}
    out["rows"] = torch.stack([out[k] for k in LC_ROWS]).contiguous()
    return out


def advect_plain(f_in, tabs, lc, *, nang: int, nf: int, S: int, EW: int,
                 irefra: int):
    """Plain PyTorch pass with the semantics of :func:`advect`."""
    nsrl, lw = f_in.shape
    nft = lw // nang
    dev = dict(tabs, obs=tabs["obs"][:, :, :nf])
    if "pf" in tabs:
        dev["pf"] = tabs["pf"][:, :, :nf]
    f3 = f_in.reshape(nsrl, nang, nft)
    out = pfz.advect_xla(
        f3[:, :, :nf].reshape(nsrl, nang * nf), tabs["cg_srl"][:, :nf], dev,
        lc, tabs["cg_land"][:nf], nang=nang, nfre=nf, irefra=irefra, S=S,
        EW=EW)
    if nf == nft:
        return out
    res = f3.clone()
    res[:, :, :nf] = out.reshape(nsrl, nang, nf)
    return res.reshape(nsrl, lw)


def _check(name, t, shape, dtype, device):
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} is {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _lib():
    lib = _build.load("advect")
    fn = lib.advect_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 16 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def advect(f_in, tabs, lc, *, nang: int, nf: int, S: int, EW: int,
           irefra: int):
    """One CTU pass (see the module docstring).  ``tabs`` holds the SRL
    tables (``propagation_fused.device_tables`` plus cg_srl, cg_land and,
    for irefra=1, grads and pf); ``lc`` the lane tensors of
    :func:`lane_tensors` for ``nf`` frequencies.  Returns a new tensor."""
    if f_in.device.type == "cpu":
        return advect_plain(f_in, tabs, lc, nang=nang, nf=nf, S=S, EW=EW,
                            irefra=irefra)
    if f_in.device.type != "cuda":
        raise ValueError(f"no advection kernel for device {f_in.device}")
    if irefra not in (0, 1):
        raise NotImplementedError(f"irefra={irefra} is not ported")
    nsrl, lw = f_in.shape
    nft = lw // nang
    dev, f32 = f_in.device, torch.float32
    if lw != nang * nft or not 1 <= nf <= nft or nsrl % S or nsrl < 3 * S:
        raise ValueError(f"bad advection shape {tuple(f_in.shape)} "
                         f"(nang={nang}, nf={nf}, S={S})")
    nseg = nsrl // S - 3
    _check("f_in", f_in, (nsrl, lw), f32, dev)
    shapes = dict(cg_srl=(nsrl, nft), cg_land=(nft,),
                  taps_dn=(nsrl, 3, EW), taps_up=(nsrl, 3, EW),
                  sea_own=(nsrl, 2), cgland=(nsrl, 2), geom=(nsrl, 8),
                  valid=(nsrl,), obs=(nsrl, 8, nft))
    for name in _F32_TABLES:
        _check(name, tabs[name], shapes[name], f32, dev)
    for name in ("dn_base", "up_base"):
        _check(name, tabs[name], (nseg,), torch.int32, dev)
    _check("lc rows", lc["rows"], (len(LC_ROWS), nang * nf), f32, dev)
    pf = grads = None
    if irefra == 1:
        pf, grads = tabs["pf"], tabs["grads"]
        _check("pf", pf, (nsrl, 3, nft), f32, dev)
        _check("grads", grads, (nsrl, 8), f32, dev)

    out = torch.empty_like(f_in)

    def ptr(t):
        return None if t is None else t.data_ptr()
    with torch.cuda.device(dev):
        err = _lib()(
            ptr(f_in), ptr(out), ptr(tabs["cg_srl"]), ptr(tabs["cg_land"]),
            ptr(tabs["taps_dn"]), ptr(tabs["taps_up"]), ptr(tabs["sea_own"]),
            ptr(tabs["cgland"]), ptr(tabs["geom"]), ptr(tabs["valid"]),
            ptr(tabs["obs"]), ptr(pf), ptr(grads), ptr(tabs["dn_base"]),
            ptr(tabs["up_base"]), ptr(lc["rows"]),
            nsrl, nang, nft, nf, S, EW, irefra, CMTODEG,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"advect kernel launch failed: CUDA error {err}")
    advect.launches += 1
    return out


advect.launches = 0
