"""CTU advection pass on the SRL spectrum: CUDA kernel + plain version.

Kernel A of the port (``csrc/advect.cu``), the counterpart of
``ecwam_tpu/ops/propagation_pallas.py: advect_pallas``.  :func:`advect`
launches the kernel for a CUDA tensor and runs :func:`advect_plain` (the
plain PyTorch algebra of :mod:`.propagation_fused`) for a CPU tensor.

Semantics shared by both: ``f_in`` is (nsrl, nang·nft) with k-major
lanes ``k·nft + m``; lanes with ``m < nf`` get one CTU pass (wrap slots
must be current, rows outside the body and invalid rows come out zero),
lanes with ``m >= nf`` are copied through — so a fast-wave sub-band
pass (nf = ifrelfmax) needs no gather/scatter around it.  With current
refraction (irefra 2/3) the σ̇ frequency shift couples each lane to its
neighbours m±1, so a sub-band pass computes ``nf`` = ifrelfmax+1
frequencies (the lane constants and the band-edge clamp) and writes only
the first ``nw``; lanes from ``nw`` up are copied through.  ``with_cfl``
also returns the per-row CFL-violation mask of the pass (ctuw.F90:
238-300) and, as ``"stats"``, the largest east/west, north/south and
outflow Courant numbers over the valid rows (CHECKCFL).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ecwam_tpu_torch.core import constants as c
from ecwam_tpu_torch import _build
from ecwam_tpu_torch.ops import propagation_fused as pfz
from ecwam_tpu_torch.ops import propagation_rebase as prb

# lane-constant rows the kernel reads, in the order of csrc/advect.cu's Lc
LC_ROWS = ("s", "cth", "east", "north", "dt", "sp", "sm", "sd_p", "cd_p",
           "sd_m", "cd_m", "ss_p", "sc_p", "cc_p", "ss_m", "sc_m", "cc_m",
           "nf_sc", "nf_cc", "nf_ss", "dfp", "dfm")
CMTODEG = 360.0 / c.CIRC

# the float tables kernel A reads (obs only where some factor is not 1)
_F32_TABLES = ("cg_srl", "cg_land", "ktaps", "sea_own", "cgland", "geom",
               "valid", "obs")


def lane_tensors(lc_np: dict, dtype, device) -> dict:
    """Lane constants (numpy, from :func:`propagation_fused.lane_consts`)
    as tensors, ``fratio`` as a float, plus ``rows``: the
    (len(LC_ROWS), L) block the kernel reads."""
    out = {k: (torch.as_tensor(v, dtype=dtype, device=device)
               if isinstance(v, np.ndarray) else v)
           for k, v in lc_np.items()}
    out["rows"] = torch.stack([out[k] for k in LC_ROWS]).contiguous()
    return out


def advect_plain(f_in, tabs, lc, *, nang: int, nf: int, S: int, EW: int,
                 irefra: int, nw: int | None = None, with_cfl=False):
    """Plain PyTorch pass with the semantics of :func:`advect`."""
    nsrl, lw = f_in.shape
    nft = lw // nang
    nw = nf if nw is None else nw
    dev = dict(tabs, obs=tabs["obs"][:, :, :nf])
    if "pf" in tabs:
        dev["pf"] = tabs["pf"][:, :, :nf]
    f3 = f_in.reshape(nsrl, nang, nft)
    res = pfz.advect_xla(
        f3[:, :, :nf].reshape(nsrl, nang * nf), tabs["cg_srl"][:, :nf], dev,
        lc, tabs["cg_land"][:nf], nang=nang, nfre=nf, irefra=irefra, S=S,
        EW=EW, with_cfl=with_cfl)
    out = res[0] if with_cfl else res
    if nw < nft:
        full = f3.clone()
        full[:, :, :nw] = out.reshape(nsrl, nang, nf)[:, :, :nw]
        out = full.reshape(nsrl, lw)
    return (out,) + tuple(res[1:]) if with_cfl else out


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
        fn.argtypes = ([ctypes.c_void_p] * 20 + [ctypes.c_int] * 11
                       + [ctypes.c_float] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.advect_smem.argtypes = [ctypes.c_int] * 6
        lib.advect_smem.restype = ctypes.c_long
    return lib


def tile_rows(lib, nft, nf, ew2, S, cur, cfl, smem_max) -> int:
    """Rows a tile: the largest of 32, 16, 8 that divides S and whose
    double-buffered tiles fit the card's shared memory."""
    for rt in (32, 16, 8):
        if rt <= S and S % rt == 0 and 0 < lib.advect_smem(
                nft, nf, ew2, rt, int(cur), int(cfl)) <= smem_max:
            return rt
    raise ValueError(f"no advection tile fits {smem_max} bytes of shared "
                     f"memory (nft={nft}, ew2={ew2}, S={S})")


def advect(f_in, tabs, lc, *, nang: int, nf: int, S: int, EW: int,
           irefra: int, nw: int | None = None, with_cfl=False):
    """One CTU pass (see the module docstring).  ``tabs`` holds the SRL
    tables (``propagation_fused.device_tables`` plus cg_srl, cg_land and,
    for irefra ≥ 1, grads and pf, and for irefra 2/3 uv) and the kernel's
    rebased taps (``propagation_rebase.kernel_tables``); ``lc`` the lane
    tensors of :func:`lane_tensors` for ``nf`` frequencies; ``nw`` (≤ nf,
    default nf) the frequencies written; ``EW`` the original tap width
    (the plain version's).  Returns a new tensor, or with ``with_cfl`` (out, cfl mask (nsrl,) bool) and, for
    ``"stats"``, the three largest Courant numbers as 0-d tensors."""
    if f_in.device.type == "cpu":
        return advect_plain(f_in, tabs, lc, nang=nang, nf=nf, S=S, EW=EW,
                            irefra=irefra, nw=nw, with_cfl=with_cfl)
    if f_in.device.type != "cuda":
        raise ValueError(f"no advection kernel for device {f_in.device}")
    if irefra not in (0, 1, 2, 3):
        raise ValueError(f"irefra={irefra}")
    nsrl, lw = f_in.shape
    nft = lw // nang
    nw = nf if nw is None else nw
    dev, f32 = f_in.device, torch.float32
    if (lw != nang * nft or not 1 <= nw <= nf <= nft or nsrl % S
            or nsrl < 3 * S):
        raise ValueError(f"bad advection shape {tuple(f_in.shape)} "
                         f"(nang={nang}, nf={nf}, nw={nw}, S={S})")
    nseg = nsrl // S - 3
    ktaps = tabs["ktaps"]
    ew2 = ktaps.shape[2] if ktaps.dim() == 4 else 0
    use_obs = not tabs["obs_ones"]
    _check("f_in", f_in, (nsrl, lw), f32, dev)
    shapes = dict(cg_srl=(nsrl, nft), cg_land=(nft,), sea_own=(nsrl, 2),
                  cgland=(nsrl, 2), geom=(nsrl, 8), valid=(nsrl,),
                  ktaps=(nsrl, 2, ew2, 4), obs=(nsrl, 8, nft))
    for name in _F32_TABLES:
        if name != "obs" or use_obs:
            _check(name, tabs[name], shapes[name], f32, dev)
    if not 1 <= ew2 <= EW:
        raise ValueError(f"rebased tap width {ew2} outside [1, EW={EW}]")
    for name, shape in (("dn_base", (nseg,)), ("up_base", (nseg,)),
                        ("kseg", (nseg, 4))):
        _check(name, tabs[name], shape, torch.int32, dev)
    _check("lc rows", lc["rows"], (len(LC_ROWS), nang * nf), f32, dev)
    pf = grads = uv = None
    if irefra:
        pf, grads = tabs["pf"], tabs["grads"]
        _check("pf", pf, (nsrl, 3, nft), f32, dev)
        _check("grads", grads, (nsrl, 8), f32, dev)
    if irefra in (2, 3):
        uv = tabs["uv"]
        _check("uv", uv, (nsrl, 2), f32, dev)

    lib = _lib()
    props = torch.cuda.get_device_properties(dev)
    rt = tile_rows(lib, nft, nf, ew2, S, irefra in (2, 3), bool(with_cfl),
                   getattr(props, "shared_memory_per_block_optin", 232448))
    nbands = -(-nang // prb.DIRS_PER_BAND)
    out = torch.empty_like(f_in)
    part = cfl = stats = None
    if with_cfl:
        part = torch.empty((nbands * 4, nsrl), dtype=torch.int32,
                           device=dev)
        cfl = torch.empty(nsrl, dtype=torch.int32, device=dev)
        stats = torch.empty((3, nsrl), dtype=f32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()
    with torch.cuda.device(dev):
        err = lib.advect_launch(
            ptr(f_in), ptr(out), ptr(tabs["cg_srl"]), ptr(tabs["cg_land"]),
            ptr(ktaps), ptr(tabs["sea_own"]), ptr(tabs["cgland"]),
            ptr(tabs["geom"]), ptr(tabs["valid"]),
            ptr(tabs["obs"]) if use_obs else None, ptr(pf), ptr(grads),
            ptr(uv), ptr(tabs["dn_base"]), ptr(tabs["up_base"]),
            ptr(tabs["kseg"]), ptr(lc["rows"]), ptr(part), ptr(cfl),
            ptr(stats), nsrl, nang, nft, nf, nw, S, ew2, rt, nbands, irefra,
            int(use_obs), CMTODEG, float(lc["fratio"]),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"advect kernel launch failed: CUDA error {err}")
    advect.launches += 1
    if not with_cfl:
        return out
    if with_cfl != "stats":
        return out, cfl != 0
    valid = tabs["valid"] > 0
    return out, cfl != 0, tuple(
        torch.where(valid, r, torch.zeros_like(r)).max() for r in stats)


advect.launches = 0
