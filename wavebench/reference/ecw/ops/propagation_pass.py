"""One CTU pass on the SRL spectrum in plain PyTorch: the plain version
of the port's kernel A wrapper (``ecwam_tpu_torch/ops/propagation_cuda.py:
advect_plain``), frozen here.

``f_in`` is (nsrl, nang·nft) with k-major lanes ``k·nft + m``; lanes with
``m < nf`` get one CTU pass (wrap slots must be current, rows outside the
body and invalid rows come out zero), lanes with ``m >= nf`` are copied
through.  With current refraction a sub-band pass computes ``nf``
frequencies and writes only the first ``nw``.
"""

from __future__ import annotations

import numpy as np
import torch

from wavebench.reference.ecw.ops import propagation_fused as pfz

# lane-constant rows the kernel reads, in the order of csrc/advect.cu's Lc
LC_ROWS = ("s", "cth", "east", "north", "dt", "sp", "sm", "sd_p", "cd_p",
           "sd_m", "cd_m", "ss_p", "sc_p", "cc_p", "ss_m", "sc_m", "cc_m",
           "nf_sc", "nf_cc", "nf_ss", "dfp", "dfm")



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
