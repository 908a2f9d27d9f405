"""Shallow-water source terms: bottom friction and depth-induced breaking.

Port of ``ecwam_tpu/ops/physics/shallow.py``: SBOTTOM
(sbottom.F90:41-60) and SDIWBK (sdiwbk.F90:44-75).  Both act on the
first ``nfre_red`` frequencies only.
"""

from __future__ import annotations

import torch

from wavebench.reference.ecw.core import constants as c
from wavebench.reference.ecw.core.dispersion import BATHYMAX

DEPTHTRS = 50.0          # breaking only where depth < 50 m (sdiwbk.F90)


def _add_lowfre(arr, add):
    """``arr[:, :m] + add`` over the leading ``m = add.shape[1]``
    frequencies, the rest unchanged."""
    m = add.shape[1]
    return torch.cat([arr[:, :m] + add, arr[:, m:]], dim=1)


def sbottom(fl1, fld, sl, wavnum, depth, nfre_red: int):
    """Bottom friction SB = −2·0.038/g · k/sinh(2kd) · F (sbottom.F90:41-60)."""
    const = -2.0 * 0.038 * c.GM1
    arg = torch.clamp(2.0 * depth[None, :] * wavnum[:nfre_red], max=50.0)
    sbo = torch.where(depth[None, :] < BATHYMAX,
                      const * wavnum[:nfre_red] / torch.sinh(arg),
                      torch.zeros_like(arg))
    sl = _add_lowfre(sl, sbo[None] * fl1[:, :nfre_red])
    fld = _add_lowfre(fld, sbo[None].expand_as(fld[:, :nfre_red]))
    return fld, sl


def sdiwbk(fl1, fld, sl, depth, emaxdpt, emean, f1mean, nfre_red: int,
           *, lbiwbk: bool = True):
    """Depth-induced wave breaking (sdiwbk.F90:44-75).

    Solves Q = exp(-alph·(1-Q)) for the breaking probability by 15
    Newton steps with the reference's early exit (sdiwbk.F90:64-71):
    once |q−q_old|/q_old < 1e-5 the value is frozen.
    """
    if not lbiwbk:
        return fld, sl
    alph = 2.0 * emaxdpt / emean
    arg = torch.clamp(alph, max=50.0)
    q_old = torch.exp(-arg)
    q_out = q_old
    done = torch.zeros_like(q_old, dtype=torch.bool)
    for _ in range(15):
        expq = torch.exp(-arg * (1.0 - q_old))
        q = q_old - (expq - q_old) / (arg * expq - 1.0)
        rel_err = torch.abs(q - q_old) / q_old
        q_out = torch.where(done, q_out, q)
        done = done | (rel_err < 1.0e-5)
        q_old = torch.where(done, q_old, q)
    q = torch.clamp(q_out, max=1.0)
    sds = 2.0 * alph * q * f1mean                     # COEF_B_J = 2
    sds = torch.where(depth < DEPTHTRS, sds, torch.zeros_like(sds))
    sl = _add_lowfre(sl, -sds[None, None, :] * fl1[:, :nfre_red])
    fld = _add_lowfre(fld, (-sds[None, None, :]).expand_as(
        fld[:, :nfre_red]))
    return fld, sl
