"""Diagnostic tail imposition and sea-ice masking.

Port of ``ecwam_tpu/ops/physics/tail_ice.py``: IMPHFTAIL
(imphftail.F90:40-55) and SETICE (setice.F90:38-60).
Layout: fl1 (nang, nfre, npts), mij 0-based (npts,).
"""

from __future__ import annotations

import torch

from wavebench.reference.ecw.core import constants as c

FLMIN = 0.00001          # minimum spectral energy (yowice.F90:22)
CITHRSH = 0.3            # ice mask threshold, LMASKICE=T (userin.F90:958)


def imphftail(fl1, mij, flm, wavnum, xk2cg):
    """Impose the diagnostic high-frequency tail (imphftail.F90:40-55).

    For m > mij:  F(k,m) = F(k,mij) · [1/(xk2cg·k)]_m / [1/(xk2cg·k)]_mij,
    floored at flm.
    """
    nang, nfre, _ = fl1.shape
    tailinv = 1.0 / (xk2cg * wavnum)                  # (nfre, npts)
    t_mij = torch.gather(tailinv, 0, mij[None, :])[0]
    fl1_mij = torch.gather(
        fl1, 1, mij[None, None, :].expand(nang, 1, -1))[:, 0, :]
    ratio = tailinv / t_mij[None, :]
    tail = torch.maximum(ratio[None, :, :] * fl1_mij[:, None, :],
                         flm[:, None, :])
    m_idx = torch.arange(nfre, device=fl1.device)[None, :, None]
    return torch.where(m_idx > mij[None, None, :], tail, fl1)


def setice(fl1, cicover, coswdif, *, cithrsh: float = CITHRSH):
    """Reset ice-covered points to directional noise (setice.F90:38-60)."""
    iced = cicover > cithrsh
    cireduc = torch.where(iced, torch.clamp(1.0 - cicover, min=c.EPSMIN),
                          torch.zeros_like(cicover))
    icefree = (~iced).to(fl1.dtype)
    noise = (cireduc * FLMIN)[None, :] * torch.clamp(coswdif, min=0.0) ** 2
    return fl1 * icefree[None, None, :] + noise[:, None, :]
