"""Sea-ice wave attenuation (SDICE dispatcher, the SDICE3 model).

Port of ``ecwam_tpu/ops/physics/sdice.py``: the common SL/FLD update
(sdice1.F90:125-140 and twins), SDICE3's empirical h^1.25·f^4.5 model
(sdice3.F90:55-95, IMODEL=2, the cy50r1 LCIWA3 default) and the
dispatcher.  SDICE1 (the tabulated scattering model) and SDICE2
(ice-water drag) are not ported yet: ROADMAP A4.

All take fl1/fld/sl (nang, nfre, npts) and return (fld, sl, slice_) with
``slice_`` the implicit-factor-modulated pure-ice term.
"""

from __future__ import annotations

import numpy as np
import torch

from ecwam_tpu_torch.core import constants as c
from ecwam_tpu_torch.ops.physics import const

XIMP = 1.0
CDICE = 0.1274 * (c.ZPI / np.sqrt(c.G)) ** 4.5     # sdice3.F90 IMODEL=2


def _apply(fl1, fld, sl, alp, cgroup, cicover, idelt):
    """Common SL/FLD/SLICE update (sdice1.F90:125-140 and twins)."""
    delt5 = XIMP * idelt
    fldice = -alp * cgroup[None]                 # (nang, nfre, npts) via bc
    slice_ = fl1 * fldice
    sl = sl + cicover[None, None, :] * slice_
    fld = fld + cicover[None, None, :] * fldice
    gtemp1 = torch.clamp(1.0 - delt5 * fldice, min=1.0)
    return fld, sl, slice_ / gtemp1


def sdice3(fl1, fld, sl, wavnum, cgroup, cicover, cithick, tb, idelt,
           alpfac=None):
    """Empirical attenuation ~ h^1.25 f^4.5 (sdice3.F90:55-95, IMODEL=2)."""
    fr45 = const(np.asarray(tb.fr) ** 4.5, fl1)
    af = torch.ones_like(cicover) if alpfac is None else alpfac
    alp = (2.0 * CDICE * cithick[None, :] ** 1.25 * fr45[:, None]
           * af[None, :])                                  # (nfre, npts)
    return _apply(fl1, fld, sl, alp[None], cgroup, cicover, idelt)


def sdice(fl1, fld, sl, wavnum, cgroup, cicover, cithick, tb, idelt, *,
          lciwa1=False, lciwa2=False, lciwa3=False, alpfac=None):
    """Dispatcher (sdice.F90): apply the enabled attenuation models."""
    if lciwa1 or lciwa2:
        raise NotImplementedError("sea-ice attenuation lciwa1/lciwa2 (SDICE1/"
                                  "SDICE2) is not ported: ROADMAP A4")
    slice_ = torch.zeros_like(fl1)
    if lciwa3:
        fld, sl, slice_ = sdice3(fl1, fld, sl, wavnum, cgroup, cicover,
                                 cithick, tb, idelt, alpfac=alpfac)
    return fld, sl, slice_
