"""First-guess stress state (port of ``ecwam_tpu/model/stepper.py:
initial_stress``)."""

from __future__ import annotations

import numpy as np
import torch

from ecwam_tpu_torch.core import constants as c
from ecwam_tpu_torch.core import physparams as pp


def initial_stress(setup, frc) -> dict:
    """First-guess stress state before the first physics call: the
    BUILDSTRESS no-restart path (buildstress.F90:236-242) — CDUSTARZ0's
    Hersbach-2011 CD(U10) (cdustarz0.F90:68-72) with TAUW = 0.1·u*² and
    TAUWDIR = the wind direction.  ``frc`` holds host (n,) arrays
    ``wswave``/``wdwave``; returns tensors on the setup's device."""
    wspmin = 1.0                       # userin.F90:917 default
    u10 = np.maximum(np.asarray(frc["wswave"], np.float64), wspmin)
    cd = np.minimum((c.C1CD + c.C2CD * u10**c.P1CD) * u10**c.P2CD,
                    c.CDMAX)
    ustar = np.maximum(np.sqrt(cd) * u10, c.EPSUS)
    z0 = np.maximum(
        pp.XNLEV / (np.exp(pp.XKAPPA
                           * np.minimum(u10 / ustar, 100.0)) - 1.0),
        1.0e-6)
    out = dict(ufric=ustar, tauw=0.1 * ustar**2,
               tauwdir=np.asarray(frc["wdwave"], np.float64), z0m=z0,
               z0b=np.zeros(u10.shape[0]),
               chrnck=np.maximum(c.G * z0 / ustar**2,
                                 setup.phys.params.alpha))
    return {k: torch.as_tensor(v, dtype=setup.dtype, device=setup.device)
            for k, v in out.items()}
