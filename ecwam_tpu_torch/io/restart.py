"""Binary restart files: spectra + stress state (SAVSPEC/GETSPEC +
SAVSTRESS/GETSTRESS equivalents).

Copied from ``ecwam_tpu/io/restart.py`` (numpy only, no JAX), with its
imports pointed at ``ecwam_tpu_torch`` (the port imports nothing of the
JAX package) and one change: the file is written uncompressed
(``np.savez``).  zlib gains 7 % on a spectrum and took about two minutes
for O320's 2.2 GB; ``np.load`` reads either form, so restarts still
interchange with the reference's.

The reference writes spectra `BLS<date>` and forcing/stress `LAW<date>`
binary restarts (src/ecwam/savspec.F90:92-157,
savstress.F90), re-readable under any processor count and with spectral
resolution padding (getspec.F90:673-770).  Here both live in one
layout-independent ``.npz`` per date; on load the spectrum is
padded/truncated to the target (nang, nfre) the same way GETSPEC's
KDEL/MDEL logic does (new bins get EPSMIN).
"""

from __future__ import annotations

import os

import numpy as np

from ecwam_tpu_torch.core import constants as c

STRESS_KEYS = ("ufric", "tauw", "tauwdir", "z0m", "z0b", "chrnck")
FORCING_KEYS = ("wswave", "wdwave", "aird", "wstar", "cicover")


def restart_name(date14: str) -> str:
    return f"restart_{date14}.npz"


def save_restart(path: str, date14: str, fl1, stress: dict,
                 forcing: dict | None = None, extra: dict | None = None):
    """Write one restart file; arrays are gathered to host."""
    payload = {"date": np.bytes_(date14), "fl1": np.asarray(fl1)}
    for k in STRESS_KEYS:
        payload[f"stress_{k}"] = np.asarray(stress[k])
    if forcing:
        for k in FORCING_KEYS:
            if k in forcing:
                payload[f"frc_{k}"] = np.asarray(forcing[k])
    for k, v in (extra or {}).items():
        payload[f"x_{k}"] = np.asarray(v)
    fn = os.path.join(path, restart_name(date14))
    np.savez(fn, **payload)
    return fn


def load_restart(fn: str, *, nang: int | None = None,
                 nfre: int | None = None):
    """Read a restart; optionally adapt spectral resolution
    (getspec.F90 KDEL/MDEL: pad new direction/frequency bins with EPSMIN,
    truncate extras)."""
    with np.load(fn) as z:
        date14 = bytes(z["date"]).decode()
        fl1 = z["fl1"]
        ka, mf = fl1.shape[0], fl1.shape[1]
        if nang is not None and nfre is not None and (ka, mf) != (nang, nfre):
            out = np.full((nang, nfre) + fl1.shape[2:], c.EPSMIN,
                          dtype=fl1.dtype)
            out[: min(ka, nang), : min(mf, nfre)] = \
                fl1[: min(ka, nang), : min(mf, nfre)]
            fl1 = out
        stress = {k: z[f"stress_{k}"] for k in STRESS_KEYS
                  if f"stress_{k}" in z}
        forcing = {k: z[f"frc_{k}"] for k in FORCING_KEYS
                   if f"frc_{k}" in z}
        extra = {k[2:]: z[k] for k in z.files if k.startswith("x_")}
    return dict(date=date14, fl1=fl1, stress=stress, forcing=forcing,
                extra=extra)
