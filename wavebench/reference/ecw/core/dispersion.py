"""Finite-depth dispersion relation and per-frequency depth properties.

Copied unchanged from ``ecwam_tpu/core/dispersion.py`` (numpy only, no
JAX), with its imports pointed at ``wavebench.reference.ecw``: the port
imports nothing of the JAX package.

Host-side (NumPy, float64) precompute equivalent of the reference's
  - Newton solve of ω² = g·k·tanh(k·d)      (aki.F90:28-47)
  - per-(point, frequency) property tables  (depthprpt.F90:44-66)
  - depth-limited max energy                (initdpthflds.F90:86-93)

These run once at init (and again only when depth/currents change), so plain
vectorized NumPy is the right tool; the results are shipped to device as
constants of the jitted step.
"""

from __future__ import annotations

import numpy as np

from wavebench.reference.ecw.core import constants as c

GAM_B_J = 0.8          # Battjes-Janssen gamma (yowshal.F90:21)
BATHYMAX = 998.999     # depth assigned to "deep" / land points (yowshal.F90:22)


def aki(om: np.ndarray, depth: np.ndarray, ebs: float = 1.0e-4) -> np.ndarray:
    """Wave number k solving om² = g·k·tanh(k·depth).

    Vectorized Newton iteration reproducing aki.F90:28-47: start from
    max(deep-water k/?, shallow estimate), iterate until relative change
    < ``ebs``; where k·d > DKMAX use the deep-water limit om²/g.
    """
    om = np.asarray(om, dtype=np.float64)
    depth = np.asarray(depth, dtype=np.float64)
    om, depth = np.broadcast_arrays(om, depth)
    shape = om.shape
    om = om.reshape(-1).copy()
    depth = depth.reshape(-1).copy()

    akm1 = om**2 / (4.0 * c.G)
    akm2 = om / (2.0 * np.sqrt(c.G * depth))
    ao = np.maximum(akm1, akm2)

    deep = depth * ao > c.DKMAX
    out = np.where(deep, om**2 / c.G, ao)

    # full-array masked Newton (typically 5-8 iterations): per-iteration
    # boolean fancy indexing costs O(n) gathers/scatters per step and
    # dominated the O512 model build (~85 s for 15M entries); whole-array
    # where-updates are ~20x faster and produce identical results
    done = deep.copy()
    ao = ao.copy()
    for _ in range(200):
        bo = np.minimum(depth * ao, 50.0)      # deep rows are done; clip
        th = c.G * ao * np.tanh(bo)
        sth = np.sqrt(th)
        new = ao + (om - sth) * sth * 2.0 / (
            th / ao + c.G * bo / np.cosh(bo) ** 2)
        conv = np.abs(ao - new) <= ebs * new
        np.copyto(out, new, where=~done & conv)
        ao = np.where(done, ao, new)
        done |= conv
        if done.all():
            break
    else:  # pragma: no cover - safety net
        np.copyto(out, ao, where=~done)
    return out.reshape(shape)


def depth_properties(depth: np.ndarray, fr: np.ndarray) -> dict[str, np.ndarray]:
    """Per-(point, frequency) wave property tables (depthprpt.F90:44-66).

    Returns dict of arrays shaped ``(npts, nfre)``:
      wavnum     wave number k
      cinv       inverse phase velocity k/ω
      cgroup     group speed
      xk2cg      k²·c_g
      omosnh2kd  ω / sinh(2kd)      (0 in deep water)
      stokfac    2gk²/(ω·tanh(2kd)) (Stokes-drift factor)
    """
    depth = np.asarray(depth, dtype=np.float64)[:, None]
    om = (c.ZPI * np.asarray(fr, dtype=np.float64))[None, :]

    ak = aki(om, depth)
    akd = ak * depth
    shallow = akd <= 10.0
    # guard deep-water sinh overflow before masking
    akd_s = np.minimum(akd, 10.0)

    cgroup_sh = 0.5 * np.sqrt(c.G * np.tanh(akd_s) / ak) * (
        1.0 + 2.0 * akd_s / np.sinh(2.0 * akd_s))
    cgroup_dp = (c.G / (4.0 * c.PI)) / (om / c.ZPI)
    cgroup = np.where(shallow, cgroup_sh, cgroup_dp)

    omosnh2kd = np.where(shallow, om / np.sinh(2.0 * akd_s), 0.0)
    stokfac = np.where(
        shallow,
        2.0 * c.G * ak**2 / (om * np.tanh(2.0 * akd_s)),
        2.0 / c.G * om**3)

    return dict(
        wavnum=ak,
        cinv=ak / om,
        cgroup=cgroup,
        xk2cg=ak**2 * cgroup,
        omosnh2kd=omosnh2kd,
        stokfac=stokfac,
    )


def depth_limited_energy(depth: np.ndarray) -> np.ndarray:
    """Maximum depth-limited variance EMAXDPT (initdpthflds.F90:86-93)."""
    depth = np.asarray(depth, dtype=np.float64)
    gam = np.where(depth < 4.0, GAM_B_J * depth / 4.0, GAM_B_J)
    return 0.0625 * (gam * depth) ** 2
