"""The IMPLSCH chain on SRL rows and on the compact spectrum: the plain
PyTorch versions of the port's kernel B/C wrappers
(``ecwam_tpu_torch/ops/physics/implsch_cuda.py``), frozen here with the
row layouts they read and write.

Layouts (point index fastest in every row block, no lane pad):
  f_srl (nsrl, nang·nfre_red)  k-major advected spectrum rows
  tail  (nsrl, nang·(nfre−nfre_red)) k-major diagnostic tail rows, or
        None when nfre == nfre_red
  env2d (3·nfre, n)             [wavnum; cinv; xk2cg] row blocks
  scal  (14, n)                 SCAL_IN rows
"""

from __future__ import annotations

import dataclasses

import torch

from wavebench.reference.ecw.ops.physics import implsch as impl


# packed per-point scalar input rows (forcing + env + stress state)
SCAL_IN = ("wswave", "wdwave", "aird", "wstar", "cicover", "cithick",
           "depth", "emaxdpt",
           "ufric", "tauw", "tauwdir", "z0m", "z0b", "chrnck")
N_FRC = 6                     # leading forcing rows
STRESS_KEYS = ("ufric", "tauw", "tauwdir", "z0m", "z0b", "chrnck")
# per-frequency env fields → row blocks of the (3·nfre, n) matrix
ENV_FIELDS = ("wavnum", "cinv", "xk2cg")

# minimal-mode outputs: exactly the state that feeds the next step
SCAL_OUT_MIN = STRESS_KEYS
# full-mode diagnostics (implsch state keys, io/products.py consumers);
# mij rides as float in the packed rows (cast back by unpack_scal_out)
SCAL_OUT_FULL = STRESS_KEYS + (
    "mij", "phiwa", "emean", "fmean", "f1mean", "akmean", "xkmean",
    "emeanws", "fmeanws", "wsemean", "wsfmean",
    "tauxd", "tauyd", "tauocxd", "tauocyd", "tauoc",
    "phiocd", "phieps", "phiaw", "em_oc", "f1_oc",
    "ustokes", "vstokes", "strnms")
# u* forcing: U10 from the log profile after the mode's rows
SCAL_OUT_UST = SCAL_OUT_FULL + ("wswave",)
SCAL_OUT_UST_MIN = SCAL_OUT_MIN + ("wswave",)

def minimal_config(cfg: impl.PhysicsConfig) -> impl.PhysicsConfig:
    """A PhysicsConfig stripped of the pure-diagnostic work (fluxes,
    Stokes) for between-output-date steps — the prognostic state
    (fl1 + stress) is the same; only output-time diagnostics are
    skipped (wamodel.F90 computes them for output/coupling)."""
    return dataclasses.replace(cfg, lcflx=False, lstokes=False, lstrn=False)


def _row_keys(full: bool, ustar: bool) -> tuple:
    if full:
        return SCAL_OUT_UST if ustar else SCAL_OUT_FULL
    return SCAL_OUT_UST_MIN if ustar else SCAL_OUT_MIN


def out_keys(cfg: impl.PhysicsConfig, full: bool) -> tuple:
    """The output rows of a step: the stress rows (minimal mode) or the
    full mode's, and under u* forcing U10 after them."""
    return _row_keys(full, cfg.icode_wnd in (1, 2))


def unpack_scal_out(so, *, full: bool) -> dict:
    """(NSO, n) packed output rows → state dict (mij back to int64); u*
    forcing's extra row comes out as ``wswave``."""
    keys = _row_keys(full, so.shape[0] == len(_row_keys(full, True)))
    out = {k: so[i] for i, k in enumerate(keys)}
    if "mij" in out:
        out["mij"] = out["mij"].to(torch.int64)
    return out


def pack_scal_out(state: dict, *, full: bool):
    """A chain's state dict → (NSO, n) rows; keys the configuration does
    not compute are zero, as in the TPU kernel; u* forcing's ``wswave``
    (in the state only then) after the mode's rows."""
    keys = _row_keys(full, "wswave" in state)
    like = state["ufric"]
    return torch.stack([state[k].to(like.dtype) if k in state
                        else torch.zeros_like(like) for k in keys])


def _unpack_inputs(cfg, env2d, scal):
    """(env, frc, stress tuple in STRESS_KEYS order) of the plain chain
    from the packed env and scalar rows."""
    nfre = cfg.tables.nfre
    si = {k: scal[i] for i, k in enumerate(SCAL_IN)}
    env = {k: env2d[i * nfre:(i + 1) * nfre] for i, k in
           enumerate(ENV_FIELDS)}
    env["depth"], env["emaxdpt"] = si["depth"], si["emaxdpt"]
    frc = {k: si[k] for k in SCAL_IN[:N_FRC]}
    return env, frc, tuple(si[k] for k in STRESS_KEYS)


def srl_inputs(cfg, f_srl, env2d, scal, tail, *, nang: int,
               nfre_red: int):
    """SRL-row inputs → the arguments of :func:`.implsch.implsch`:
    (fl1 (nang, nfre, nsrl), env, frc, stress tuple in STRESS_KEYS
    order)."""
    nfre = cfg.tables.nfre
    nsrl = f_srl.shape[0]
    fl = f_srl.reshape(nsrl, nang, nfre_red).permute(1, 2, 0)
    if tail is not None:
        fl = torch.cat([fl, tail.reshape(nsrl, nang, nfre - nfre_red)
                        .permute(1, 2, 0)], dim=1)
    return (fl,) + _unpack_inputs(cfg, env2d, scal)


def _outputs(state, full: bool):
    return pack_scal_out(state, full=full), (state["xllws"] if full
                                             else None)


def implsch_srl_plain(cfg, f_srl, env2d, scal, tail, *, nang: int,
                      nfre_red: int, full: bool = False):
    """The plain PyTorch chain (:func:`.implsch.implsch`) on SRL rows:
    (f_srl, stress6, tail), or in full mode (f_srl, scal_out (30, nsrl),
    tail, xllws (nang, nfre, nsrl)).  U10 forcing only, as the kernel."""
    impl.check_ported(cfg, srl=True)
    nsrl = f_srl.shape[0]
    fl, env, frc, stress = srl_inputs(cfg, f_srl, env2d, scal, tail,
                                      nang=nang, nfre_red=nfre_red)
    out, state = impl.implsch(cfg, fl, env, frc, *stress)
    rows = out.permute(2, 0, 1)
    f_new = rows[:, :, :nfre_red].reshape(nsrl, -1).contiguous()
    t_new = (rows[:, :, nfre_red:].reshape(nsrl, -1).contiguous()
             if tail is not None else None)
    so, xllws = _outputs(state, full)
    return (f_new, so, t_new) + ((xllws,) if full else ())


def implsch_compact_plain(cfg, fl1, env2d, scal, *, full: bool = False):
    """The plain PyTorch chain on the compact (nang, nfre, n) spectrum:
    (fl1, stress6), or in full mode (fl1, scal_out (30, n), xllws); under
    u* forcing the U10 row after the mode's rows."""
    env, frc, stress = _unpack_inputs(cfg, env2d, scal)
    out, state = impl.implsch(cfg, fl1, env, frc, *stress)
    so, xllws = _outputs(state, full)
    return (out, so) + ((xllws,) if full else ())
