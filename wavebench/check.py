"""The check that decides ``correct``: the timed path's own outputs,
after the window, against :class:`wavebench.reference.model.Reference`.

After the window closes the subject (the program, or the control in its
place) runs one more forcing period's worth of the window's own calls
from its state, and its outputs go to the host:

* ``s0``: the state the window left (the reference starts from it);
* ``s1``: after NEWWIND with the next period's forcing and the advection
  steps up to and including the first physics step (minimal mode);
* in a cell with output dates, ``s2`` after the steps that lead to an
  output date, then ``s3``, the state after the output date's step, its
  full-mode state and its host fields.

The reference follows each stage from the subject's state before it
(``s0``, then ``s2``).  The cold start is checked by itself on a sample
of points drawn from the seed.  Each number compared is, for the worst
field of a stage, the :data:`Q` quantile over the real sea points of
each point's gap: the norm of its difference (over its bins, for a
spectrum) over the field's RMS norm a point; directions on the circle,
over half a turn.  Beside those, :data:`POINTS` is the most points of any
field of those stages whose gap exceeds :data:`FAR`: a fault confined to
fewer points than the quantile leaves out still moves it.
"""

from __future__ import annotations

import numpy as np
import torch

from wavebench.reference import model as ref_mod

# directions, compared on the circle: (period) by field name
ANGLES = {"tauwdir": 2 * np.pi, "sep.thswell": 2 * np.pi,
          "sep.thwisea": 2 * np.pi, "mwd": 360.0, "mdww": 360.0,
          "mdts": 360.0, "dwi": 360.0, "p063": 360.0}
START_POINTS = 4096
# the quantile of the points' gaps that is compared: a decision taken on
# the other side of a rounding edge (TAUT_Z0_GC's closure, the kurtosis
# chain, the windsea mask) moves up to some tens of points by O(1), far
# fewer than the 0.1 % this leaves out, while the control and every fault
# move most points
Q = 0.999
# a point's gap that counts as far off, and the name of the count
FAR = 1e-3
POINTS = "points_over_1e-3"


def point_gaps(a, b, period: float | None = None) -> torch.Tensor:
    """Each point's gap of ``a`` from ``b`` (points on the last axis, the
    bins of a spectrum on the others): the norm of its difference over
    the field's RMS norm a point; on the circle for a direction of
    ``period``, over half a turn."""
    n = torch.as_tensor(b).shape[-1]
    a = torch.as_tensor(a).double().reshape(-1, n)
    b = torch.as_tensor(b).double().reshape(-1, n)
    if period is not None:
        d = torch.remainder(a - b + period / 2, period) - period / 2
        return d.norm(dim=0) / (0.5 * period * np.sqrt(a.shape[0]))
    d = (a - b).norm(dim=0)
    rms = float(b.pow(2).sum(dim=0).mean().sqrt())
    return d / rms if rms > 0 else torch.where(d > 0, np.inf, 0.0)


def gap(a, b, period: float | None = None, q: float = Q) -> float:
    """The ``q`` quantile of the points' gaps (:func:`point_gaps`); not
    finite anywhere → inf."""
    e = point_gaps(a, b, period)
    if not (bool(torch.isfinite(e).all())
            and bool(torch.isfinite(torch.as_tensor(b)).all())):
        return float("inf")
    return float(np.quantile(e.numpy(), q))


def l2_gap(a, b, period: float | None = None) -> float:
    """The relative L2 gap over all points (the record beside
    :func:`gap`)."""
    e = point_gaps(a, b, period)
    return float(e.pow(2).mean().sqrt())


def gaps(got: dict, want: dict) -> dict:
    """Each field's gap over the keys of ``want``."""
    return {k: gap(got[k], w, ANGLES.get(k)) for k, w in want.items()}


def record(got: dict, want: dict) -> dict:
    """Each field's (quantile gap, relative L2 gap, points whose gap
    exceeds :data:`FAR` or is not finite): what the log shows of a check,
    and what :data:`POINTS` counts."""
    out = {}
    for k, w in want.items():
        e = point_gaps(got[k], w, ANGLES.get(k))
        out[k] = (float(np.quantile(e.numpy(), Q)),
                  float(e.pow(2).mean().sqrt()),
                  int((~(e <= FAR)).sum()))
    return out


def start_points(n_real: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng([abs(int(seed)), 7])
    return np.sort(rng.choice(n_real, size=min(START_POINTS, n_real),
                              replace=False))


def held_winds(raw: dict, dtype):
    """The forcing's U10 (floored at WSPMIN) and direction as the model
    holds them (its dtype), in float64."""
    ws = np.maximum(np.asarray(raw["wswave"], np.float64), ref_mod.WSPMIN)
    return tuple(torch.as_tensor(v, dtype=dtype).double().numpy()
                 for v in (ws, np.asarray(raw["wdwave"], np.float64)))


def cold_start_gap(got, tb, wswave, wdwave, idx, dtype) -> float:
    """The subject's cold-start spectra at points ``idx`` against MSTART
    in float64 from the same winds as the model held them."""
    ws, wd = held_winds(dict(wswave=wswave, wdwave=wdwave), dtype)
    return gap(got, ref_mod.cold_start(tb, ws[idx], wd[idx]))


def real(fl1, n_real):
    return fl1[..., :n_real]


def follow(ref, subj: dict, *, forcing, k_phys: int, idelpro: float,
           fields, n_real: int) -> tuple[dict, dict]:
    """The reference ``ref`` follows the subject's stages.  Returns the
    numbers compared (each stage's worst field's :func:`gap`, and
    :data:`POINTS` over every field of every stage) and, for each stage,
    every field's :func:`record`."""
    pairs = {}
    h = forcing.period(subj["s0"]["date"].strftime("%Y%m%d%H%M%S"))
    ref.put_state(subj["s0"]["fl1"], subj["s0"]["stress"])
    ref.newwind(forcing.fields(h))
    ref.advance(k_phys)
    s1 = subj["s1"]
    pairs["step_spectrum"] = ({"fl1": real(s1["fl1"], n_real)},
                              {"fl1": real(ref.fl1().cpu(), n_real)})
    pairs["step_stress"] = (
        {k: v[:n_real] for k, v in s1["stress"].items()},
        {k: v[:n_real].cpu() for k, v in ref.stress().items()})
    if fields:
        s2 = subj["s2"]
        ref.put_state(s2["fl1"], s2["stress"],
                      phys_elapsed=(k_phys - 1) * idelpro)
        state = ref.advance(1, full_phys=True)
        pairs["out_spectrum"] = ({"fl1": real(subj["s3"]["fl1"], n_real)},
                                 {"fl1": real(ref.fl1().cpu(), n_real)})
        want = {}
        for k, v in state.items():
            if isinstance(v, dict):
                want.update({f"sep.{kk}": vv[:n_real].cpu()
                             for kk, vv in v.items()})
            else:
                want[k] = v[:n_real].cpu()
        pairs["out_state"] = ({k: v[:n_real] for k, v in
                               subj["state"].items()}, want)
        prods = ref.products(list(fields), state)
        pairs["out_fields"] = (
            {n: torch.as_tensor(subj["fields"][i])
             for i, n in enumerate(fields)},
            {n: prods[n].cpu() for n in fields})
    out = {k: max(gaps(got, want).values()) for k, (got, want)
           in pairs.items()}
    detail = {k: record(got, want) for k, (got, want) in pairs.items()}
    out[POINTS] = max(n for d in detail.values() for _, _, n in d.values())
    return out, detail
