"""Current refraction (irefra 2/3) in the port against ``ecwam_tpu``.

On ``cases.currents_kw`` (tests/test_fused_pallas.py's 6° grid, 12×25,
random ±0.2 m/s currents from seed 7), the same JONSWAP spectrum (numpy,
seed 0) goes through ``ecwam_tpu``'s ``FusedPropagation(backend="xla")``
and the port's ``FusedPropagation.advect`` (plain versions on the CPU):
  * irefra 2 (float32) and 3 (float64), one advection step: the
    all-band pass and the fast-wave sub-band pass with σ̇ (ifrelfmax 5:
    the sub-band pass computes ifrelfmax+1 frequencies and writes
    ifrelfmax): rtol 5e-6 in float32 (the reference's own Pallas-vs-XLA
    bound for currents, tests/test_fused_pallas.py:64-70) and 1e-12 in
    float64;
  * the CFL current retry on ``currents_kw(cfl=True)``, where it masks
    points: the masked gradient rows equal the reference's exactly in
    float64 (so the masks are equal), as does CHECKCFL's violation count;
    its three Courant maxima agree to 1e-12 (XLA may fuse the outflow
    sum's products, the last bit of a maximum can differ).
The port's ``FastWaveModel`` (plain, float64) on the trajectory oracle's
``currents3`` configuration (tests/test_trajectory_oracle.py:65-110) is
held against the f64 WAMINTGR oracle at rtol 1e-9 of each field's
maximum, the oracle test's own bound: both run the same algebra in
float64, so only summation order separates them.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import test_trajectory_oracle as toracle
from ecwam_tpu.model import preset
from ecwam_tpu.model import setup as jsetup
from ecwam_tpu.model.fusedstep import FusedPropagation as JFused
from ecwam_tpu_torch.model import cases
from ecwam_tpu_torch.model import driver as tdrv
from ecwam_tpu_torch.model import setup as tsetup
from ecwam_tpu_torch.model.fusedstep import FusedPropagation

BOUNDS = {"f32": dict(rtol=5e-6, atol=1e-8),
          "f64": dict(rtol=1e-12, atol=0.0)}
DTYPES = {"f32": (jnp.float32, torch.float32),
          "f64": (jnp.float64, torch.float64)}


def _both(kw, prec):
    jdt, tdt = DTYPES[prec]
    ms_j = jsetup.build_model(dtype=jdt, weights_mode="fused", **kw)
    ms_t = tsetup.build_model(dtype=tdt, device="cpu", **kw)
    return ms_j, ms_t, JFused(ms_j, backend="xla"), FusedPropagation(ms_t)


@pytest.mark.parametrize("irefra,prec", [(2, "f32"), (3, "f64")])
def test_advect_with_currents_matches_reference(irefra, prec):
    ms_j, ms_t, fx, fp = _both(cases.currents_kw(irefra, fast=True), prec)
    assert (fp.mlf, fp.mlf_w, fp.nsub) == (5, 6, 2)
    rng = np.random.default_rng(0)
    f = preset.mstart(ms_j.tb, 6.0 + 6.0 * rng.random(ms_j.n_pad),
                      2.0 * np.pi * rng.random(ms_j.n_pad))
    jdt, tdt = DTYPES[prec]
    want = np.asarray(fx.advect(jnp.asarray(f, jdt), fx.bundle))
    got = fp.advect(torch.as_tensor(f, dtype=tdt)).numpy()
    n = ms_j.n_real
    np.testing.assert_allclose(got[..., :n], want[..., :n], **BOUNDS[prec])


def test_cfl_retry_and_diagnostics_match_reference():
    ms_j, ms_t, fx, fp = _both(cases.currents_kw(3, cfl=True), "f64")
    assert int(fp.cfl_bad.sum()) > 0
    np.testing.assert_array_equal(fp.tabs["grads"].numpy(),
                                  np.asarray(fx.bundle["dev"]["grads"]))
    got, want = fp.cfl_diagnostics(), fx.cfl_diagnostics()
    assert got["n_violations"] == want["n_violations"]
    for k in ("cfl_east_west", "cfl_north_south", "max_outflow"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, err_msg=k)


def test_currents_from_the_forcing_refresh_the_tables():
    kw = cases.currents_kw(3, cfl=True)
    u, v = kw.pop("currents")
    ms = tsetup.build_model(dtype=torch.float64, device="cpu", **kw)
    forcing = dict(tdrv.constant_wind_forcing(ms.n_real)("x"), ucur=u,
                   vcur=v)
    m = tdrv.FastWaveModel(ms, lambda date14: forcing, cases.START)
    ref = FusedPropagation(tsetup.build_model(
        dtype=torch.float64, device="cpu", currents=(u, v), **kw))
    assert int(m.fp.cfl_bad.sum()) == int(ref.cfl_bad.sum()) > 0
    for k in ("uv", "grads"):
        torch.testing.assert_close(m.fp.tabs[k], ref.tabs[k], rtol=0,
                                   atol=0)


def test_currents3_fast_path_matches_wamintgr_oracle():
    wg, b, obstr, blk = toracle._grid_with_topo()
    n = blk.nsea
    forcing_at = toracle._forcing(n)
    rng = np.random.default_rng(3)
    kw = dict(grid=wg, bathy=b, nang=toracle.NANG, nfre=toracle.NFRE,
              pad_to=8, obstructions=obstr, iphys=1, idelpro=900.0,
              idelt=900.0, irefra=3,
              currents=(0.35 * rng.standard_normal(n),
                        0.35 * rng.standard_normal(n)))
    ms_t = tsetup.build_model(dtype=torch.float64, device="cpu", **kw)
    m = tdrv.FastWaveModel(ms_t, cases.provider(forcing_at, 900.0),
                           cases.START, plain=True)
    stress0 = {k: v.numpy() for k, v in m.stress.items()}
    fl1_0 = m.fl1.numpy()
    m.advance(toracle.NSTEPS, wind_every=2)
    ms_j = jsetup.build_model(dtype=jnp.float64, weights_mode="fused", **kw)
    want, want_stress = toracle._oracle_traj(ms_j, fl1_0, stress0,
                                             forcing_at)
    rtol = toracle.RTOL
    got = m.fl1.numpy()[..., :n]
    np.testing.assert_allclose(got, want[..., :n], rtol=rtol,
                               atol=rtol * want[..., :n].max())
    for k in ("ufric", "tauw", "z0m", "chrnck"):
        w = np.asarray(want_stress[k])[:n]
        np.testing.assert_allclose(m.stress[k].numpy()[:n], w, rtol=rtol,
                                   atol=rtol * np.abs(w).max(), err_msg=k)
