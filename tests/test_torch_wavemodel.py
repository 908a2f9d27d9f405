"""The port's dense ``WaveModel`` against the reference's, in float64.

``ecwam_tpu_torch.model.driver.WaveModel`` (on the CPU, where kernels A
and C run their plain versions):
  * against the straight-line f64 WAMINTGR oracle in the three
    configurations of tests/test_trajectory_oracle.py:65 (5 steps, a
    forcing swap every 2), at that test's RTOL 1e-9;
  * against ``ecwam_tpu``'s ``WaveModel`` in each weight mode (cached,
    otf, fused), 4 steps on the trajectory oracle's fast-wave
    configuration: fl1, the stress and the physics state at 1e-10.
  * ``chip_smoke.py``'s WaveModel phase rehearsed at a small size.
The forcing paths and the swell trains are in
tests/test_torch_wavemodel_forcing.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import test_trajectory_oracle as toracle
from ecwam_tpu.model import driver as jdrv
from ecwam_tpu.model import setup as jsetup
from ecwam_tpu_torch.model import driver as tdrv
from ecwam_tpu_torch.model import setup as tsetup
from ecwam_tpu_torch.model.cases import START, provider

TOL = 1e-10


def _np(v):
    return v.numpy() if hasattr(v, "numpy") else np.asarray(v)


def _close(got, want, what, tol=TOL):
    got = np.asarray(_np(got), np.float64)
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(np.abs(want).max(), 1e-300),
                               err_msg=what)


def _oracle_kw(config):
    """tests/test_trajectory_oracle.py's build keywords of ``config``."""
    wg, b, obstr, blk = toracle._grid_with_topo()
    kw = dict(grid=wg, bathy=b, nang=toracle.NANG, nfre=toracle.NFRE,
              pad_to=8, obstructions=obstr, iphys=1)
    if config == "fastwaves_refra1":
        kw.update(idelpro=900.0, idelt=1800.0, delpro_lf=450.0,
                  ifrelfmax=3, irefra=1)
    else:
        rng = np.random.default_rng(3)
        kw.update(idelpro=900.0, idelt=900.0, irefra=3,
                  currents=(0.35 * rng.standard_normal(blk.nsea),
                            0.35 * rng.standard_normal(blk.nsea)))
        if config == "fastwaves_currents3":
            kw.update(idelt=1800.0, delpro_lf=450.0, ifrelfmax=3)
    return kw, blk.nsea


@pytest.mark.parametrize(
    "config", ["fastwaves_refra1", "currents3", "fastwaves_currents3"])
def test_wavemodel_matches_wamintgr_oracle(config):
    kw, n = _oracle_kw(config)
    forcing_at = toracle._forcing(n)
    ms_t = tsetup.build_model(dtype=torch.float64, weights_mode="cached",
                              device="cpu", **kw)
    m = tdrv.WaveModel(ms_t, provider(forcing_at, 900.0), START)
    stress0 = {k: v.numpy() for k, v in m.stress.items()}
    fl1_0 = m.fl1.numpy().copy()
    m.advance(toracle.NSTEPS, wind_every=2)
    ms_j = jsetup.build_model(dtype=jnp.float64, **kw)
    want, want_stress = toracle._oracle_traj(ms_j, fl1_0, stress0,
                                             forcing_at)
    rt = toracle.RTOL
    _close(m.fl1[..., :n], want[..., :n], "fl1", rt)
    for k in ("ufric", "tauw", "z0m", "chrnck"):
        _close(m.stress[k][:n], want_stress[k][:n], k, rt)


def _pair(mode, **over):
    """The reference's and the port's float64 ``WaveModel`` on the
    trajectory oracle's fast-wave configuration under its forcing."""
    kw, n = _oracle_kw("fastwaves_refra1")
    kw.update(over)
    prov = provider(toracle._forcing(n), 900.0)
    ms_j = jsetup.build_model(dtype=jnp.float64, weights_mode=mode,
                              otf_block=2, **kw)
    ms_t = tsetup.build_model(dtype=torch.float64, weights_mode=mode,
                              otf_block=2, device="cpu", **kw)
    return (jdrv.WaveModel(ms_j, prov, START),
            tdrv.WaveModel(ms_t, prov, START))


def _assert_same(m_t, m_j, state=True):
    _close(m_t.fl1, m_j.fl1, "fl1")
    for k, v in m_j.stress.items():
        _close(m_t.stress[k], v, k)
    if state:
        common = set(m_j.state) & set(m_t.state)
        assert set(m_j.state) - {"akmean", "xkmean"} <= common
        for k in sorted(common):
            _close(m_t.state[k], m_j.state[k], k)


@pytest.mark.parametrize("mode", ["cached", "otf", "fused"])
def test_wavemodel_matches_reference(mode):
    m_j, m_t = _pair(mode)
    _close(m_t.fl1, m_j.fl1, "cold start")
    assert m_t.fl1.is_contiguous()             # kernel C's compact layout
    m_j.advance(4, wind_every=2)
    m_t.advance(4, wind_every=2)
    _assert_same(m_t, m_j)
    assert m_t.fl1.is_contiguous()
    assert m_t.timers.steps == 4 and m_t.timers.phys > 0.0
    assert m_t.state["xllws"].shape == m_t.fl1.shape
    norms = m_t.norms()
    assert norms["count"] == m_t.setup.n_real and norms["minimum"] > 0.0


def test_smoke_wavemodel_phase_on_cpu():
    """``chip_smoke.py``'s WaveModel phase (9), rehearsed on the CPU at a
    small size (the card's limits; no kernel launches to count here): the
    golden grid's configurations in each weight mode, u* forcing, O24 in
    place of O320, kernel C's checks on a slice and the cached CLI run
    with the swell trains."""
    import torch
    import chip_smoke
    out = chip_smoke.wavemodel_phase(
        torch.device("cpu"), o320=dict(grid_name="O24", pad_to=64),
        launches=False, rows=1024)
    assert set(out["o320"]) == {"cached", "otf", "fused"}
    assert out["o320"]["cached"]["weights_gb"] > 0.0
    for key in ("slice", "slice_ustar"):
        r = out[key]
        assert r["n"] == 1024 and r["spec_rel"] == 0.0 and r["ops"] > 0
    assert "wswave" in out["slice_ustar"]["rows"]
    assert out["cli_stats"] == 0.0 and out["cli_trains"] == 0.0
