"""The port's dense ``WaveModel`` under its forcing paths, and the
swell-train products, against the reference's, in float64.

``ecwam_tpu_torch.model.driver.WaveModel`` (on the CPU, where kernels A
and C run their plain versions):
  * NEWWIND's TAUW cap (tests/test_forcing_fidelity.py), a current change
    re-deriving the weights (against the reference's advection after its
    own refresh), and u* forcing, ICODE 1 and 2 (U10 from the log profile
    in the state's ``wswave``; fl1, stress and state against the
    reference at 1e-10);
  * the swell-train fields ``p042``-``p050`` of the catalog on a
    ``WaveModel``'s state against the reference's at 1e-10, and
    tests/test_products.py:135's bimodal case through the port's SEP3TR.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import test_trajectory_oracle as toracle
from ecwam_tpu.io import products as jproducts
from ecwam_tpu.model import driver as jdrv
from ecwam_tpu.model import setup as jsetup
from ecwam_tpu_torch.core.spectral import build_spectral_tables
from ecwam_tpu_torch.io import partition as tpartition
from ecwam_tpu_torch.io import products as tproducts
from ecwam_tpu_torch.model import driver as tdrv
from ecwam_tpu_torch.model import setup as tsetup
from ecwam_tpu_torch.model.cases import START, golden_forcing, provider
from test_torch_wavemodel import _assert_same, _close, _oracle_kw

TRAINS = sorted(tproducts.TRAIN_FIELDS)


def test_newwind_caps_tauw():
    ms = tsetup.build_model(grid_name="12.0", nang=12, nfre=25,
                            idelpro=900.0, idelt=900.0, pad_to=64,
                            weights_mode="cached", dtype=torch.float64,
                            device="cpu")
    n = ms.n_real
    calls = {"i": 0}

    def prov(date14):
        u = (14.0, 2.0)[min(calls["i"], 1)]      # strong → weak swap
        calls["i"] += 1
        return dict(wswave=np.full(n, u), wdwave=np.zeros(n),
                    aird=np.full(n, 1.225), wstar=np.zeros(n),
                    cicover=np.zeros(n))
    m = tdrv.WaveModel(ms, prov, START)
    m.advance(4)
    before = m.stress["tauw"][:n].numpy().copy()
    assert before.max() > 1e-3
    m.newwind(m.date)
    tlwmax = (8.0e-4 + 8.0e-5 * 2.0) * 2.0**3 / 4.0
    after = m.stress["tauw"][:n].numpy()
    assert (after <= tlwmax + 1e-12).all()
    np.testing.assert_allclose(after, np.minimum(before, tlwmax),
                               rtol=1e-12)


@pytest.mark.parametrize("mode", ["cached", "otf"])
def test_current_change_refreshes_weights(mode):
    kw, n = _oracle_kw("currents3")
    cur = {"u": kw.pop("currents")[0]}
    base = toracle._forcing(n)

    def prov(date14):
        return dict(base(0), ucur=cur["u"], vcur=np.zeros(n))
    ms_j = jsetup.build_model(dtype=jnp.float64, weights_mode=mode, **kw)
    ms_t = tsetup.build_model(dtype=torch.float64, weights_mode=mode,
                              device="cpu", **kw)
    m_j = jdrv.WaveModel(ms_j, prov, START)
    m_t = tdrv.WaveModel(ms_t, prov, START)
    f0 = m_t.step_adv(m_t.fl1)
    cur["u"] = np.full(n, 0.8)                 # a strong zonal current
    m_j.newwind(m_j.date)
    m_t.newwind(m_t.date)
    f1 = m_t.step_adv(m_t.fl1)
    assert float((f1 - f0).abs().max() / f0.abs().max()) > 1e-6, \
        "no refresh"
    _close(f1, m_j.step_adv(m_j.fl1), "advection after the refresh")


@pytest.mark.parametrize("icode", [1, 2])
def test_ustar_forcing_matches_reference(icode):
    kw = dict(grid_name="12.0", nang=12, nfre=25, idelpro=900.0,
              idelt=900.0, pad_to=64, icode_wnd=icode, weights_mode="cached")
    ms_j = jsetup.build_model(dtype=jnp.float64, **kw)
    ms_t = tsetup.build_model(dtype=torch.float64, device="cpu", **kw)
    n = ms_t.n_real
    rng = np.random.default_rng(icode)
    us = 0.3 + 0.3 * rng.random(n)

    def prov(date14):
        return dict(wswave=np.zeros(n), wdwave=rng.random(n) * 0.0 + 1.0,
                    aird=np.full(n, 1.225), wstar=np.zeros(n),
                    cicover=np.zeros(n), ufric=us)
    m_j = jdrv.WaveModel(ms_j, prov, START)
    m_t = tdrv.WaveModel(ms_t, prov, START)
    for m in (m_j, m_t):
        m.newwind(m.date)
    np.testing.assert_allclose(m_t.stress["ufric"][:n].numpy(), us)
    m_j.advance(2)
    m_t.advance(2)
    u10 = m_t.state["wswave"][:n].numpy()
    assert ((u10 > 6.0) & (u10 < 25.0)).all()
    _assert_same(m_t, m_j)
    swh = m_t.swh()
    assert np.isfinite(swh).all() and swh.max() < 20.0


def test_train_fields_match_reference():
    """The trains on the 12° aqua grid, 12×25, after 3 steps under the
    golden forcing swapped every step (its winds decay by 18 % a step, so
    the earlier windsea turns to swell: three trains at some points)."""
    kw = dict(grid_name="12.0", nang=12, nfre=25, idelpro=900.0,
              idelt=900.0, pad_to=64, weights_mode="cached")
    ms_j = jsetup.build_model(dtype=jnp.float64, **kw)
    ms_t = tsetup.build_model(dtype=torch.float64, device="cpu", **kw)
    prov = provider(golden_forcing(ms_t.n_real), 900.0)
    m_j = jdrv.WaveModel(ms_j, prov, START)
    m_t = tdrv.WaveModel(ms_t, prov, START)
    m_j.advance(3, wind_every=1)
    m_t.advance(3, wind_every=1)
    want = jproducts.compute(TRAINS, m_j.fl1, ms_j.tb,
                             {**m_j.state, **m_j.stress}, m_j.frc,
                             ms_j.phys.params, env=ms_j.env)
    got = tproducts.compute(TRAINS, m_t.fl1, ms_t.tb,
                            {**m_t.state, **m_t.stress}, m_t.frc,
                            ms_t.phys.params, env=ms_t.env)
    assert set(got) == set(TRAINS)
    for k in TRAINS:
        assert got[k].dtype == torch.float64 and got[k].shape == (
            ms_t.n_pad,)
        _close(got[k], want[k], k)
    assert float((got["p048"] > 0).sum()) > 0      # a third train
    with pytest.raises(NotImplementedError, match="chunked"):
        tproducts.compute_chunked(["p042"], None, ms_t.n_pad,
                                  ms_t.tb, m_t.state, m_t.frc,
                                  ms_t.phys.params, env=ms_t.env)


def test_swell_trains_bimodal_swell():
    """tests/test_products.py:135: two well-separated swell systems under
    weak wind come out as two trains with the right energy ratio and
    directions, through the port's sepwisw and SEP3TR."""
    tb = build_spectral_tables(nang=12, nfre=25)
    npts = 4
    fl1 = np.zeros((12, 25, npts))
    for dk in (-1, 0, 1):
        for dm in (-1, 0, 1):
            w = 1.0 if (dk == 0 and dm == 0) else 0.3
            fl1[2 + dk, 5 + dm, :] += 8.0 * w
            fl1[8 + dk, 10 + dm, :] += 4.0 * w
    cinv = torch.as_tensor(np.broadcast_to(
        (2 * np.pi * tb.fr / 9.81)[:, None], (25, npts)).copy())
    sep = tproducts.sepwisw(torch.as_tensor(fl1), torch.zeros(fl1.shape,
                            dtype=torch.float64), cinv,
                            torch.full((npts,), 1e-3, dtype=torch.float64),
                            torch.full((npts,), 2.0, dtype=torch.float64),
                            torch.zeros(npts, dtype=torch.float64), tb)
    tr = tpartition.sep3tr(fl1, np.full(npts, 24, np.int32),
                           {k: v.numpy() for k, v in sep.items()},
                           np.full(npts, 2.0), np.zeros(npts), tb)
    em = tr["emtrain"]
    assert (em[:, 0] > 0).all() and (em[:, 1] > 0).all()
    np.testing.assert_allclose(em[:, 0] / em[:, 1], 2.0 / 1.1**5, rtol=0.05)
    th = np.degrees(tr["thtrain"])
    for i, k in ((0, 2), (1, 8)):
        d = (th[:, i] - np.degrees(tb.th[k]) + 180) % 360 - 180
        assert (np.abs(d) < 30).all()
