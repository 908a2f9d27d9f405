"""The port's WAMASSI surface and OI analysis
(``ecwam_tpu_torch.model.assimilation``) against the reference's
(``ecwam_tpu/model/assimilation.py``), on the CPU in float64:

  * the registry's abort-if-unset semantics;
  * ``oi_swh_analysis`` against the reference at rtol 1e-12 with more
    observations than ``max_obs``, a tie at the cut included (two
    observations at the same distance, both kept, as ``np.partition``'s
    ``<=`` keeps them), and the same in chunks of a few points;
  * tests/test_assimilation.py's analysis checks on the port;
  * ``update_spectra_from_swh`` on numpy and on tensors;
  * ``default_wamassi`` (through ``wamassi``) on the 12° grid through the
    port's ``WaveModel`` and ``FastWaveModel`` (its SRL rows and tail
    scaled in place) against the reference's ``WaveModel``: the analysis
    at 1e-12, the spectra at 1e-12 of their largest value.
"""

import datetime as dt

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecwam_tpu.io import forcing as j_forcing
from ecwam_tpu.io import products as j_products
from ecwam_tpu.model import assimilation as ja
from ecwam_tpu.model import driver as j_driver
from ecwam_tpu.model import setup as j_setup
from ecwam_tpu_torch.model import assimilation as ta
from ecwam_tpu_torch.model import driver as t_driver
from ecwam_tpu_torch.model import setup as t_setup

RTOL = 1e-12


def test_registry_abort_semantics():
    old = ta._HANDLER
    try:
        ta.register_wamassi(None)
        with pytest.raises(RuntimeError, match="WAMASSI"):
            ta.wamassi()
    finally:
        ta.register_wamassi(old)
    assert ta._HANDLER is ta.default_wamassi


def _points_and_obs(seed=0):
    """A 3° band of points and 40 observations: 36 at random, four on
    one latitude at ±1° and ±2° of the point (0.75°, 36°), so that its
    third-nearest distance is a tie."""
    rng = np.random.default_rng(seed)
    lat, lon = np.meshgrid(np.arange(-30.0, 31.0, 3.0) + 0.75,
                           np.arange(0.0, 360.0, 3.0), indexing="ij")
    lat, lon = lat.ravel(), lon.ravel()
    hs = 1.0 + 2.0 * rng.random(lat.size)
    olat = np.concatenate([rng.uniform(-30, 30, 36), np.full(4, 0.75)])
    olon = np.concatenate([rng.uniform(0, 360, 36),
                           [37.0, 35.0, 38.0, 34.0]])
    ohs = 1.0 + 2.0 * rng.random(40)
    return hs, lat, lon, olat, olon, ohs


@pytest.mark.parametrize("chunk", [ta.CHUNK, 7])
def test_oi_matches_reference(chunk):
    hs, lat, lon, olat, olon, ohs = _points_and_obs()
    kw = dict(max_obs=3)
    got = ta.oi_swh_analysis(hs, lat, lon, olat, olon, ohs, chunk=chunk,
                             device="cpu", **kw)
    assert got.dtype == torch.float64 and got.device.type == "cpu"
    want = ja.oi_swh_analysis(hs, lat, lon, olat, olon, ohs, **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)
    # the tie: the point (0.75°, 36°) keeps all four of its near obs
    p = int(np.argmin((lat - 0.75) ** 2 + (lon - 36.0) ** 2))
    d = ta.great_circle_dist(torch.tensor(lat[p]), torch.tensor(lon[p]),
                             torch.tensor(olat[-4:]), torch.tensor(olon[-4:]))
    assert d[0] == d[1] and d[2] == d[3] and d[2] > d[0]
    cut = torch.kthvalue(ta.great_circle_dist(
        torch.tensor(lat[p]), torch.tensor(lon[p]), torch.tensor(olat),
        torch.tensor(olon)), 3).values
    assert cut == d[2]
    # and the weights alone, from a tensor first guess
    w, innov = ta.oi_weights(torch.tensor(hs), lat, lon, olat, olon, ohs)
    assert w.shape == innov.shape == (40,)


def test_oi_pulls_toward_obs_locally():
    n = 181
    hs_an = ta.oi_swh_analysis(np.full(n, 2.0), np.zeros(n),
                               np.arange(n, dtype=float),
                               obs_lat=np.array([0.0]),
                               obs_lon=np.array([90.0]),
                               obs_hs=np.array([3.0]), device="cpu").numpy()
    i0 = 90
    assert hs_an[i0] > 2.6
    assert abs(hs_an[0] - 2.0) < 1e-6 and abs(hs_an[-1] - 2.0) < 1e-6
    assert hs_an[i0] > hs_an[i0 + 5] > hs_an[i0 + 15] >= 2.0 - 1e-12
    hs_an = ta.oi_swh_analysis(
        np.full(5, 1.0), np.zeros(5), np.arange(5.0) * 20.0,
        obs_lat=np.array([0.0]), obs_lon=np.array([40.0]),
        obs_hs=np.array([2.0]), obs_err=1e-6, device="cpu")
    assert abs(float(hs_an[2]) - 2.0) < 1e-3
    none = ta.oi_swh_analysis(np.full(5, 1.0), np.zeros(5), np.zeros(5),
                              [], [], [], device="cpu")
    assert torch.equal(none, torch.ones(5, dtype=torch.float64))


def test_spectra_update_scales_energy():
    rng = np.random.default_rng(0)
    fl1 = rng.random((12, 25, 10))
    hs_fg = np.full(10, 2.0)
    hs_fg[3] = 1e-4                                 # under the floor
    hs_an = np.full(10, 3.0)
    want = ja.update_spectra_from_swh(fl1, hs_fg, hs_an)
    got = ta.update_spectra_from_swh(fl1, hs_fg, hs_an)
    assert isinstance(got, np.ndarray)
    np.testing.assert_array_equal(got, want)
    t = ta.update_spectra_from_swh(torch.tensor(fl1, dtype=torch.float32),
                                   torch.tensor(hs_fg), torch.tensor(hs_an))
    assert t.dtype == torch.float32
    np.testing.assert_allclose(t.numpy(), want, rtol=1e-6)


def _models(kind):
    """The reference's float64 ``WaveModel`` of tests/test_assimilation.py
    and the port's ``kind`` model on the same setup and forcing."""
    kw = dict(grid_name="12.0", nang=12, nfre=25, idelpro=900.0,
              idelt=900.0)
    ms_j = j_setup.build_model(dtype=jnp.float64, **kw)
    ms_t = t_setup.build_model(
        dtype=torch.float64, device="cpu",
        weights_mode="fused" if kind == "fast" else "cached", **kw)
    ff = j_forcing.synthetic_forcing_file([20220101000000])
    lat = np.asarray(ms_j.grid.lats)[ms_j.blk.kxlt]
    lon = ms_j.grid.amowep + ms_j.blk.ixlg * \
        np.asarray(ms_j.grid.zdello)[ms_j.blk.kxlt]
    prov = ff.provider(lat, lon)
    start = dt.datetime(2022, 1, 1)
    cls = t_driver.FastWaveModel if kind == "fast" else t_driver.WaveModel
    return (j_driver.WaveModel(ms_j, prov, start), cls(ms_t, prov, start),
            lat, lon)


@pytest.mark.parametrize("kind", ["dense", "fast"])
def test_default_wamassi_matches_reference(kind):
    m_j, m_t, lat, lon = _models(kind)
    n = m_j.setup.n_real
    hs0 = np.asarray(j_products.swh(m_j.fl1, m_j.setup.tb))[:n]
    np.testing.assert_allclose(ta.first_guess_swh(m_t)[:n].numpy(), hs0,
                               rtol=RTOL)
    j = int(np.argmax(hs0))
    rng = np.random.default_rng(1)
    pick = np.concatenate([[j], rng.choice(n, 29, replace=False)])
    obs = dict(lat=lat[pick], lon=lon[pick],
               swh=hs0[pick] * rng.uniform(0.8, 1.5, pick.size))
    obs["swh"][0] = hs0[j] * 1.5
    want = ja.wamassi(m_j, obs)
    f_srl = m_t._f_srl if kind == "fast" else None
    got = ta.wamassi(m_t, obs)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)
    assert float(got[j]) > hs0[j] * 1.05        # pulled up
    fl_j = np.asarray(m_j.fl1)
    np.testing.assert_allclose(m_t.fl1.numpy(), fl_j, rtol=0,
                               atol=RTOL * np.abs(fl_j).max())
    if kind == "fast":                  # scaled in place, pads finite
        assert m_t._f_srl is f_srl
        assert bool(torch.isfinite(m_t._f_srl).all())
        wp = m_t.fp.tabs["wrap_pos"]
        wf = m_t.fp.tabs["wrap_from"]
        assert torch.equal(m_t._f_srl[wp], m_t._f_srl[wf])
    hs1 = ta.first_guess_swh(m_t)[:n].numpy()
    np.testing.assert_allclose(hs1, got.numpy(), rtol=2e-2)
