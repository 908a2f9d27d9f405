"""The port's coupling surface (``ecwam_tpu_torch.coupling``) against the
reference's (``ecwam_tpu/coupling.py``), side by side in float64 on the
CPU: tests/test_coupling.py's two cases (18°, 12×25, irefra 2) through
both packages' ``CoupledWaveModel``, in the reference's default weight
mode (``cached``) and the port's (``fused``, the same in both packages):

  * every array of the ``Wave2Atmosphere`` and ``Wave2Ocean`` blocks
    within 1e-10 of the reference's (relative to the field's largest
    magnitude), and the reference test's own sanity checks on the port's;
  * the ocean push: ice DEFVALs at the covered points, and the currents
    reaching the propagation (the model's ``currents``, GETCURR, equal to
    the reference's).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecwam_tpu import coupling as jc
from ecwam_tpu.model import setup as jsetup
from ecwam_tpu_torch import coupling as tc
from ecwam_tpu_torch.model import setup as tsetup

TOL = 1e-10
KW = dict(grid_name="18.0", nang=12, nfre=25, idelpro=900.0, idelt=900.0,
          pad_to=64, irefra=2)


@pytest.fixture(scope="module", params=["cached", "fused"])
def pair(request):
    mode = request.param
    return (jsetup.build_model(dtype=jnp.float64, weights_mode=mode, **KW),
            tsetup.build_model(dtype=torch.float64, weights_mode=mode,
                               device="cpu", **KW))


def _same_block(got, want):
    assert type(got).__name__ == type(want).__name__
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if w is None:
            assert g is None, f.name
            continue
        assert isinstance(g, np.ndarray) and g.dtype == np.float64
        w = np.asarray(w, np.float64)
        np.testing.assert_allclose(g, w, rtol=TOL,
                                   atol=TOL * max(np.abs(w).max(), 1e-300),
                                   err_msg=f.name)


def _both(pair, fn):
    """``fn(coupling module, setup)`` through each package."""
    (ms_j, ms_t) = pair
    return fn(jc, ms_j), fn(tc, ms_t)


def _roundtrip(mod, ms):
    n = ms.n_real
    cm = mod.CoupledWaveModel(ms, "20230101000000")
    cm.push_atmosphere("20230101000000",
                       wswave=np.full(n, 14.0), wdwave=np.full(n, 0.5))
    cm.advance_coupling_period(4)
    return cm, cm.wave_to_atmosphere(), cm.wave_to_ocean()


def test_coupled_roundtrip(pair):
    (cm_j, a_j, o_j), (cm_t, a_t, o_t) = _both(pair, _roundtrip)
    assert type(cm_t.model).__name__ == "WaveModel"
    _same_block(a_t, a_j)
    _same_block(o_t, o_j)
    ms = pair[1]
    # tests/test_coupling.py's sanity checks, on the port's blocks
    assert np.all((a_t.charnock > 0.003) & (a_t.charnock < 0.3))
    assert np.all(a_t.ustokes > 0.0) and np.all(a_t.vstokes > 0.0)
    st = np.hypot(a_t.ustokes, a_t.vstokes)
    assert np.all((st > 0.005) & (st < 1.0))
    assert np.all(a_t.phiocd < 0.0)
    assert np.all(a_t.wsemean > 0.0)
    assert np.all((a_t.wsfmean > ms.tb.fr[0])
                  & (a_t.wsfmean <= ms.tb.fr[-1]))
    assert np.allclose(np.arctan2(a_t.tauocx, a_t.tauocy), 0.5, atol=0.3)
    assert np.all((o_t.nswh > 0.3) & (o_t.nswh < 15.0))
    assert np.all(o_t.nmwp > 1.0)
    assert np.all((o_t.ntauoc > 0.5) & (o_t.ntauoc <= 1.0))
    assert np.all(o_t.nphieps <= 0.0)


def _ocean(mod, ms):
    n = ms.n_real
    cm = mod.CoupledWaveModel(ms, "20230101000000")
    cm.push_atmosphere("20230101000000",
                       wswave=np.full(n, 12.0), wdwave=np.zeros(n))
    cm.advance_coupling_period(2)
    ice = np.zeros(n)
    ice[: n // 2] = 0.95
    cm.push_ocean(mod.Ocean2Wave(cicover=ice, cithick=np.full(n, 1.0),
                                 ucur=np.full(n, 0.4), vcur=np.zeros(n)))
    cur = (cm.model._currents if mod is jc else cm.model.currents)
    cm.advance_coupling_period(2)
    return cm, cur, cm.wave_to_atmosphere(), cm.wave_to_ocean()


def test_ocean_push_ice_defaults_and_current_refresh(pair):
    (cm_j, cur_j, a_j, o_j), (cm_t, cur_t, a_t, o_t) = _both(pair, _ocean)
    # currents reached the propagation (GETCURR → LUPDTWGHT)
    assert cur_t is not None
    for g, w in zip(cur_t, cur_j):
        np.testing.assert_array_equal(g, np.asarray(w))
    _same_block(a_t, a_j)
    _same_block(o_t, o_j)
    n, tb = pair[1].n_real, pair[1].tb
    np.testing.assert_allclose(a_t.charnock[: n // 2], tc.PRCHAR)
    np.testing.assert_allclose(a_t.ustokes[: n // 2], 0.0)
    np.testing.assert_allclose(a_t.wsfmean[: n // 2], tb.fr[-1])
    assert np.all(a_t.ustokes[n // 2:] != 0.0)
