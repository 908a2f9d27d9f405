"""The port's cached sharded model against the reference's and its own
single-device step, in float64 on the CPU.

``ecwam_tpu_torch.parallel.sharded.CachedShardedModel`` (weights_mode
'cached') on 8 in-process CPU shards, in the 1-D row bands and the 2×4
patches, against:
  * the port's dense single-device step (``model.stepper.make_step``), the
    NPROC invariance the reference tests with its MPI 1/4-rank matrix;
  * ``ecwam_tpu.parallel.sharded.build_sharded_model`` on the reference's
    8 virtual CPU devices (tests/conftest.py), the same decomposition;
both to 1e-10 of the spectrum's maximum, after the cases of
tests/test_sharded.py and test_sharded2d.py: one step, 10 steps, depth
and current refraction (irefra 3, 3 steps) and fast-wave sub-steps (3
steps), on the 6° aqua grid (12×25).  The cached weights are built once
and reused by the step (LUPDTWGHT).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from ecwam_tpu.model import setup as jsetup
from ecwam_tpu.parallel import sharded as jsharded
from ecwam_tpu_torch.model import preset
from ecwam_tpu_torch.model import setup as tsetup
from ecwam_tpu_torch.model import stepper as tstepper
from ecwam_tpu_torch.parallel import multihost, sharded

TOL = 1e-10
NSHARDS = 8
LAYOUTS = {"bands": None, "patches": (2, 4)}


def _kw(config):
    kw = dict(grid_name="6.0", nang=12, nfre=25, idelpro=900.0,
              idelt=900.0, pad_to=64, weights_mode="cached")
    if config == "refraction":
        n = tsetup.build_model(**kw, device="cpu").n_real
        rng = np.random.default_rng(7)
        kw.update(irefra=3, currents=(0.4 * rng.standard_normal(n),
                                      0.4 * rng.standard_normal(n)))
    elif config == "fastwaves":
        kw.update(delpro_lf=450.0, ifrelfmax=5)
    return kw


@functools.lru_cache(maxsize=None)
def _setups(config):
    kw = _kw(config)
    return (tsetup.build_model(**kw, dtype=torch.float64, device="cpu"),
            jsetup.build_model(**kw, dtype=jnp.float64))


def _inputs(ms, seed=42):
    n = ms.n_pad
    rng = np.random.default_rng(seed)
    ws = 8.0 + 4.0 * rng.random(n)
    wd = rng.random(n) * 2 * np.pi
    frc = dict(wswave=ws, wdwave=wd, aird=np.full(n, 1.225),
               wstar=np.zeros(n), cicover=np.zeros(n))
    fl1 = np.asarray(preset.mstart(ms.tb, ws, wd), np.float64)
    stress = {k: v.numpy() for k, v in
              tstepper.initial_stress(ms, frc).items()}
    return fl1, frc, stress


def _single(ms, fl1, frc, stress, nsteps):
    sb = tstepper.make_step(ms)
    f = torch.as_tensor(fl1)
    frc_t = {k: torch.as_tensor(v) for k, v in frc.items()}
    st = {k: torch.as_tensor(v) for k, v in stress.items()}
    for _ in range(nsteps):
        f, state = sb.step_full(f, frc_t, st)
        st = {k: state[k] for k in st}
    return f.numpy()


def _port(ms, layout2d, fl1, frc, stress, nsteps):
    sm = sharded.build_sharded_model(
        ms, multihost.make_point_mesh(["cpu"] * NSHARDS), layout2d)
    f = sm.device_put(fl1)
    frc_s = {k: sm.device_put(v) for k, v in frc.items()}
    st = {k: sm.device_put(v) for k, v in stress.items()}
    for _ in range(nsteps):
        f, state = sm.step_full(f, frc_s, st)
        st = {k: state[k] for k in st}
    return sm.from_layout(f), sm


def _reference(jms, layout2d, fl1, frc, stress, nsteps):
    mesh = Mesh(np.array(jax.devices()[:NSHARDS]), ("pts",))
    sm = jsharded.build_sharded_model(jms, mesh, layout2d=layout2d)
    f = sm.device_put(fl1)
    frc_s = {k: sm.device_put(v) for k, v in frc.items()}
    st = {k: sm.device_put(v) for k, v in stress.items()}
    for _ in range(nsteps):
        f, state = sm.step_full(f, frc_s, st)
        st = {k: state[k] for k in st}
    return sm.from_layout(np.asarray(f))


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=TOL,
                               atol=TOL * np.abs(want).max(), err_msg=what)


CASES = [(lay, cfg, n) for lay in LAYOUTS
         for cfg, n in (("plain", 1), ("plain", 10), ("refraction", 3),
                        ("fastwaves", 3))]


@pytest.mark.parametrize("layout,config,nsteps", CASES)
def test_sharded_cached_matches_single_device_and_reference(layout, config,
                                                            nsteps):
    ms, jms = _setups(config)
    fl1, frc, stress = _inputs(ms)
    got, sm = _port(ms, LAYOUTS[layout], fl1, frc, stress, nsteps)
    assert isinstance(sm, sharded.CachedShardedModel)
    assert sm.halo_bytes > 0
    _close(got, _single(ms, fl1, frc, stress, nsteps), "single device")
    _close(got, _reference(jms, LAYOUTS[layout], fl1, frc, stress, nsteps),
           "reference")
    assert np.isfinite(got).all() and got.min() >= 0.0


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_weights_cached_not_recomputed(layout):
    """The step reuses the cached weights (LUPDTWGHT, propag_wam.F90:
    221-236); a refresh builds a new set with the same values."""
    ms, _ = _setups("plain")
    sm = sharded.build_sharded_model(
        ms, multihost.make_point_mesh(["cpu"] * NSHARDS), LAYOUTS[layout])
    w1 = sm.weights
    assert sm.weights is w1
    fl1, frc, stress = _inputs(ms)
    sm.step_full(sm.device_put(fl1),
                 {k: sm.device_put(v) for k, v in frc.items()},
                 {k: sm.device_put(v) for k, v in stress.items()})
    assert sm.weights is w1
    w2 = sm.refresh_weights()
    assert w2 is not w1
    for a, b in zip(w1, w2):
        for wa, wb in zip(a, b):
            assert torch.equal(wa["w"], wb["w"])
            assert torch.equal(wa["cflfail"], wb["cflfail"])


def test_fused_layout2d_refused():
    ms = tsetup.build_model(grid_name="12.0", nang=12, nfre=25, pad_to=64,
                            device="cpu")
    with pytest.raises(NotImplementedError, match="row-band"):
        sharded.build_sharded_model(
            ms, multihost.make_point_mesh(["cpu"] * 4), layout2d=(2, 2))
