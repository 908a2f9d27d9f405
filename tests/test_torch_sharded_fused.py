"""The port's fused sharded model on the CPU, in float64.

``ecwam_tpu_torch.parallel.sharded.FusedShardedModel`` (weights_mode
'fused', row bands) on in-process CPU shards, where kernels A, B and C run
their plain versions:
  * ``step_full`` (the compact surface) is NPROC-invariant: 2 and 8 shards
    reproduce the port's single-device fused step
    (``model.stepper.make_step``) to 1e-11 in the plain, fast-wave and
    current-refraction (irefra 3) configurations of
    tests/test_sharded_fused.py:55, two steps;
  * the device norms (all_reduce-style sums over the shards) equal the
    host's gathered norms;
  * the kernel-architecture surface (``put_rows``, ``step_rows``,
    ``step_rows_full``, ``rows_to_compact``, ``stress6_to_dict``) at 2 and
    4 shards and nfre_red 25 and 20 reproduces ``FastWaveModel`` from the
    same state bit for bit (each own row sees the same taps and physics),
    two fast steps and an output date; the output date's state holds
    what io/products reads;
  * the same surface against the reference's ``step_rows`` (its own
    rows + Pallas kernels in interpret mode, 2 virtual devices), two
    steps, to 1e-10 (TAUWDIR to the reference kernel's atan2
    approximation, 1e-7).
The 6° aqua grid (12×25), forcing and cold start from seed 0.
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
from ecwam_tpu_torch.model import driver, preset
from ecwam_tpu_torch.model import setup as tsetup
from ecwam_tpu_torch.model import stepper as tstepper
from ecwam_tpu_torch.ops.physics import implsch_cuda as ipk
from ecwam_tpu_torch.parallel import multihost, sharded

START = "20230101000000"


def _kw(config="plain", **extra):
    kw = dict(grid_name="6.0", nang=12, nfre=25, idelpro=900.0,
              idelt=900.0, pad_to=64, weights_mode="fused")
    if config == "fastwaves":
        kw.update(delpro_lf=450.0, ifrelfmax=4)
    elif config == "currents3":
        n = tsetup.build_model(**kw, device="cpu").n_real
        rng = np.random.default_rng(5)
        kw.update(irefra=3, currents=(0.3 * rng.standard_normal(n),
                                      0.3 * rng.standard_normal(n)))
    kw.update(extra)
    return kw


@functools.lru_cache(maxsize=None)
def _setup(config="plain", nfre_red=None):
    return tsetup.build_model(**_kw(config, nfre_red=nfre_red),
                              dtype=torch.float64, device="cpu")


def _inputs(ms, seed=0):
    """Forcing over the sea points padded as the models pad it, the
    JONSWAP cold start and the first-guess stress (host float64)."""
    rng = np.random.default_rng(seed)
    n = ms.n_real
    frc = dict(wswave=6.0 + 6.0 * rng.random(n),
               wdwave=rng.random(n) * 2.0 * np.pi, aird=np.full(n, 1.225),
               wstar=np.zeros(n), cicover=np.zeros(n))
    frc = {k: tsetup.pad_point_field(ms, v) for k, v in frc.items()}
    fl1 = np.asarray(preset.mstart(ms.tb, frc["wswave"], frc["wdwave"]),
                     np.float64)
    stress = {k: v.numpy() for k, v in
              tstepper.initial_stress(ms, frc).items()}
    return fl1, frc, stress


def _mesh(k):
    return multihost.make_point_mesh(["cpu"] * k)


@pytest.mark.parametrize("config", ["plain", "fastwaves", "currents3"])
def test_sharded_fused_nproc_invariance(config):
    ms = _setup(config)
    fl1, frc, stress = _inputs(ms)
    sb = tstepper.make_step(ms)
    frc_t = {k: torch.as_tensor(v) for k, v in frc.items()}
    f, state = sb.step_full(torch.as_tensor(fl1), frc_t,
                            {k: torch.as_tensor(v) for k, v in
                             stress.items()})
    f, _ = sb.step_full(f, frc_t, {k: state[k] for k in stress})
    ref = f.numpy()[..., :ms.n_real]
    for n_shards in (2, 8):
        sm = sharded.build_sharded_model(ms, _mesh(n_shards))
        assert isinstance(sm, sharded.FusedShardedModel)
        fs = sm.device_put(fl1)
        frc_s = {k: sm.device_put(v) for k, v in frc.items()}
        st = {k: sm.device_put(v) for k, v in stress.items()}
        for _ in range(2):
            fs, state = sm.step_full(fs, frc_s, st)
            st = {k: state[k] for k in st}
        got = sm.from_layout(fs)[..., :ms.n_real]
        np.testing.assert_allclose(
            got, ref, rtol=1e-11, atol=1e-11 * ref.max(),
            err_msg=f"n_shards={n_shards} config={config}")


def test_device_norms_match_host_norms():
    ms = _setup()
    fl1, _, _ = _inputs(ms)
    sm = sharded.build_sharded_model(ms, _mesh(4))
    swh = 4.0 * np.sqrt(np.einsum("kmn,m->n", fl1, ms.tb.dfim))
    parts = sm.device_put(swh)
    host = sm.norms(parts)
    dev = sm.norms_device(parts)
    assert dev["count"] == host["count"] == ms.n_real
    np.testing.assert_allclose(dev["average"], host["average"], rtol=1e-12)
    assert dev["minimum"] == host["minimum"]
    assert dev["maximum"] == host["maximum"]


def _fast_model(ms, fl1, frc, stress):
    n = ms.n_real
    return driver.FastWaveModel(
        ms, lambda d: {k: v[:n] for k, v in frc.items()}, START, fl1=fl1,
        stress={k: torch.as_tensor(v) for k, v in stress.items()})


@pytest.mark.parametrize("nfre_red", [25, 20])
def test_kernel_architecture_matches_fast_wave_model(nfre_red):
    ms = _setup(nfre_red=nfre_red)
    fl1, frc, stress = _inputs(ms)
    n = ms.n_real
    m = _fast_model(ms, fl1, frc, stress)
    m.advance(2)
    m.advance(1, full_phys=True)
    want = m.fl1.numpy()[..., :n]
    for n_shards in (2, 4):
        sm = sharded.build_sharded_model(ms, _mesh(n_shards))
        rows, tail = sm.put_rows(fl1)
        assert (tail[0] is None) == (nfre_red == 25)
        s6 = sm.put_stress6(stress)
        frc6 = sm.put_forcing(frc)
        for _ in range(2):
            rows, tail, s6 = sm.step_rows(rows, tail, s6, frc6)
        rows, tail, s6, state = sm.step_rows_full(rows, tail, s6, frc6)
        assert np.array_equal(sm.rows_to_compact(rows, tail)[..., :n], want)
        st = sm.stress6_to_dict(s6)
        for k in ipk.STRESS_KEYS:
            assert np.array_equal(st[k][:n], m.stress[k].numpy()[:n]), k
        for k in ("emean", "tauoc", "mij", "ustokes"):
            assert np.array_equal(sm.from_layout(state[k])[:n],
                                  m.state[k].numpy()[:n]), k
        for k in ("esea", "eswell"):
            assert np.array_equal(sm.from_layout(state["sep"][k])[:n],
                                  m.state["sep"][k].numpy()[:n]), k
        # each pass moved the adjacent rows, nothing more
        assert sm.halo_bytes > 0


def test_kernel_full_state_for_products():
    """step_rows_full gives what io/products reads (fluxes, Stokes, means,
    mij, the windsea/swell split) over own points."""
    ms = _setup()
    fl1, frc, stress = _inputs(ms)
    sm = sharded.build_sharded_model(ms, _mesh(2))
    rows, tail = sm.put_rows(fl1)
    s6 = sm.put_stress6(stress)
    rows, tail, s6, state = sm.step_rows_full(rows, tail, s6,
                                              {k: v for k, v in frc.items()})
    n = ms.n_real
    em = sm.from_layout(state["emean"])[:n]
    assert np.all(np.isfinite(em)) and np.all(em > 0)
    swh = 4.0 * np.sqrt(em)
    assert 0.05 < swh.mean() < 15.0
    assert "xllws" not in state
    esea = sm.from_layout(state["sep"]["esea"])[:n]
    eswell = sm.from_layout(state["sep"]["eswell"])[:n]
    assert np.all(np.isfinite(esea)) and np.all(np.isfinite(eswell))
    assert np.all(esea + eswell > 0)
    mij = sm.from_layout(state["mij"])[:n]
    assert mij.min() >= 0 and mij.max() <= ms.tb.nfre - 1
    to = sm.from_layout(state["tauoc"])[:n]
    assert np.all((to > 0.5) & (to < 1.5))


@pytest.mark.parametrize("nfre_red", [25, 20])
def test_kernel_architecture_matches_reference_step_rows(nfre_red):
    ms = _setup(nfre_red=nfre_red)
    fl1, frc, stress = _inputs(ms)
    jms = jsetup.build_model(**_kw(nfre_red=nfre_red), dtype=jnp.float64)
    jsm = jsharded.build_sharded_model(
        jms, Mesh(np.array(jax.devices()[:2]), ("pts",)),
        backend="pallas", interpret=True)
    jrows, jtail = jsm.put_rows(fl1)
    js6 = jsm.put_stress6(stress)
    jfrc = {k: jsm.device_put(v) for k, v in frc.items()}
    for _ in range(2):
        jrows, jtail, js6 = jsm.step_rows(jrows, jtail, js6, jfrc)
    want = jsm.rows_to_compact(jrows, jtail)[..., :ms.n_real]
    want_s = jsm.stress6_to_dict(js6)
    sm = sharded.build_sharded_model(ms, _mesh(2))
    rows, tail = sm.put_rows(fl1)
    s6 = sm.put_stress6(stress)
    for _ in range(2):
        rows, tail, s6 = sm.step_rows(rows, tail, s6, frc)
    got = sm.rows_to_compact(rows, tail)[..., :ms.n_real]
    np.testing.assert_allclose(got, want, rtol=1e-10,
                               atol=1e-10 * np.abs(want).max())
    got_s = sm.stress6_to_dict(s6)
    for k in ipk.STRESS_KEYS:
        # the reference kernel's TAUWDIR comes from the Cephes atanf
        # polynomial (ecwam_tpu/ops/physics/kernelmode.py:49, |err| ≲
        # 1e-7); the port's plain chain takes torch.atan2
        atol = 1e-7 if k == "tauwdir" else 1e-14
        np.testing.assert_allclose(got_s[k][:ms.n_real],
                                   want_s[k][:ms.n_real], rtol=1e-10,
                                   atol=atol, err_msg=k)
