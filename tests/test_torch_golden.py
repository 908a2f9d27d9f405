"""The port's SRL driver against the reference's Pallas fast path and
its committed golden statistics.log.

``ecwam_tpu_torch``'s ``FastWaveModel`` (float32, plain versions on the
CPU) on the golden-trajectory configuration:
  * against ``ecwam_tpu``'s ``FastWaveModel(backend="xla")`` (its XLA
    advection; the fast path's physics is the Pallas kernel, interpreted
    on the CPU), 5 minimal-mode steps from the same cold start, on fl1 and
    the stress fields at tests/test_trajectory_oracle.py's f32 bound (5e-3
    of the field maximum).  The reference's own tests pin its XLA
    advection to the Pallas kernel at 2e-6 (tests/test_fused_pallas.py);
    interpreting the advection kernel here cost a third of the test's
    time;
  * 5 output-date steps ``advance(1, full_phys=True)`` (full-mode physics
    chunked, with the windsea/swell split), whose statistics.log norms —
    swh, and ufric, phiaw, emean, wsemean, esea, eswell on the physics
    steps — must match tests/golden/statistics_golden.json (made by
    tests/test_golden_trajectory.py) in average, minimum and maximum at
    that test's rtol 2e-5.
"""

import numpy as np
import torch

import test_golden_trajectory as tgold
from ecwam_tpu.model import driver as jdrv
import test_trajectory_oracle as toracle
from ecwam_tpu_torch.model import driver as tdrv
from ecwam_tpu_torch.model import setup as tsetup
from ecwam_tpu_torch.model import cases
from ecwam_tpu_torch.model.cases import START, golden_kw, provider
from ecwam_tpu_torch.model.fusedstep import SEP_KEYS
from ecwam_tpu_torch.ops.physics.implsch_cuda import SCAL_OUT_FULL
from test_torch_driver import assert_trajectory_close


def test_golden_config_matches_reference_fast_path():
    ms_j, m_p = tgold._model()
    m_j = jdrv.FastWaveModel(ms_j, m_p.forcing_provider, START,
                             backend="xla")
    ms_t = tsetup.build_model(device="cpu", **golden_kw())
    m_t = tdrv.FastWaveModel(
        ms_t, provider(toracle._forcing(ms_t.n_real), 900.0), START)
    n = ms_t.n_real
    np.testing.assert_array_equal(m_t.fl1.numpy(), np.asarray(m_j.fl1))
    m_j.advance(tgold.NSTEPS, wind_every=2)
    m_t.advance(tgold.NSTEPS, wind_every=2)
    assert_trajectory_close(m_t.fl1.numpy()[..., :n],
                            np.asarray(m_j.fl1)[..., :n],
                            {k: v.numpy() for k, v in m_t.stress.items()},
                            {k: np.asarray(v) for k, v in m_j.stress.items()},
                            n)
    norms = m_t.norms()
    assert norms["count"] == n and 0.0 < norms["minimum"] <= norms["maximum"]
    assert m_t.timers.steps == tgold.NSTEPS


def test_golden_statistics_match_the_committed_log():
    assert cases.GOLDEN_STEPS == tgold.NSTEPS
    err = cases.golden_statistics_error(cases.golden_statistics("cpu"),
                                        tgold.GOLDEN)
    assert len(err) == 29
    for key, e in err.items():
        assert e <= 2e-5, key


def test_output_date_state_and_chunk_view():
    ms = tsetup.build_model(device="cpu", **golden_kw())
    m = tdrv.FastWaveModel(
        ms, provider(toracle._forcing(ms.n_real), 900.0), START)
    m.advance(1, full_phys=True)
    assert m.state == {}                   # no physics on the first step
    m.advance(1, full_phys=True)
    assert set(m.state) == set(SCAL_OUT_FULL) | {"sep"}
    assert tuple(m.state["sep"]) == SEP_KEYS
    for k, v in list(m.state.items()) + list(m.state["sep"].items()):
        if k != "sep":
            assert v.shape == (ms.n_pad,), k
            assert bool(torch.isfinite(v.double()).all()), k
    assert m.state["mij"].dtype == torch.int64
    torch.testing.assert_close(m.state["ufric"], m.stress["ufric"],
                               rtol=0, atol=0)
    for start, count in ((0, 7), (ms.n_pad - 5, 5)):
        torch.testing.assert_close(m.fl1_chunk(start, count),
                                   m.fl1[..., start:start + count],
                                   rtol=0, atol=0)
