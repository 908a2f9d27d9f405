"""Carrying the port's model state across as tensors (fault C1).

``FastWaveModel.fl1`` and ``.stress`` give the compact spectrum and the
six stress fields as tensors; a restart (``FastWaveModel(..., fl1=,
stress=)``) and the setters take them back as they are, numpy arrays or
tensors on any device, as the reference's setters take its device arrays
(``ecwam_tpu/model/driver.py:276-281, 341-359``).  On the golden
configuration (plain versions, float32, CPU) a run restarted from a
2-step state given as tensors and run 2 more steps equals a 4-step run
exactly, in fl1 and in all six stress fields.  The card's counterpart is
in tests/test_torch_gpu.py.
"""

import torch

from ecwam_tpu_torch.model import cases
from ecwam_tpu_torch.model.driver import FastWaveModel
from ecwam_tpu_torch.ops.physics import implsch_cuda as ipk


def _golden():
    ms = cases.build_model(device="cpu", **cases.golden_kw())
    return ms, cases.provider(cases.golden_forcing(ms.n_real), 900.0)


def _model(ms, prov, start=cases.START, **kw):
    return FastWaveModel(ms, prov, start, plain=True, **kw)


def _assert_same_state(a, b):
    assert torch.equal(a.fl1, b.fl1)
    for k in ipk.STRESS_KEYS:
        assert torch.equal(a.stress[k], b.stress[k]), k


def test_fl1_setter_takes_the_models_own_tensor():
    ms, prov = _golden()
    m = _model(ms, prov).advance(2, wind_every=2)
    before = m.fl1.clone()
    m.fl1 = m.fl1
    assert torch.equal(m.fl1, before)
    ref = _model(ms, prov).advance(2, wind_every=2)
    m.advance(2)
    ref.advance(2)
    _assert_same_state(m, ref)


def test_stress_setter_round_trips():
    ms, prov = _golden()
    m = _model(ms, prov).advance(2, wind_every=2)
    before = {k: v.clone() for k, v in m.stress.items()}
    m.stress = m.stress
    for k in ipk.STRESS_KEYS:
        assert torch.equal(m.stress[k], before[k]), k
    ref = _model(ms, prov).advance(2, wind_every=2)
    m.advance(2)
    ref.advance(2)
    _assert_same_state(m, ref)


def test_restart_from_tensors_equals_a_straight_run():
    ms, prov = _golden()
    straight = _model(ms, prov).advance(4, wind_every=2)
    first = _model(ms, prov).advance(2, wind_every=2)
    fl1, stress = first.fl1, first.stress
    assert isinstance(fl1, torch.Tensor)
    assert all(isinstance(v, torch.Tensor) for v in stress.values())
    again = _model(ms, prov, first.date, fl1=fl1, stress=stress)
    again.advance(2, wind_every=2)
    _assert_same_state(again, straight)
