"""Plain-torch SRL advection against ``ecwam_tpu``'s XLA formulation.

The same compact spectrum (numpy, from a seed) goes through
``ecwam_tpu`` ``FusedPropagation(backend="xla").advect_srl`` and the
port's ``FusedPropagation.advect_srl`` on the configurations of
tests/test_fused_pallas.py (basic, fast-wave sub-band ifrelfmax=5,
depth refraction irefra=1).  float64 at rtol 1e-10; float32 at
test_fused_pallas's rtol 2e-6 / atol 1e-8.  The CUDA kernel is held
against the plain version in tests/test_torch_gpu.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ecwam_tpu.model import setup as jsetup
from ecwam_tpu.model.fusedstep import FusedPropagation as JFused
from ecwam_tpu_torch.model import setup as tsetup
from ecwam_tpu_torch.model.fusedstep import FusedPropagation
from test_torch_gpu import ADVECT_CONFIGS, advect_kw, jonswap


def _advect_both(name, jdt, tdt):
    kw = advect_kw(name)
    ms_j = jsetup.build_model(dtype=jdt, weights_mode="fused", **kw)
    ms_t = tsetup.build_model(dtype=tdt, device="cpu", **kw)
    f = jonswap(ms_j.n_pad, ms_j.tb)
    fx = JFused(ms_j, backend="xla")
    want = fx.from_srl(
        fx.advect_srl(fx.to_srl(jnp.asarray(f, jdt), fx.bundle), fx.bundle),
        fx.bundle)
    fp = FusedPropagation(ms_t)
    got = fp.from_srl(fp.advect_srl(fp.to_srl(torch.as_tensor(f, dtype=tdt))))
    n = ms_j.n_real
    return got.numpy()[..., :n], np.asarray(want)[..., :n]


@pytest.mark.parametrize("name", sorted(ADVECT_CONFIGS))
def test_advect_srl_matches_reference_f64(name):
    got, want = _advect_both(name, jnp.float64, torch.float64)
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=0.0)


@pytest.mark.parametrize("name", sorted(ADVECT_CONFIGS))
def test_advect_srl_matches_reference_f32(name):
    got, want = _advect_both(name, jnp.float32, torch.float32)
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-8)


def test_compact_advect_keeps_unadvected_tail():
    ms = tsetup.build_model(grid_name="6.0", nang=12, nfre=10, nfre_red=8,
                            idelpro=900.0, idelt=900.0, pad_to=64,
                            dtype=torch.float64, device="cpu")
    fp = FusedPropagation(ms)
    f = torch.as_tensor(jonswap(ms.n_pad, ms.tb))
    out = fp.advect(f)
    assert out.shape == f.shape
    torch.testing.assert_close(out[:, 8:], f[:, 8:], rtol=0, atol=0)
    assert torch.isfinite(out).all()
