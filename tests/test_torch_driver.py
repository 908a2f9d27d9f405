"""The port's SRL driver end to end against the f64 WAMINTGR oracle.

``ecwam_tpu_torch.model.driver.FastWaveModel`` (float32, on the CPU
through the plain versions of both kernels) against the straight-line
f64 WAMINTGR oracle on the fast-path trajectory configurations of
tests/test_trajectory_oracle.py (``fastwaves_refra1`` and the
NFRE > NFRE_RED ``split_fastwaves``), 5 steps with a forcing swap every
2, at that test's f32 bound (rtol 5e-3 of the field maximum).
"""

import numpy as np
import jax.numpy as jnp
import pytest

import test_trajectory_oracle as toracle
from ecwam_tpu.model import setup as jsetup
from ecwam_tpu_torch.model import driver as tdrv
from ecwam_tpu_torch.model import setup as tsetup
from ecwam_tpu_torch.model.cases import START, provider

RTOL = 5e-3


def assert_trajectory_close(got, want, got_stress, want_stress, n):
    """fl1 and the stress fields within RTOL of each field's maximum."""
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * scale)
    for k in ("ufric", "tauw", "z0m", "chrnck"):
        w = np.asarray(want_stress[k], np.float64)[:n]
        np.testing.assert_allclose(
            np.asarray(got_stress[k], np.float64)[:n], w, rtol=RTOL,
            atol=RTOL * max(np.abs(w).max(), 1e-12), err_msg=k)


@pytest.mark.parametrize("config", ["fastwaves_refra1", "split_fastwaves"])
def test_fast_path_matches_wamintgr_oracle(config):
    nfre_red = toracle.NFRE - 2 if config == "split_fastwaves" else \
        toracle.NFRE
    wg, b, obstr, blk = toracle._grid_with_topo(nfre_red)
    n = blk.nsea
    forcing_at = toracle._forcing(n)
    kw = dict(grid=wg, bathy=b, nang=toracle.NANG, nfre=toracle.NFRE,
              nfre_red=nfre_red, pad_to=8, obstructions=obstr, iphys=1,
              idelpro=900.0, idelt=1800.0, delpro_lf=450.0, ifrelfmax=3,
              irefra=1)
    ms_t = tsetup.build_model(device="cpu", **kw)
    m = tdrv.FastWaveModel(ms_t, provider(forcing_at, 900.0), START)
    stress0 = {k: v.numpy().astype(np.float64) for k, v in m.stress.items()}
    fl1_0 = m.fl1.numpy().astype(np.float64)
    m.advance(toracle.NSTEPS, wind_every=2)

    ms_j = jsetup.build_model(dtype=jnp.float32, weights_mode="fused", **kw)
    want, want_stress = toracle._oracle_traj(ms_j, fl1_0, stress0, forcing_at)
    assert_trajectory_close(m.fl1.numpy()[..., :n], want[..., :n],
                            {k: v.numpy() for k, v in m.stress.items()},
                            want_stress, n)
