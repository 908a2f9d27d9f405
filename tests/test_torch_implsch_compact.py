"""Kernel C's plain version, the compact entry, against ``ecwam_tpu``.

``implsch_cuda.implsch_compact`` (on the CPU its plain version
``implsch_compact_plain``) against the reference's compact kernel
``implsch_pallas`` on the compact (nang, nfre, n) spectrum of
tests/test_implsch_pallas.py:_problem, in minimal and full mode, both
sides fed float64, at tests/test_implsch_pallas.py:171-192's bounds: rtol
1e-6 on the spectrum and the stress rows, 1e-5 on phiocd, exact xllws and
mij.  The reference kernel runs through its plain reference, the XLA
chain with the kernel's packed inputs and outputs
(``test_torch_implsch_full.reference_chain``): the reference's own tests
pin the kernel to that chain (tests/test_implsch_pallas.py:
_check_kernel_vs_direct), and interpreting the kernel here cost two
minutes of the tier-1 run.  The CUDA kernel is held against the plain
version in tests/test_torch_gpu.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from ecwam_tpu.ops.physics import implsch_pallas as j_ipk
from ecwam_tpu_torch.ops.physics import implsch_cuda as t_ipk
from test_torch_implsch_full import (F64, NPTS, _assert_full_rows,  # noqa: F401
                                     _port_cfg, _t, prob, reference_chain)


@pytest.mark.parametrize("full", [False, True])
def test_compact_matches_interpret_kernel(prob, full):
    p = prob
    env = {k: jnp.asarray(v) for k, v in p["env"].items()}
    env2d = np.asarray(j_ipk.pack_env(env, p["tb"].nfre, F64))
    scal = np.asarray(j_ipk.pack_scal(
        {k: jnp.asarray(v) for k, v in p["frc"].items()},
        {k: jnp.asarray(v) for k, v in p["stress"].items()}, env, NPTS, F64))
    res = reference_chain(p["cfg"] if full
                          else j_ipk.minimal_config(p["cfg"]),
                          p["fl"], env2d, scal, full)
    got = t_ipk.implsch_compact(_port_cfg(p, full),
                                *map(_t, (p["fl"], env2d, scal)), full=full)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(res[0]),
                               rtol=1e-6, atol=1e-12)
    if full:
        _assert_full_rows(got[1].numpy(), res[1], "compact")
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(res[2]))
    else:
        np.testing.assert_allclose(got[1].numpy(), np.asarray(res[1]),
                                   rtol=1e-6, atol=1e-12)
