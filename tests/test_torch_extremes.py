"""The port's freak-wave chain (``io/extremes``) against
``ecwam_tpu.io.extremes``.

``kurtosis`` and each of its parts (``peak_ang``, ``transf_r``,
``transf_bfi``, ``stat_nl``, ``h_max``) run on the seeded wind-sea and
swell state of ``test_torch_products.problem`` in float64 through both
packages and agree to 1e-10 of each output's largest magnitude; the
fixed-trip Newton ``aki_newton`` (the reference's ``aki_jax``) matches
the host solver ``core.dispersion.aki`` at the reference test's rtol
1e-5 (``test_products.py::test_aki_jax_matches_host_newton``), and the
deep-water limits of the transfer functions hold.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecwam_tpu.io import extremes as j_ext
from ecwam_tpu_torch.core import dispersion as t_disp
from ecwam_tpu_torch.core.spectral import build_spectral_tables as t_tables
from ecwam_tpu_torch.io import extremes as t_ext

from test_torch_products import NANG, NFRE, problem

TOL = 1e-10


def _check(got, want, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(np.abs(want).max(), 1e-300)
    np.testing.assert_array_less(np.abs(got - want) / scale, TOL,
                                 err_msg=what)


@pytest.fixture(scope="module")
def prob():
    tb, fl1, _, _, env = problem(False)
    return tb, t_tables(nang=NANG, nfre=NFRE), fl1, env["depth"]


def test_kurtosis_matches_reference(prob):
    tb, ttb, fl1, depth = prob
    want = j_ext.kurtosis(jnp.asarray(fl1), jnp.asarray(depth), tb)
    got = t_ext.kurtosis(torch.tensor(fl1), torch.tensor(depth), ttb)
    assert set(got) == set(want)
    for k in want:
        _check(got[k], want[k], k)
    # the chain's clips hold
    assert (np.abs(got["c4"].numpy()) <= 0.25).all()
    qp = got["qp"].numpy()
    assert ((qp == 0.0) | ((qp >= 0.5) & (qp <= 15.0))).all()


def test_peak_ang_matches_reference(prob):
    tb, ttb, fl1, _ = prob
    want = j_ext.peak_ang(jnp.asarray(fl1), tb)
    got = t_ext.peak_ang(torch.tensor(fl1), ttb)
    for name, g, w in zip(("xnu", "sig_th"), got, want):
        _check(g, w, name)


def _chain_inputs(prob):
    """Peak wavenumber, BFI², widths as the kurtosis chain forms them."""
    tb, _, fl1, depth = prob
    k = j_ext.kurtosis(jnp.asarray(fl1), jnp.asarray(depth), tb)
    xnu, sig_th = j_ext.peak_ang(jnp.asarray(fl1), tb)
    xm0 = (fl1.sum(0) * np.asarray(tb.dfim)[:, None]).sum(0)
    xk0 = np.asarray(k["eps"]) / np.sqrt(np.maximum(xm0, 1e-30))
    return dict(xm0=xm0, xk0=xk0, bf2=np.asarray(k["bfi2"]),
                xnu=np.asarray(xnu), sig_th=np.asarray(sig_th), depth=depth,
                c3=np.asarray(k["c3"]), c4=np.asarray(k["c4"]),
                xnslc=np.asarray(k["xnslc"]))


@pytest.mark.parametrize("fn", ["transf_r", "transf_bfi", "stat_nl",
                                "h_max"])
def test_parts_match_reference(prob, fn):
    a = _chain_inputs(prob)
    args = {"transf_r": ("xk0", "depth"),
            "transf_bfi": ("xk0", "depth", "xnu", "sig_th"),
            "stat_nl": ("xm0", "xk0", "bf2", "xnu", "sig_th", "depth"),
            "h_max": ("c3", "c4", "xnslc")}[fn]
    want = getattr(j_ext, fn)(*(jnp.asarray(a[k]) for k in args))
    got = getattr(t_ext, fn)(*(torch.tensor(a[k]) for k in args))
    if not isinstance(want, tuple):
        want, got = (want,), (got,)
    for i, (g, w) in enumerate(zip(got, want)):
        _check(g, w, f"{fn}[{i}]")


def test_aki_newton_matches_host_newton():
    om = np.linspace(0.3, 3.0, 16)
    depth = np.linspace(5.0, 500.0, 16)
    ref = t_disp.aki(om, depth)
    got = t_ext.aki_newton(torch.tensor(om), torch.tensor(depth)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    _check(got, j_ext.aki_jax(jnp.asarray(om), jnp.asarray(depth)), "aki")


def test_transf_limits():
    # deep water: R transfer → 0.5, BFI transfer → 1
    t = lambda v: torch.tensor(v, dtype=torch.float64)
    assert float(t_ext.transf_r(t(0.1), t(5000.0))) == pytest.approx(0.5)
    assert float(t_ext.transf_bfi(t(0.1), t(5000.0), t(0.3), t(0.3))) == \
        pytest.approx(1.0)
