"""The port's second-order output correction (``ops/secondorder``)
against ``ecwam_tpu.ops.secondorder`` and the f64 oracle.

The interaction tables come from the reference's numpy code, copied: they
must be equal field by field.  ``secspom`` and ``cal_second_order_spec``
run in float64 on the randomized spectra of ``test_oracle_second.py``
and on a 12×18 grid, through both packages, and agree to 1e-10 of the
largest magnitude; against the straight-line oracle
(``tests/oracle/second.py``) they meet that file's own bounds (rtol
1e-9, atol 1e-14) on the oracle's tables.  Sub-chunked SECSPOM equals
the unchunked one, and the inverse mapping round-trips as in the
reference's test.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecwam_tpu.core import dispersion as j_disp
from ecwam_tpu.core.spectral import build_spectral_tables as j_tables
from ecwam_tpu.ops import secondorder as j_so
from ecwam_tpu.ops.physics import means as j_means
from ecwam_tpu_torch.core.spectral import build_spectral_tables as t_tables
from ecwam_tpu_torch.ops import secondorder as t_so

import test_oracle_second as tos
from oracle import second as osec

TOL = 1e-10


def _case(nang, nfre, npts, seed, **kw):
    tb = j_tables(nang=nang, nfre=nfre)
    ttb = t_tables(nang=nang, nfre=nfre)
    rng = np.random.default_rng(seed)
    fl1 = np.exp(rng.normal(-4.0, 1.5, (nang, nfre, npts)))
    depth = np.concatenate([rng.uniform(2.0, 8.0, npts // 2),
                            rng.uniform(20.0, 300.0, npts - npts // 2)])
    wavnum = j_disp.depth_properties(depth, tb.fr)["wavnum"].T.copy()
    return (tb, ttb, j_so.build_second_order_tables(tb, **kw),
            t_so.build_second_order_tables(ttb, **kw), fl1, depth, wavnum)


CASES = {"oracle_8x12": (tos.NANG, tos.NFRE, tos.NPTS, 7,
                         dict(ndepth=tos.NDEPTH, deptha=tos.DEPTHA,
                              depthd=tos.DEPTHD)),
         "12x18": (12, 18, 40, 3, dict(ndepth=20))}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    nang, nfre, npts, seed, kw = CASES[request.param]
    return _case(nang, nfre, npts, seed, **kw)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / np.abs(want).max()


def test_tables_equal_reference(case):
    _, _, jso, tso, *_ = case
    for f in dataclasses.fields(jso):
        np.testing.assert_array_equal(getattr(tso, f.name),
                                      getattr(jso, f.name), err_msg=f.name)


def _akmean(tb, fl1, wavnum):
    return np.asarray(j_means.fkmean(jnp.asarray(fl1), jnp.asarray(wavnum),
                                     tb)[3], np.float64)


@pytest.mark.parametrize("chunk", [4, 1 << 20])
def test_secspom_matches_reference(case, chunk):
    tb, _, jso, tso, fl1, depth, wavnum = case
    ak = _akmean(tb, fl1, wavnum)
    pf1 = fl1[jso.k_half][:, jso.m_half]
    want = j_so.secspom(jnp.asarray(pf1), jnp.asarray(depth),
                        jnp.asarray(ak), jso)
    got = t_so.secspom(torch.tensor(pf1), torch.tensor(depth),
                       torch.tensor(ak), tso, chunk=chunk)
    assert _rel(got.numpy(), want) < TOL


def test_subchunks_equal_whole(case):
    tb, _, _, tso, fl1, depth, wavnum = case
    ak = torch.tensor(_akmean(tb, fl1, wavnum))
    pf1 = torch.tensor(fl1[tso.k_half][:, tso.m_half])
    whole = t_so.secspom(pf1, torch.tensor(depth), ak, tso, chunk=1 << 20)
    for chunk in (1, 3, 16):
        part = t_so.secspom(pf1, torch.tensor(depth), ak, tso, chunk=chunk)
        np.testing.assert_allclose(part.numpy(), whole.numpy(), rtol=1e-13,
                                   atol=0.0)


@pytest.mark.parametrize("sig", [1.0, -1.0])
def test_cal_second_order_spec_matches_reference(case, sig):
    tb, ttb, jso, tso, fl1, depth, wavnum = case
    want = j_so.cal_second_order_spec(jnp.asarray(fl1), jnp.asarray(wavnum),
                                      jnp.asarray(depth), tb, jso, sig=sig)
    got = t_so.cal_second_order_spec(torch.tensor(fl1), torch.tensor(wavnum),
                                     torch.tensor(depth), ttb, tso, sig=sig)
    assert _rel(got.numpy(), want) < TOL
    assert not np.allclose(got.numpy(), fl1)


def _oracle_case():
    tb, ttb, _, tso, fl1, depth, wavnum = _case(*CASES["oracle_8x12"][:4],
                                                **CASES["oracle_8x12"][4])
    aki_fn = lambda om, d: float(j_disp.aki(np.float64(om), np.float64(d)))
    oso = osec.build_oracle_tables(tb.fr, tb.th, tos.NANG, tos.NFRE,
                                   tb.fratio, tos.NDEPTH, tos.DEPTHA,
                                   tos.DEPTHD, aki_fn=aki_fn)
    return tb, ttb, tos._with_oracle_tables(tso, oso), oso, fl1, depth, \
        wavnum


def test_secspom_matches_oracle():
    tb, _, so, st, fl1, depth, wavnum = _oracle_case()
    ak = _akmean(tb, fl1, wavnum)
    pf1 = fl1[so.k_half][:, so.m_half]
    got = t_so.secspom(torch.tensor(pf1), torch.tensor(depth),
                       torch.tensor(ak), so).numpy()
    want = osec.secspom(
        pf1.transpose(2, 0, 1), st["nfreh"], st["nangh"], st["nmax"],
        tos.DEPTHA, tos.DEPTHD, tos.NDEPTH, st["omstart"], st["frac"],
        st["mr"], st["dfdth"], st["omega"], depth, ak, st["ta"], st["tb"],
        st["tc_ql"], st["tt_4m"], st["tt_4p"], st["im_p"], st["im_m"])
    np.testing.assert_allclose(got, want.transpose(1, 2, 0), rtol=1e-9,
                               atol=1e-14)


def test_cal_second_order_spec_matches_oracle():
    tb, ttb, so, oso, fl1, depth, wavnum = _oracle_case()
    em, _, _, ak, _ = (np.asarray(v, np.float64) for v in j_means.fkmean(
        jnp.asarray(fl1), jnp.asarray(wavnum), tb))
    got = t_so.cal_second_order_spec(torch.tensor(fl1), torch.tensor(wavnum),
                                     torch.tensor(depth), ttb, so).numpy()
    want = osec.cal_second_order_spec(
        fl1.transpose(2, 0, 1), depth, em, ak, tb.fr, tb.th, tb.fratio,
        tos.NANG, tos.NFRE, oso, sig=1.0)
    np.testing.assert_allclose(got, want.transpose(1, 2, 0), rtol=1e-9,
                               atol=1e-14)
    assert not np.allclose(got, fl1)


def test_inverse_mapping_roundtrip():
    """As the reference's test, on its case."""
    _, ttb, _, tso, fl1, depth, wavnum = _case(*CASES["oracle_8x12"][:4],
                                               **CASES["oracle_8x12"][4])
    args = (torch.tensor(wavnum), torch.tensor(depth), ttb, tso)
    fwd = t_so.cal_second_order_spec(torch.tensor(fl1), *args, sig=1.0)
    back = t_so.cal_second_order_spec(fwd, *args, sig=-1.0).numpy()
    assert np.abs(back - fl1).max() < 0.15 * np.abs(fl1).max()
