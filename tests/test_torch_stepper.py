"""The port's dense CTU advection against the reference's, in float64.

``ecwam_tpu_torch.ops.propagation`` (PROPDOT, CTUW, PROPAGS2 in plain
PyTorch, the weights slot-major) and ``ecwam_tpu_torch.model.stepper``
(the cached weights built by frequency blocks, the OTF blocks, the
NPROMA physics chunks) against ``ecwam_tpu``'s XLA versions on the same
tables:
  * the weights of each band (``_compute_weights``: the fast-wave bands,
    the CFL current retry) on the 6° and 12° aqua grids for irefra
    0/1/2/3, at rtol 1e-12 of each plane's maximum, and the CFL mask
    equal;
  * ``ctuw_weights`` against the ctuw.F90 oracle of
    tests/test_oracle_ctuw.py on its obstructed grid, at that file's
    RTOL 1e-12;
  * ``propags2`` on the reference's own weights, carried across with
    ``weights_from_numpy`` (1e-12);
  * the OTF advection against the cached one over 3 steps, in
    tests/test_otf.py's three cases (rtol 1e-12), and the chunked physics
    against the whole (tests/test_otf.py:63).
"""

from types import SimpleNamespace

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import test_oracle_ctuw as toc
from ecwam_tpu.core import constants as jc
from ecwam_tpu.model import preset as jpreset
from ecwam_tpu.model import setup as jsetup
from ecwam_tpu.model import stepper as jstepper
from ecwam_tpu.ops import propagation as jprop
from ecwam_tpu_torch.model import setup as tsetup
from ecwam_tpu_torch.model import stepper as tstepper
from ecwam_tpu_torch.ops import propagation as tprop

from oracle import ctuw as octuw

RTOL = 1e-12


def _t(a):
    return torch.as_tensor(np.array(a, np.float64))


def _currents(grid_name, amp=0.3, seed=5):
    n = jsetup.build_model(grid_name=grid_name, nang=12, nfre=8,
                           pad_to=64, dtype=jnp.float64).n_real
    rng = np.random.default_rng(seed)
    return (amp * rng.standard_normal(n), amp * rng.standard_normal(n))


def _pair(**kw):
    """The reference's and the port's setups of the same float64 model."""
    return (jsetup.build_model(dtype=jnp.float64, **kw),
            tsetup.build_model(dtype=torch.float64, device="cpu", **kw))


def _assert_weights(got, ref, what):
    want = tprop.weights_from_numpy(
        {k: (np.asarray(v) if hasattr(v, "shape") else v)
         for k, v in ref.items()})
    assert (got["mstart"], got["mend"]) == (want["mstart"], want["mend"])
    assert got["w"].shape == want["w"].shape, what
    for i in range(want["w"].shape[0]):
        w = want["w"][i].numpy()
        np.testing.assert_allclose(
            got["w"][i].numpy(), w, rtol=RTOL,
            atol=RTOL * max(np.abs(w).max(), 1e-300),
            err_msg=f"{what} plane {i}")
    np.testing.assert_array_equal(got["cflfail"].numpy(),
                                  want["cflfail"].numpy())


CASES = {
    f"{g}_irefra{r}": dict(grid_name=g, irefra=r)
    for g in ("6.0", "12.0") for r in (0, 1, 2, 3)}
CASES.update({
    "6.0_irefra1_fast": dict(grid_name="6.0", irefra=1, ifrelfmax=4,
                             delpro_lf=450.0),
    "12.0_irefra3_fast": dict(grid_name="12.0", irefra=3, ifrelfmax=4,
                              delpro_lf=450.0),
    "12.0_irefra0_fast": dict(grid_name="12.0", ifrelfmax=3,
                              delpro_lf=450.0),
    # currents of ±6 m/s at idelpro 9000 s: the CFL retry drops them at
    # some points (tests/test_fused_pallas.py's retry case)
    "6.0_irefra2_cfl_retry": dict(grid_name="6.0", irefra=2,
                                  idelpro=9000.0),
})


@pytest.mark.parametrize("name", sorted(CASES))
def test_band_weights_match_reference(name):
    kw = dict(CASES[name])
    g, irefra = kw.pop("grid_name"), kw.get("irefra", 0)
    if irefra in (2, 3):
        amp = 6.0 if "cfl" in name else 0.3
        kw["currents"] = _currents(g, amp)
    ms_j, ms_t = _pair(grid_name=g, nang=12, nfre=12, pad_to=64,
                       weights_mode="cached", **kw)
    nfr = ms_j.tb.nfre_red
    st_j = jstepper._st_ns(jstepper.stencil_device_arrays(ms_j),
                           ms_j.stencil.xdella)
    want = jstepper._compute_weights(ms_j, st_j,
                                     ms_j.env["cgroup_ext"][:nfr], ms_j.env)
    st_t = tstepper.stencil_device_arrays(ms_t)
    got = tstepper._compute_weights(ms_t, st_t,
                                    ms_t.env["cgroup_ext"][:nfr], ms_t.env)
    assert len(got) == len(want) == (2 if ms_j.ifrelfmax else 1)
    for b, (gw, ww) in enumerate(zip(got, want)):
        _assert_weights(gw, ww, f"{name} band {b}")
    if "cfl" in name:
        refr = tstepper._refraction(ms_t, ms_t.env)
        first = tstepper._band_weights(ms_t, st_t, ms_t.env["cgroup_ext"][
            :nfr], refr, 0, nfr, ms_t.idelpro, keep=False)
        assert bool(first.any()), "the retry case must break the CFL test"


@pytest.mark.parametrize("irefra", [0, 3])
def test_ctuw_weights_match_oracle(irefra):
    ms, tb = toc._setup(irefra)
    st = ms.stencil
    nfr = tb.nfre_red
    env = {k: _t(v) for k, v in ms.env.items()}
    cg_ext = env["cgroup_ext"][:nfr]
    refr = {}
    if irefra:
        thdd, thdc, sdot = tprop.propdot(
            st, tb, env["wavnum_ext"][:nfr], cg_ext,
            env["omosnh2kd_ext"][:nfr], env["depth_ext"], env["ucur_ext"],
            env["vcur_ext"], irefra)
        refr = dict(thdd=thdd, thdc=thdc, sdot=sdot,
                    omosnh2kd_ext=env["omosnh2kd_ext"][:nfr],
                    u_ext=env["ucur_ext"], v_ext=env["vcur_ext"])
    got = tprop.ctuw_weights(
        900.0, tprop.stencil_tensors(st, torch.float64, "cpu"), tb, cg_ext,
        irefra=irefra, **refr)
    ost = SimpleNamespace(
        klat=st.klat, klon=st.klon, kcor=st.kcor, wlat=st.wlat,
        wcor=st.wcor, dp=st.dp, zdello_pt=st.zdello_pt, xdella=st.xdella,
        tanph_pt=st.tanph_pt, obslat=st.obslat, obslon=st.obslon,
        obscor=st.obscor)
    want = octuw.ctuw(
        900.0, tb, ost, cg_ext.numpy(), env["omosnh2kd_ext"][:nfr].numpy(),
        np.asarray(st.cosphm1_pt, np.float64), env["ucur_ext"].numpy(),
        env["vcur_ext"].numpy(), irefra=irefra,
        **{k: (refr[k].numpy() if irefra else None)
           for k in ("thdd", "thdc", "sdot")},
        circ=jc.CIRC, r_earth=jc.R_EARTH)

    def check(g, w, what):
        w = np.moveaxis(w, 0, 2)          # oracle (npts, nang, nf, …)
        np.testing.assert_allclose(
            g.numpy(), w, rtol=toc.RTOL,
            atol=toc.RTOL * max(np.abs(w).max(), 1e-300), err_msg=what)
    check(got["sumwn"], want["sumwn"], "sumwn")
    for i in range(2):
        check(got["wlon"][i], want["wlonn"][..., i], f"wlon {i}")
    for i in range(4):
        check(got["wlat"][i], want["wlatn"][..., i // 2, i % 2], f"wlat {i}")
    for i in range(8):
        check(got["wcor"][i], want["wcorn"][..., i // 2, i % 2], f"wcor {i}")
    # the oracle's slots: [0] from k−1 (m−1), [2] from k+1 (m+1)
    for i, j in ((0, 0), (1, 2)):
        check(got["wkpm"][i], want["wkpmn"][..., j], f"wkpm {i}")
        if irefra:
            check(got["wmpm"][i], want["wmpmn"][..., j], f"wmpm {i}")


@pytest.mark.parametrize("irefra", [0, 3])
def test_propags2_on_reference_weights(irefra):
    ms, tb = toc._setup(irefra)
    st, nfr = ms.stencil, tb.nfre_red
    env = ms.env
    refr = {}
    if irefra:
        thdd, thdc, sdot = jprop.propdot(
            st, tb, env["wavnum_ext"][:nfr], env["cgroup_ext"][:nfr],
            env["omosnh2kd_ext"][:nfr], env["depth_ext"], env["ucur_ext"],
            env["vcur_ext"], irefra)
        refr = dict(thdd=thdd, thdc=thdc, sdot=sdot,
                    omosnh2kd_ext=env["omosnh2kd_ext"][:nfr],
                    u_ext=env["ucur_ext"], v_ext=env["vcur_ext"])
    w_j = jprop.ctuw_weights(900.0, st, tb, env["cgroup_ext"][:nfr],
                             irefra=irefra, **refr)
    w_t = tprop.weights_from_numpy(
        {k: (np.asarray(v) if hasattr(v, "shape") else v)
         for k, v in w_j.items()})
    f = np.random.default_rng(4).random((tb.nang, nfr, ms.n_pad + 1))
    f[..., -1] = 0.0
    want = np.asarray(jprop.propags2(jnp.asarray(f), w_j, st, tb))
    got = tprop.propags2(torch.as_tensor(f), w_t,
                         tprop.stencil_tensors(st, torch.float64, "cpu"), tb)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())


def _otf_build(**kw):
    return tsetup.build_model(grid_name="6.0", nang=12, nfre=25,
                              idelpro=900.0, idelt=900.0, pad_to=64,
                              dtype=torch.float64, device="cpu", **kw)


def _otf_inputs(ms):
    n = ms.n_pad
    rng = np.random.default_rng(1)
    wswave = 8.0 + 4.0 * rng.random(n)
    wdwave = rng.random(n) * 2 * np.pi
    frc = {k: torch.as_tensor(v) for k, v in dict(
        wswave=wswave, wdwave=wdwave, aird=np.full(n, 1.225),
        wstar=np.zeros(n), cicover=np.zeros(n)).items()}
    fl1 = torch.as_tensor(jpreset.mstart(ms.tb, wswave, wdwave))
    return fl1, frc, tstepper.initial_stress(ms, dict(wswave=wswave,
                                                      wdwave=wdwave))


@pytest.mark.parametrize("kw", [
    dict(),
    dict(irefra=3),
    dict(delpro_lf=450.0, ifrelfmax=5),
], ids=["plain", "irefra3", "fastwaves"])
def test_otf_matches_cached(kw):
    if "irefra" in kw:
        kw = dict(kw, currents=_currents("6.0"))
    ms_c = _otf_build(weights_mode="cached", **kw)
    ms_o = _otf_build(weights_mode="otf", otf_block=4, **kw)
    fl1, _, _ = _otf_inputs(ms_c)
    _, adv_c, _ = tstepper.make_step(ms_c)
    _, adv_o, _ = tstepper.make_step(ms_o)
    fc, fo = fl1, fl1
    for _ in range(3):
        fc, fo = adv_c(fc), adv_o(fo)
    np.testing.assert_allclose(fo.numpy(), fc.numpy(), rtol=1e-12,
                               atol=1e-18)


def test_phys_chunk_matches_whole():
    ms_w = _otf_build(weights_mode="cached")
    ms_c = _otf_build(weights_mode="cached", phys_chunk=ms_w.n_pad // 8)
    fl1, frc, stress = _otf_inputs(ms_w)
    full_w, _, _ = tstepper.make_step(ms_w)
    full_c, _, _ = tstepper.make_step(ms_c)
    fw, sw = full_w(fl1, frc, stress)
    fc, sc = full_c(fl1, frc, stress)
    np.testing.assert_allclose(fc.numpy(), fw.numpy(), rtol=1e-12,
                               atol=1e-18)
    assert set(sc) == set(sw)
    for k in sw:
        np.testing.assert_allclose(sc[k].numpy(), sw[k].numpy(),
                                   rtol=1e-12, atol=1e-18, err_msg=k)
