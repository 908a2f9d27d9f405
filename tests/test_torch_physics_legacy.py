"""The rest of the physics in the port against ``ecwam_tpu`` and the oracles.

iphys=0 (Janssen's SINPUT_JAN, the cycle-4 SDISSIP_JAN), the DIA
enhancements ISNONLIN 0/1/2 (PEAK_ANG, TRANSF_SNL), SDICE1/2, the sea-ice
strain (LSTRN) and the LBIWBK/LICERUN/LMASKICE switches, on the inputs of
tests/test_implsch_pallas.py:_problem (64 points; 30 % of them at 20–220
m) with sea ice on every point (cicover 0 → 1, cithick 0.5 → 2 m) and
winds of 3–40 m/s, through the XLA chain of ``ecwam_tpu`` and the port:
  * each function in float64 at rtol 1e-10;
  * the plain IMPLSCH chain with each new option set, minimal and full
    mode: rtol 1e-10 in float64; the port in float32 within 1e-6 of the
    maximum for the spectrum and 1e-5 of each field's maximum for the
    rows (the float32 bounds of the options' tests) of the reference's
    float64 chain, over the points off a decision edge — a PEAK_ANG peak
    within 1e-3 of the next direction maximum (``peak_margin``) or a
    windsea-mask bin within 1e-4 of its edge (``xllws_margin``).  The reference's own float32
    chain is the wrong yardstick here: with the switches off it lies
    1.05e-6 of the spectrum's maximum from its float64 chain at one point
    (a 22 m/s wind over 50 m without SDEPTHLIM), where the port's float32
    chain lies 1.2e-7 from it;
  * the f64 oracles tests/oracle/{srcterms,snl,sdiceo}.py at their own
    tests' tolerances (1e-11, 1e-12, 1e-12);
  * the port's ``FastWaveModel`` (plain, float64) with iphys=0 on the
    trajectory oracle's ``fastwaves_refra1`` configuration
    (tests/test_trajectory_oracle.py:65-110) against the f64 WAMINTGR
    oracle at its rtol 1e-9 (the oracle runs iphys=0 with ISNONLIN=1,
    tests/oracle/implschfull.py:55-123);
  * the decision margins: where ``peak_margin`` and the JAN mask margin
    are wide, the float32 and float64 chains pick the same peak and the
    same mask;
  * kernel D's plain version against the reference's op definitions
    (scripts/mosaic_opclass.py:77-139) in numpy, and its class order
    against the CUDA source.
"""

import dataclasses
import functools
import os
import re
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import test_implsch_pallas as tip
import test_trajectory_oracle as toracle
from ecwam_tpu.core import dispersion as j_disp
from ecwam_tpu.core import physparams as j_pp
from ecwam_tpu.core.spectral import build_spectral_tables as j_tables
from ecwam_tpu.model import setup as jsetup
from ecwam_tpu.ops.physics import dia as j_dia
from ecwam_tpu.ops.physics import implsch as j_impl
from ecwam_tpu.ops.physics import means as j_means
from ecwam_tpu.ops.physics import sdice as j_sdice
from ecwam_tpu.ops.physics import sdissip as j_sdissip
from ecwam_tpu.ops.physics import sinput as j_sinput
from ecwam_tpu_torch import _build
from ecwam_tpu_torch.core import physparams as t_pp
from ecwam_tpu_torch.model import cases
from ecwam_tpu_torch.model import driver as tdrv
from ecwam_tpu_torch.model import setup as tsetup
from ecwam_tpu_torch.ops.physics import dia as t_dia
from ecwam_tpu_torch.ops.physics import implsch as t_impl
from ecwam_tpu_torch.ops.physics import implsch_cuda as t_ipk
from ecwam_tpu_torch.ops.physics import sdice as t_sdice
from ecwam_tpu_torch.ops.physics import sdissip as t_sdissip
from ecwam_tpu_torch.ops.physics import sinput as t_sinput
from ecwam_tpu_torch.tools import opclass as oc
from oracle import reftables as ort
from oracle import sdiceo as osd
from oracle import snl as osnl
from oracle import srcterms as osrc

NPTS = 64
F64 = jnp.float64
# name: (iphys, PhysicsConfig keywords, physics flags)
CONFIGS = {
    "iphys0": (0, {}, {}),
    "iphys0_cy49r1": (0, {}, cases.CY49R1),
    "isnonlin0": (1, dict(isnonlin=0), {}),
    "isnonlin2": (1, dict(isnonlin=2), {}),
    "sdice1": (1, dict(lciwa1=True), {}),
    "sdice2": (1, dict(lciwa2=True), {}),
    "lstrn": (1, dict(lstrn=True), {}),
    "switches_off": (1, dict(lbiwbk=False, licerun=False, lmaskice=False),
                     {}),
}


class P:
    """The problem in float64 numpy, with every point iced."""

    def __init__(self):
        tb, cfg, env, fl1, frc, stress = tip._problem(npts=NPTS)
        f64 = lambda d: {k: np.asarray(v, np.float64) for k, v in d.items()}
        self.tb = tb
        self.fl = np.asarray(fl1, np.float64)
        self.env, self.frc, self.stress = f64(env), f64(frc), f64(stress)
        self.frc["cicover"] = np.linspace(0.0, 1.0, NPTS)
        self.frc["cithick"] = np.linspace(0.5, 2.0, NPTS)
        self.frc["wswave"] = np.linspace(3.0, 40.0, NPTS)
        th = np.asarray(tb.th)[:, None]
        self.coswdif = np.cos(th - self.frc["wdwave"][None, :])
        self.sinwdif2 = np.sin(th - self.frc["wdwave"][None, :]) ** 2
        self.raorw = np.maximum(self.frc["aird"], 1.0) * 1e-3
        rng = np.random.default_rng(5)
        self.rnfac = 1.0 + 0.2 * rng.random(NPTS)
        self.fld0 = 1e-4 * rng.standard_normal(self.fl.shape)
        self.sl0 = 1e-6 * rng.standard_normal(self.fl.shape)
        self.akmean = 0.02 + 0.2 * rng.random(NPTS)

    def params(self, iphys, **flags):
        return (j_pp.set_phys_params(iphys=iphys, nang=self.tb.nang, **flags),
                t_pp.set_phys_params(iphys=iphys, nang=self.tb.nang, **flags))


@pytest.fixture(scope="module")
def prob():
    return P()


def _case(name, p):
    """(jax function, port function, float64 arguments)."""
    e, f, s = p.env, p.frc, p.stress
    if name.startswith("sinput_jan"):
        flags = cases.CY49R1 if name.endswith("normagam") else {}
        jp, tp = p.params(0, **flags)
        ngst, llsneg = (1, False) if name.endswith("ngst1") else (2, True)
        args = (p.fl, e["wavnum"], e["cinv"], e["xk2cg"], f["wdwave"],
                f["wswave"], s["ufric"], s["z0m"], p.coswdif, p.sinwdif2,
                p.raorw, f["wstar"], p.rnfac)
        kw = dict(ngst=ngst, llsneg=llsneg)
        return (lambda *a: j_sinput.sinput_jan(*a, p.tb, jp, **kw),
                lambda *a: t_sinput.sinput_jan(*a, p.tb, tp, **kw)[:4], args)
    if name == "sdissip_jan":
        jp, tp = p.params(0)
        em, f1, xk = (0.5 + np.arange(NPTS) / NPTS, 0.1 + p.akmean,
                      p.akmean)
        args = (p.fl, p.fld0, p.sl0, e["wavnum"], em, f1, xk)
        return (lambda *a: j_sdissip.sdissip_jan(*a, p.tb, jp),
                lambda *a: t_sdissip.sdissip_jan(*a, p.tb, tp), args)
    if name == "peak_ang":
        return (lambda fl: j_dia.peak_ang(fl, p.tb),
                lambda fl: t_dia.peak_ang(fl, p.tb), (p.fl,))
    if name == "transf_snl":
        xnu = 0.05 + 0.3 * p.akmean
        sig = 0.2 + 2.0 * p.akmean
        args = (e["wavnum"], e["depth"][None], xnu[None], sig[None])
        return (j_dia.transf_snl, t_dia.transf_snl, args)
    if name.startswith("enhancement"):
        isn = int(name[-1])
        dia = t_impl.make_physics_config(p.tb, p.params(1)[1], 900.0).dia
        args = (e["wavnum"], e["depth"], p.akmean, p.fl)
        return (lambda w, d, a, fl: j_dia._enhancement(dia, p.tb, w, d, a, isn,
                                                       fl1=fl),
                lambda w, d, a, fl: t_dia._enhancement(dia, p.tb, w, d, a, isn,
                                                       fl1=fl), args)
    if name in ("sdice1", "sdice2"):
        args = (p.fl, p.fld0, p.sl0, e["wavnum"], e["cgroup"], f["cicover"],
                f["cithick"])
        kw = {f"lciwa{name[-1]}": True}
        return (lambda *a: j_sdice.sdice(*a, p.tb, 900.0, **kw),
                lambda *a: t_sdice.sdice(*a, p.tb, 900.0, **kw), args)
    raise KeyError(name)


@pytest.mark.parametrize("name", [
    "sinput_jan", "sinput_jan_ngst1", "sinput_jan_normagam", "sdissip_jan",
    "peak_ang", "transf_snl", "enhancement0", "enhancement1", "enhancement2",
    "sdice1", "sdice2"])
def test_legacy_function_matches_reference_f64(prob, name):
    jf, tf, args = _case(name, prob)
    want = jax.jit(jf)(*(jnp.asarray(a, F64) for a in args))
    got = tf(*(torch.tensor(np.asarray(a, np.float64)) for a in args))
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10,
                                   atol=0.0, err_msg=f"{name}[{i}]")


def _configs(p, name, full):
    """(reference PhysicsConfig, port PhysicsConfig) of CONFIGS' name."""
    iphys, extra, flags = CONFIGS[name]
    jp, tp = p.params(iphys, **flags)
    cj = j_impl.make_physics_config(p.tb, jp, idelt=900.0, **extra)
    ct = t_impl.make_physics_config(p.tb, tp, idelt=900.0, **extra)
    if not full:
        cj = dataclasses.replace(cj, lcflx=False, lstokes=False, lstrn=False)
        ct = t_ipk.minimal_config(ct)
    return cj, ct


@functools.lru_cache(maxsize=None)
def _reference(p, name, full):
    """(output, state) of one IMPLSCH step of the reference's XLA chain in
    float64, computed once a module."""
    cj = _configs(p, name, full)[0]
    j = lambda d: {k: jnp.asarray(v, F64) for k, v in d.items()}
    out_j, st_j = jax.jit(lambda fl, e, fr, s: j_impl.implsch(
        cj, fl, e, fr, **s))(jnp.asarray(p.fl, F64), j(p.env), j(p.frc),
                             j(p.stress))
    return np.asarray(out_j), st_j


@functools.lru_cache(maxsize=None)
def _port(p, name, full, dtype):
    """(output, state) of one step of the port's plain chain."""
    ct = _configs(p, name, full)[1]
    t = lambda a: torch.tensor(np.asarray(a), dtype=dtype)
    return t_impl.implsch(
        ct, t(p.fl), {k: t(v) for k, v in p.env.items()},
        {k: t(v) for k, v in p.frc.items()},
        *(t(p.stress[k]) for k in t_ipk.STRESS_KEYS))


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_legacy_chain_matches_reference_f64(prob, name, full):
    out_t, st_t = _port(prob, name, full, torch.float64)
    out_j, st_j = _reference(prob, name, full)
    np.testing.assert_allclose(out_t.numpy(), out_j, rtol=1e-10,
                               atol=1e-10 * np.abs(out_j).max())
    extra = {"frcut_tie", "xllws_margin"}
    extra |= {"gc_margin"} if name == "iphys0_cy49r1" else set()
    extra |= {"peak_margin"} if name == "isnonlin2" else set()
    extra |= {"strnms"} if full and name != "lstrn" else set()
    assert set(st_t) == set(st_j) | extra
    for k, v in st_j.items():
        np.testing.assert_allclose(st_t[k].numpy(), np.asarray(v),
                                   rtol=1e-10, atol=1e-14, err_msg=k)
    if full and name == "lstrn":
        assert float(st_t["strnms"].max()) > 0.0


def _off_edges(st64):
    """The points off a decision edge: PEAK_ANG's peak more than 1e-3
    above the next maximum, every windsea-mask bin more than 1e-4 from its
    edge."""
    keep = st64["xllws_margin"].abs().flatten(0, 1).amin(0) > 1e-4
    if "peak_margin" in st64:
        keep &= st64["peak_margin"] > 1e-3
    return keep.numpy()


@pytest.mark.parametrize("name,full", [
    ("iphys0", True), ("iphys0_cy49r1", False), ("isnonlin0", False),
    ("isnonlin2", True), ("sdice1", True), ("sdice2", False),
    ("lstrn", True), ("switches_off", True)])
def test_legacy_chain_matches_reference_f32(prob, name, full):
    out_t, st_t = _port(prob, name, full, torch.float32)
    out_j, st_j = _reference(prob, name, full)
    keep = _off_edges(_port(prob, name, full, torch.float64)[1])
    assert keep.sum() > NPTS // 2
    out_j = out_j[..., keep]
    np.testing.assert_allclose(out_t.numpy()[..., keep], out_j, rtol=0.0,
                               atol=1e-6 * np.abs(out_j).max())
    for k, v in st_j.items():
        v = np.asarray(v, np.float64)[..., keep]
        np.testing.assert_allclose(
            st_t[k].numpy().astype(np.float64)[..., keep], v, rtol=0.0,
            atol=1e-5 * max(np.abs(v).max(), 1e-30), err_msg=k)


def test_wide_margins_decide_alike_in_both_precisions(prob):
    """Where PEAK_ANG's margin is wide the two precisions pick the same
    peak; where the JAN mask margin is wide, the same windsea mask."""
    st64 = _port(prob, "isnonlin2", True, torch.float64)[1]
    pm = st64["peak_margin"]
    assert pm.shape == (NPTS,) and bool((pm >= 0.0).all())
    fl = torch.tensor(prob.fl)
    wide = pm > 1e-3
    assert int(wide.sum()) > NPTS // 2
    arg = lambda x: torch.max(t_dia._column_max(x), dim=0).indices
    assert torch.equal(arg(fl.float())[wide], arg(fl)[wide])
    st32 = _port(prob, "iphys0", True, torch.float32)[1]
    m = _port(prob, "iphys0", True, torch.float64)[1]["xllws_margin"]
    wide = m.abs() > 1e-4
    assert float(wide.double().mean()) > 0.9
    assert torch.equal(st32["xllws"].double()[wide], (m > 0).double()[wide])


# ---- the f64 oracles ------------------------------------------------------

def _oracle_fields(nang=12, nfre=25, npts=8, seed=3):
    """tests/test_oracle_srcterms.py:make_fields' inputs."""
    tb = j_tables(nang=nang, nfre=nfre)
    rng = np.random.default_rng(seed)
    fl1 = np.exp(rng.normal(-4.0, 2.0, (nang, nfre, npts)))
    depth = np.concatenate([rng.uniform(5.0, 60.0, npts // 2),
                            rng.uniform(100.0, 5000.0, npts - npts // 2)])
    props = j_disp.depth_properties(depth, tb.fr)
    f = dict(fl1=fl1, depth=depth, props=props,
             wswave=rng.uniform(2.0, 25.0, npts),
             wdwave=rng.uniform(0.0, 2.0 * np.pi, npts),
             ufric=rng.uniform(0.05, 1.5, npts),
             z0m=np.exp(rng.uniform(np.log(1e-5), np.log(5e-3), npts)),
             aird=rng.uniform(1.1, 1.3, npts))
    f["raorw"] = np.maximum(f["aird"], 1.0) * ort.ROWATERM1
    f["wstar"] = rng.uniform(0.0, 1.5, npts)
    f["rnfac"] = rng.uniform(0.8, 1.2, npts)
    th = np.asarray(tb.th)
    f["coswdif"] = np.cos(th[:, None] - f["wdwave"][None, :])
    f["sinwdif2"] = np.sin(th[:, None] - f["wdwave"][None, :]) ** 2
    f["rng"] = rng
    return tb, f


def _close(got, want, name, rtol):
    scale = max(np.abs(want).max(), 1e-300)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale,
                               err_msg=name)


def _t(a):
    return torch.tensor(np.asarray(a, np.float64))


@pytest.mark.parametrize("ngst,llsneg,llnormagam", [
    (2, True, False), (2, True, True), (1, False, False)])
def test_sinput_jan_matches_oracle(ngst, llsneg, llnormagam):
    tb, f = _oracle_fields()
    params = t_pp.set_phys_params(iphys=0, nang=tb.nang,
                                  llnormagam=llnormagam)
    pr = f["props"]
    got = t_sinput.sinput_jan(
        _t(f["fl1"]), _t(pr["wavnum"].T), _t(pr["cinv"].T),
        _t(pr["xk2cg"].T), _t(f["wdwave"]), _t(f["wswave"]),
        _t(f["ufric"]), _t(f["z0m"]), _t(f["coswdif"]), _t(f["sinwdif2"]),
        _t(f["raorw"]), _t(f["wstar"]), _t(f["rnfac"]), tb, params,
        ngst=ngst, llsneg=llsneg)
    want = osrc.sinput_jan(
        ngst, llsneg, f["fl1"].transpose(2, 0, 1), pr["wavnum"],
        pr["cinv"], pr["xk2cg"], f["wdwave"], f["wswave"], f["ufric"],
        f["z0m"], f["coswdif"].T.copy(), f["sinwdif2"].T.copy(),
        f["raorw"], f["wstar"], f["rnfac"], ort.build(tb.nang, tb.nfre),
        params)
    for g, w, name in zip(got, want, ("fld", "sl", "spos", "xllws")):
        _close(g.numpy().transpose(2, 0, 1), w, name, 1e-11)


def test_sdissip_jan_matches_oracle():
    tb, f = _oracle_fields()
    params = t_pp.set_phys_params(iphys=0, nang=tb.nang)
    pr = f["props"]
    fld = f["rng"].normal(size=f["fl1"].shape)
    sl = f["rng"].normal(size=f["fl1"].shape)
    em, _, f1m, _, xkm = j_means.fkmean(jnp.asarray(f["fl1"]),
                                        jnp.asarray(pr["wavnum"].T), tb)
    em, f1m, xkm = (np.asarray(x) for x in (em, f1m, xkm))
    gfld, gsl = t_sdissip.sdissip_jan(_t(f["fl1"]), _t(fld), _t(sl),
                                      _t(pr["wavnum"].T), _t(em), _t(f1m),
                                      _t(xkm), tb, params)
    ofld, osl = osrc.sdissip_jan(
        f["fl1"].transpose(2, 0, 1), fld.transpose(2, 0, 1),
        sl.transpose(2, 0, 1), pr["wavnum"], em, f1m, xkm,
        ort.build(tb.nang, tb.nfre), params)
    _close(gfld.numpy().transpose(2, 0, 1), ofld, "fld", 1e-11)
    _close(gsl.numpy().transpose(2, 0, 1), osl, "sl", 1e-11)


@pytest.mark.parametrize("nang,nfre", [(12, 25), (36, 29)])
@pytest.mark.parametrize("isnonlin", [0, 1, 2])
def test_snonlin_matches_oracle(nang, nfre, isnonlin):
    """tests/test_oracle_snonlin.py's inputs and bound (1e-12)."""
    tb = j_tables(nang=nang, nfre=nfre)
    rng = np.random.default_rng(7)
    npts = 8
    fl1 = np.exp(rng.normal(-4.0, 2.0, (nang, nfre, npts)))
    depth = np.concatenate([rng.uniform(3.0, 60.0, npts // 2),
                            rng.uniform(100.0, 5000.0, npts - npts // 2)])
    wavnum = j_disp.depth_properties(depth, tb.fr)["wavnum"].T.copy()
    akmean = rng.uniform(0.005, 0.3, npts)
    fld = rng.normal(size=fl1.shape)
    sl = rng.normal(size=fl1.shape)
    dia = t_dia.build_dia_tables(nang, nfre, tb.fr, tb.delth, tb.fratio)
    gfld, gsl = t_dia.snonlin(_t(fl1), _t(fld), _t(sl), _t(wavnum),
                              _t(depth), _t(akmean), tb, dia,
                              isnonlin=isnonlin)
    ofld, osl = osnl.snonlin(
        fl1.transpose(2, 0, 1), fld.transpose(2, 0, 1),
        sl.transpose(2, 0, 1), wavnum.T.copy(), depth, akmean,
        ort.build(nang, nfre), isnonlin=isnonlin)
    _close(gsl.numpy().transpose(2, 0, 1), osl, "SL", 1e-12)
    _close(gfld.numpy().transpose(2, 0, 1), ofld, "FLD", 1e-12)


@pytest.mark.parametrize("model", [1, 2])
def test_sdice_matches_oracle(model):
    """tests/test_oracle_sdice.py's inputs and bound (1e-12)."""
    nang, nfre, npts = 12, 25, 10
    tb = j_tables(nang=nang, nfre=nfre)
    rng = np.random.default_rng(21)
    fl1 = np.exp(rng.normal(-4.0, 2.0, (nang, nfre, npts)))
    props = j_disp.depth_properties(rng.uniform(30.0, 3000.0, npts), tb.fr)
    cicv = rng.uniform(0.0, 1.0, npts)
    cith = np.where(rng.uniform(size=npts) > 0.3,
                    rng.uniform(0.05, 3.0, npts), 0.0)
    fld = rng.normal(size=fl1.shape)
    sl = rng.normal(size=fl1.shape)
    ours = (_t(fl1), _t(fld), _t(sl), _t(props["wavnum"].T),
            _t(props["cgroup"].T), _t(cicv))
    theirs = (fl1.transpose(2, 0, 1), fld.transpose(2, 0, 1),
              sl.transpose(2, 0, 1), props["wavnum"], props["cgroup"], cicv)
    otb = ort.build(nang, nfre)
    if model == 1:
        got = t_sdice.sdice1(*ours, _t(cith), tb, 900.0)
        want = osd.sdice1(*theirs, cith, otb, 900.0, t_sdice.load_cideac())
    else:
        got = t_sdice.sdice2(*ours, tb, 900.0)
        want = osd.sdice2(*theirs, otb, 900.0)
    for g, w, name in zip(got, want, ("fld", "sl", "slice")):
        _close(g.numpy().transpose(2, 0, 1), w, name, 1e-12)


def test_iphys0_fast_path_matches_wamintgr_oracle(monkeypatch):
    """The port's FastWaveModel, plain and float64, with iphys=0 on the
    oracle test's ``fastwaves_refra1`` configuration, 5 steps with the
    forcing swapped every 2, against the WAMINTGR oracle (its physics
    parameters taken for iphys=0) at the oracle test's rtol 1e-9."""
    wg, b, obstr, blk = toracle._grid_with_topo()
    n = blk.nsea
    forcing_at = toracle._forcing(n)
    kw = dict(grid=wg, bathy=b, nang=toracle.NANG, nfre=toracle.NFRE,
              pad_to=8, obstructions=obstr, iphys=0, idelpro=900.0,
              idelt=1800.0, delpro_lf=450.0, ifrelfmax=3, irefra=1)
    ms_t = tsetup.build_model(dtype=torch.float64, device="cpu", **kw)
    m = tdrv.FastWaveModel(ms_t, cases.provider(forcing_at, 900.0),
                           cases.START, plain=True)
    stress0 = {k: v.numpy() for k, v in m.stress.items()}
    fl1_0 = m.fl1.numpy()
    m.advance(toracle.NSTEPS, wind_every=2)
    ms_j = jsetup.build_model(dtype=jnp.float64, weights_mode="fused", **kw)
    monkeypatch.setattr(toracle, "pp", types.SimpleNamespace(
        set_phys_params=lambda iphys, nang: j_pp.set_phys_params(
            iphys=0, nang=nang)))
    want, want_stress = toracle._oracle_traj(ms_j, fl1_0, stress0,
                                             forcing_at)
    rtol = toracle.RTOL
    got = m.fl1.numpy()[..., :n]
    np.testing.assert_allclose(got, want[..., :n], rtol=rtol,
                               atol=rtol * want[..., :n].max())
    for k in ("ufric", "tauw", "z0m", "chrnck"):
        w = np.asarray(want_stress[k])[:n]
        np.testing.assert_allclose(m.stress[k].numpy()[:n], w, rtol=rtol,
                                   atol=rtol * np.abs(w).max(), err_msg=k)


# ---- kernel D's plain version ----------------------------------------------

def _reference_op(name, x):
    """One application of the reference's op (scripts/mosaic_opclass.py:
    77-139), in numpy on (36, 40, lanes)."""
    cat = np.concatenate
    if name == "fma":
        return x * np.float32(1.0000001) + np.float32(1e-9)
    if name == "sub_shift":
        return cat([x[:, 1:, :], x[:, :1, :]], axis=1)
    if name == "sub_shift4":
        return cat([x[:, 4:, :], x[:, :4, :]], axis=1)
    if name == "lead_roll":
        return cat([x[1:], x[:1]], axis=0)
    if name == "transpose2x":
        return np.transpose(np.transpose(x, (1, 0, 2)) * np.float32(1.0000001),
                            (1, 0, 2))
    if name == "lead_reduce":
        return x + np.sum(x, axis=0)[None, :, :] * np.float32(1e-12)
    if name == "sub_reduce":
        return x + np.sum(x, axis=1)[:, None, :] * np.float32(1e-12)
    if name == "lane_bcast":
        w = (np.arange(40, dtype=np.float32).reshape(1, 40, 1)
             * np.float32(1e-6) + np.float32(0.9999))
        return x * w
    return np.exp(x * np.float32(1e-6))


@pytest.mark.parametrize("name", oc.CLASSES)
def test_opclass_plain_matches_reference_ops(name):
    """The port's plain version against a numpy transcription of the
    reference's ops: scripts/mosaic_opclass.py defines them as closures
    inside its TPU-only main(), so they cannot be imported."""
    x = oc.start(64, "cpu")
    want = x.numpy()
    for _ in range(3):
        want = _reference_op(name, want)
    got = oc.opclass(name, x, 3).numpy()
    if name in oc.LAYOUT:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0.0,
                                   atol=1e-6 * np.abs(want).max())


def test_opclass_plain_fma_rounds_once():
    """fma's plain version rounds each application once, as the kernel's
    FMA does; rounding the product and the sum apart drifts past the
    check's 1e-6 of max within the reference's 64 applications."""
    x = oc.start(4096, "cpu")
    once = twice = x.numpy()
    for _ in range(64):
        once = (once.astype(np.float64) * np.float64(np.float32(1.0000001))
                + np.float64(np.float32(1e-9))).astype(np.float32)
        twice = _reference_op("fma", twice)
    np.testing.assert_array_equal(oc.opclass("fma", x, 64).numpy(), once)
    assert np.abs(twice - once).max() > 1e-6 * np.abs(once).max()


def test_opclass_classes_match_the_kernel_source():
    with open(os.path.join(_build.CSRC, "opclass.cu")) as f:
        body = re.search(r"enum Cls \{(.*?)NCLS", f.read(), re.S).group(1)
    assert [n.lower() for n in re.findall(r"\b([A-Z0-9_]+)\b", body)] == \
        list(oc.CLASSES)


def test_option_bits_route_each_configuration(prob):
    """The default configuration runs the default instantiation (no bit),
    the cy50r1 one the OPTS instantiation (no EXT bit), each new option
    the EXT instantiations; LSTRN rides only on output dates."""
    tb = prob.tb
    bits = {name: t_ipk.option_bits(_configs(prob, name, True)[1])
            for name in CONFIGS}
    assert t_ipk.option_bits(t_impl.make_physics_config(
        tb, prob.params(1)[1], idelt=900.0)) == 0
    opts = t_ipk.option_bits(t_impl.make_physics_config(
        tb, prob.params(1, **cases.CY49R1)[1], idelt=900.0, lciwa3=True,
        lciscal=True))
    assert opts == 31 and not opts & t_ipk.EXT_BITS
    for name, b in bits.items():
        assert b & t_ipk.EXT_BITS, name
    assert not t_ipk.option_bits(_configs(prob, "lstrn", False)[1])
    assert bits["lstrn"] == t_ipk.LSTRN_BIT


@pytest.mark.parametrize("name", oc.CLASSES)
def test_opclass_bounds_follow_the_kernel_design(name):
    """Kernel D's bounds at the reference's size (K=64 over 131,072
    lanes): the classes whose lines stay in a thread's registers need no
    shared memory, so the HBM floor bounds them (their first design's
    shared-memory bound is kept beside it); transpose2x keeps its two
    shared round trips an entry and application; the elementwise classes
    the HBM floor (fma, lane_bcast) or the special-function rate (exp)."""
    b = oc.bounds(name, 128 * 1024, 64)
    hbm = 2 * 4 * 36 * 40 * 128 * 1024 / oc.HBM_BYTES_PER_S * 1e3
    assert abs(b["hbm"] - hbm) < 1e-12 and abs(hbm - 0.451) < 1e-3
    assert b["bound"] == max(b["hbm"], b["ops"], b["smem"])
    if name in oc.IN_REGISTERS:
        assert b["smem"] == 0.0 and b["by"] == "hbm"
        first = 3 if name.endswith("reduce") else 2
        assert b["smem_first"] == pytest.approx(
            first * 4 * 36 * 40 * 128 * 1024 * 64 / oc.SMEM_BYTES_PER_S * 1e3)
    elif name == "transpose2x":
        assert b["by"] == "smem" and b["smem"] == pytest.approx(5.777,
                                                               abs=1e-3)
    else:
        assert b["smem"] == b["smem_first"] == 0.0
        assert b["by"] == ("ops" if name == "exp" else "hbm")
