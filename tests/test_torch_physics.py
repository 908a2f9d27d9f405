"""Plain-torch source terms against their ``ecwam_tpu`` counterparts.

Each ported physics function and the minimal-mode IMPLSCH chain run on
the inputs of tests/test_implsch_pallas.py:_problem (iphys=1, ice
points included) in float64, through JAX and through the port, at
rtol 1e-9 / atol 1e-14 per function (the DIA f64 bound,
test_implsch_pallas.py:141) and rtol 1e-8 for the whole chain.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import test_implsch_pallas as tip
from ecwam_tpu.ops.physics import airsea as j_airsea
from ecwam_tpu.ops.physics import dia as j_dia
from ecwam_tpu.ops.physics import implsch as j_impl
from ecwam_tpu.ops.physics import implsch_pallas as j_ipk
from ecwam_tpu.ops.physics import means as j_means
from ecwam_tpu.ops.physics import sdissip as j_sdissip
from ecwam_tpu.ops.physics import shallow as j_shallow
from ecwam_tpu.ops.physics import sinput as j_sinput
from ecwam_tpu.ops.physics import stress as j_stress
from ecwam_tpu.ops.physics import tail_ice as j_tail
from ecwam_tpu_torch.ops.physics import airsea as t_airsea
from ecwam_tpu_torch.ops.physics import dia as t_dia
from ecwam_tpu_torch.ops.physics import implsch as t_impl
from ecwam_tpu_torch.ops.physics import implsch_cuda as t_ipk
from ecwam_tpu_torch.ops.physics import means as t_means
from ecwam_tpu_torch.ops.physics import sdissip as t_sdissip
from ecwam_tpu_torch.ops.physics import shallow as t_shallow
from ecwam_tpu_torch.ops.physics import sinput as t_sinput
from ecwam_tpu_torch.ops.physics import stress as t_stress
from ecwam_tpu_torch.ops.physics import tail_ice as t_tail

NPTS = 64


class P:
    """One problem in float64, as numpy, with derived inputs."""

    def __init__(self):
        tb, cfg, env, fl1, frc, stress = tip._problem(npts=NPTS)
        f64 = lambda d: {k: np.asarray(v, np.float64) for k, v in d.items()}
        self.tb, self.cfg = tb, cfg
        self.params = cfg.params
        self.fl = np.asarray(fl1, np.float64)
        self.env, self.frc, self.stress = f64(env), f64(frc), f64(stress)
        rng = np.random.default_rng(5)
        self.xllws = (rng.random(self.fl.shape) < 0.5).astype(np.float64)
        th = np.asarray(tb.th)[:, None]
        wd = self.frc["wdwave"][None, :]
        self.coswdif = np.cos(th - wd)
        self.sinwdif2 = np.sin(th - wd) ** 2
        self.raorw = np.maximum(self.frc["aird"], 1.0) * 1e-3
        self.rnfac = np.ones(NPTS)
        self.flm = (1e-5 * np.maximum(self.coswdif, 0.0) ** 2)
        self.fld0 = 1e-4 * rng.standard_normal(self.fl.shape)
        self.sl0 = 1e-6 * rng.standard_normal(self.fl.shape)
        self.akmean = np.full(NPTS, 0.05)


@pytest.fixture(scope="module")
def prob():
    return P()


def _t(x):
    return torch.tensor(np.asarray(x, np.float64))


def _j(x):
    return jnp.asarray(np.asarray(x, np.float64))


def _sinput_args(p, ngst, llsneg):
    e, f, s = p.env, p.frc, p.stress
    arrays = (p.fl, e["wavnum"], e["cinv"], e["xk2cg"], f["wdwave"],
              f["wswave"], s["ufric"], s["z0m"], p.coswdif, p.sinwdif2,
              p.raorw, f["wstar"], p.rnfac)
    kw = dict(ngst=ngst, llsneg=llsneg)
    return arrays, kw


def _case(name, p):
    """(jax function of arrays, torch function of arrays, arrays)."""
    tb, par, e, f, s = p.tb, p.params, p.env, p.frc, p.stress
    if name == "semean":
        return (lambda a: j_means.semean(a, tb),
                lambda a: t_means.semean(a, tb), (p.fl,))
    if name == "fkmean":
        return (lambda a, w: j_means.fkmean(a, w, tb),
                lambda a, w: t_means.fkmean(a, w, tb), (p.fl, e["wavnum"]))
    if name == "femeanws":
        return (lambda a, x: j_means.femeanws(a, x, tb),
                lambda a, x: t_means.femeanws(a, x, tb), (p.fl, p.xllws))
    if name == "sdepthlim":
        return (lambda a, m: j_means.sdepthlim(a, m, tb),
                lambda a, m: t_means.sdepthlim(a, m, tb),
                (p.fl, e["emaxdpt"]))
    if name.startswith("airsea"):
        iusfg = int(name[-1])
        args = (f["wswave"], f["wdwave"], s["tauw"], s["tauwdir"], s["ufric"])
        return (lambda *a: j_airsea.airsea(*a, par, iusfg=iusfg),
                lambda *a: t_airsea.airsea(*a, par, iusfg=iusfg), args)
    if name == "wsigstar":
        args = (f["wswave"], s["ufric"], s["z0m"], f["wstar"])
        return (lambda *a: j_airsea.wsigstar(*a, par),
                lambda *a: t_airsea.wsigstar(*a, par), args)
    if name.startswith("sinput"):
        ngst = 1 if name.endswith("1") else 2
        args, kw = _sinput_args(p, ngst, ngst == 2)
        # the port's fifth output, the mask's margin, has no counterpart
        return (lambda *a: j_sinput.sinput_ard(*a, tb, par, **kw),
                lambda *a: t_sinput.sinput_ard(*a, tb, par, **kw)[:4], args)
    if name == "frcutindex":
        fm = np.asarray(j_means.fkmean(_j(p.fl), _j(e["wavnum"]), tb)[1])
        fmws = np.asarray(j_means.femeanws(_j(p.fl), _j(p.xllws), tb)[1])
        args = (fm, fmws, s["ufric"], f["cicover"])
        return (lambda *a: j_stress.frcutindex(*a, tb, par),
                lambda *a: t_stress.frcutindex(*a, tb, par), args)
    if name == "stresso":
        sargs, kw = _sinput_args(p, 2, True)
        _, sl, spos, _ = jax.jit(lambda *a: j_sinput.sinput_ard(
            *a, tb, par, **kw))(*map(_j, sargs))
        fm = j_means.fkmean(_j(p.fl), _j(e["wavnum"]), tb)[1]
        mij, rho = j_stress.frcutindex(fm, fm, _j(s["ufric"]),
                                       _j(f["cicover"]), tb, par)
        mij = np.asarray(mij)
        kw = dict(x0tauhf=p.cfg.x0tauhf, wtauhf=p.cfg.wtauhf)
        args = (p.fl, sl, spos, e["cinv"], rho, f["wdwave"], s["ufric"],
                s["z0m"], f["aird"], p.rnfac, p.coswdif, p.sinwdif2)

        def jf(fl, sl, spos, cinv, rho, *rest):
            return j_stress.stresso(fl, sl, spos, cinv, jnp.asarray(mij),
                                    rho, *rest, tb, par, **kw)

        def tf(fl, sl, spos, cinv, rho, *rest):
            return t_stress.stresso(fl, sl, spos, cinv,
                                    torch.tensor(mij).long(), rho, *rest,
                                    tb, par, **kw)
        return jf, tf, args
    if name == "sdissip_ard":
        args = (p.fl, p.fld0, p.sl0, e["wavnum"], e["xk2cg"], s["ufric"],
                p.coswdif, p.raorw)
        si, sw = p.cfg.sat_indices, p.cfg.sat_weights

        def jf(fl, fld, sl, wav, xk2cg, *rest):
            return j_sdissip.sdissip_ard(fl, fld, sl, wav, None, xk2cg,
                                         *rest, tb, par, si, sw)
        return jf, (lambda *a: t_sdissip.sdissip_ard(*a, tb, par, si, sw)), \
            args
    if name.startswith("snonlin"):
        isn = int(name[-1])
        args = (p.fl, p.fld0, p.sl0, e["wavnum"], e["depth"], p.akmean)
        return (lambda *a: j_dia.snonlin(*a, tb, p.cfg.dia, isnonlin=isn),
                lambda *a: t_dia.snonlin(*a, tb, p.cfg.dia, isnonlin=isn),
                args)
    if name == "transf":
        return j_dia.transf, t_dia.transf, (e["wavnum"], e["depth"][None, :])
    if name == "sdiwbk":
        em, _, f1, _, _ = j_means.fkmean(_j(p.fl), _j(e["wavnum"]), tb)
        args = (p.fl, p.fld0, p.sl0, e["depth"], e["emaxdpt"], em, f1)
        return (lambda *a: j_shallow.sdiwbk(*a, 20),
                lambda *a: t_shallow.sdiwbk(*a, 20), args)
    if name == "sbottom":
        args = (p.fl, p.fld0, p.sl0, e["wavnum"], e["depth"])
        return (lambda *a: j_shallow.sbottom(*a, 20),
                lambda *a: t_shallow.sbottom(*a, 20), args)
    if name == "imphftail":
        mij = np.random.default_rng(2).integers(5, tb.nfre, NPTS)
        args = (p.fl, p.flm, e["wavnum"], e["xk2cg"])
        return (lambda fl, *r: j_tail.imphftail(fl, jnp.asarray(mij), *r),
                lambda fl, *r: t_tail.imphftail(fl, torch.as_tensor(mij),
                                                *r), args)
    if name == "setice":
        return (j_tail.setice, t_tail.setice,
                (p.fl, f["cicover"], p.coswdif))
    raise KeyError(name)


FUNCTIONS = ("semean", "fkmean", "femeanws", "sdepthlim", "airsea_iusfg0",
             "airsea_iusfg1", "wsigstar", "sinput_ngst1", "sinput_ngst2",
             "frcutindex", "stresso", "sdissip_ard", "snonlin_isnonlin0",
             "snonlin_isnonlin1", "transf", "sdiwbk", "sbottom", "imphftail",
             "setice")


@pytest.mark.parametrize("name", FUNCTIONS)
def test_function_matches_reference_f64(prob, name):
    jf, tf, args = _case(name, prob)
    want = jax.jit(jf)(*map(_j, args))
    got = tf(*map(_t, args))
    if not isinstance(want, tuple):
        want, got = (want,), (got,)
    assert len(want) == len(got)
    for i, (w, g) in enumerate(zip(want, got)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-9,
                                   atol=1e-14, err_msg=f"{name}[{i}]")


def test_implsch_minimal_matches_reference_f64(prob):
    p = prob
    cfg_j = j_ipk.minimal_config(p.cfg)
    out_j, st_j = jax.jit(lambda f, e, fr, s: j_impl.implsch(
        cfg_j, f, e, fr, **s))(
        _j(p.fl), {k: _j(v) for k, v in p.env.items()},
        {k: _j(v) for k, v in p.frc.items()},
        {k: _j(v) for k, v in p.stress.items()})
    cfg_t = t_ipk.minimal_config(t_impl.make_physics_config(
        p.tb, p.params, idelt=p.cfg.idelt))
    out_t, st_t = t_impl.implsch(
        cfg_t, _t(p.fl), {k: _t(v) for k, v in p.env.items()},
        {k: _t(v) for k, v in p.frc.items()},
        *(_t(p.stress[k]) for k in t_ipk.STRESS_KEYS))
    scale = np.abs(np.asarray(out_j)).max()
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=1e-8,
                               atol=1e-14 * scale)
    # the port adds two diagnostics: the cut argument's distance from a
    # tie and the windsea mask's margin, positive exactly on the mask
    assert set(st_t) == set(st_j) | {"frcut_tie", "xllws_margin"}
    assert torch.equal(st_t["xllws"] != 0.0, st_t["xllws_margin"] > 0.0)
    for k, v in st_j.items():
        np.testing.assert_allclose(st_t[k].numpy(), np.asarray(v),
                                   rtol=1e-8, atol=1e-14, err_msg=k)
    tie = st_t["frcut_tie"].numpy()
    assert tie.shape == (p.fl.shape[-1],)
    assert ((tie >= 0.0) & (tie <= 0.5)).all()


def test_unported_physics_options_raise(prob):
    from ecwam_tpu_torch.core import physparams as t_pp
    from ecwam_tpu_torch.core.spectral import build_spectral_tables
    cfg = t_impl.make_physics_config(prob.tb, prob.params, idelt=900.0,
                                     icode_wnd=1)
    # u* forcing: the compact entry (the dense model), in both modes and
    # with any other option; the SRL fast path takes U10 only
    with pytest.raises(NotImplementedError, match="icode_wnd"):
        t_impl.check_ported(cfg, srl=True)
    t_impl.check_ported(cfg)
    for c in (cfg, dataclasses.replace(cfg, lciwa1=True, lstrn=True),
              t_impl.make_physics_config(
                  prob.tb, t_pp.set_phys_params(iphys=0, nang=prob.tb.nang,
                                                llgcbz0=True),
                  idelt=900.0, icode_wnd=2, isnonlin=2)):
        for full in (False, True):
            t_ipk.kernel_supports(c if full else t_ipk.minimal_config(c),
                                  full, compact=True)
        with pytest.raises(NotImplementedError, match="icode_wnd"):
            t_ipk.kernel_supports(c, full=True)
    # iphys=0, ISNONLIN 0/2, SDICE1/2, LSTRN, the switches and full mode's
    # flux/Stokes switches are ported, in the plain chain and in the
    # kernel, in both modes
    t_impl.check_ported(t_impl.make_physics_config(
        prob.tb, t_pp.set_phys_params(iphys=0, nang=prob.tb.nang),
        idelt=900.0))
    for kw in (dict(isnonlin=0), dict(isnonlin=2),
               dict(lciwa1=True, lciwa2=True, lstrn=True, lbiwbk=False,
                    licerun=False, lmaskice=False),
               dict(lcflx=False, lstokes=False, lwvflx_snl=False)):
        c = t_impl.make_physics_config(prob.tb, prob.params, idelt=900.0,
                                       **kw)
        t_impl.check_ported(c)
        t_ipk.kernel_supports(c, full=True)
        t_ipk.kernel_supports(t_ipk.minimal_config(c))
    # the wide build: more than 64 directions, any frequency count, past
    # 128 directions too; an unknown ISNONLIN and a row past the block's
    # shared memory stay refused
    tb72 = build_spectral_tables(nang=72, nfre=prob.tb.nfre)
    c72 = t_impl.make_physics_config(
        tb72, t_pp.set_phys_params(iphys=1, nang=72), idelt=900.0)
    t_ipk.kernel_supports(c72, full=True)
    assert t_ipk.library(c72, False) == t_ipk.WIDE_LIB
    assert t_ipk.library(t_impl.make_physics_config(
        prob.tb, prob.params, idelt=900.0), True) == "implsch"
    tb130 = build_spectral_tables(nang=130, nfre=prob.tb.nfre)
    t_ipk.kernel_supports(t_impl.make_physics_config(
        tb130, t_pp.set_phys_params(iphys=1, nang=130), idelt=900.0))
    tb800 = build_spectral_tables(nang=800, nfre=prob.tb.nfre)
    with pytest.raises(NotImplementedError, match="nang=800"):
        t_ipk.kernel_supports(t_impl.make_physics_config(
            tb800, t_pp.set_phys_params(iphys=1, nang=800), idelt=900.0))
    with pytest.raises(ValueError, match="ISNONLIN"):
        t_ipk.kernel_supports(dataclasses.replace(c72, isnonlin=3))