"""ECMWF's cycle-49/50 physics options in the port against ``ecwam_tpu``.

On the inputs of tests/test_implsch_pallas.py:_problem (64 points), with
sea ice on every point (cicover 0 → 1, cithick 0.5 → 2 m) and winds of
3–40 m/s:
  * the gravity-capillary functions (``gc``: tables, NS_GC, OMEGAGC,
    STRESS_GC with and without LLNORMAGAM, MEANSQS_LF, HALPHAP), TAUT_Z0's
    gravity-capillary branch, SDICE3, SINPUT with LLNORMAGAM and STRESSO
    with LLGCBZ0/LLNORMAGAM, through JAX and through the port in float64,
    at rtol 1e-10 (exact table equality for the tables and indices);
  * the plain IMPLSCH chain, minimal and full mode, with the cy49r1 flags
    (LLGCBZ0 + LLNORMAGAM + LLCAPCHNK, tests/test_implsch_pallas.py:
    158-169) and the cy50r1 flags (+ LCIWA3 + LCISCAL), against
    ``impl.implsch``: rtol 1e-10 in float64 (both flag sets, both modes),
    and in float32 (cy49r1 minimal, cy50r1 full) 1e-5 of each field's
    maximum (1e-6 for the spectrum).  The reference's own f32
    kernel bound (rtol 1e-6) holds between its kernel and its XLA chain,
    which trace one jaxpr; between two float32 implementations the
    cut-sensitive fields read up to 3.8e-6 (emeanws), so 1e-5 here;
  * ``gc_margin``, the closure's decision margin: non-negative, +inf
    without LLGCBZ0, and where it is wide the float32 and float64 chains
    leave every loop at the same iteration (u* within 1e-5).
"""

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import test_implsch_pallas as tip
from ecwam_tpu.core import physparams as j_pp
from ecwam_tpu.ops.physics import airsea as j_airsea
from ecwam_tpu.ops.physics import gc as j_gc
from ecwam_tpu.ops.physics import implsch as j_impl
from ecwam_tpu.ops.physics import sdice as j_sdice
from ecwam_tpu.ops.physics import sinput as j_sinput
from ecwam_tpu.ops.physics import stress as j_stress
from ecwam_tpu_torch.core import physparams as t_pp
from ecwam_tpu_torch.model import cases
from ecwam_tpu_torch.ops.physics import airsea as t_airsea
from ecwam_tpu_torch.ops.physics import gc as t_gc
from ecwam_tpu_torch.ops.physics import implsch as t_impl
from ecwam_tpu_torch.ops.physics import implsch_cuda as t_ipk
from ecwam_tpu_torch.ops.physics import sdice as t_sdice
from ecwam_tpu_torch.ops.physics import sinput as t_sinput
from ecwam_tpu_torch.ops.physics import stress as t_stress

NPTS = 64
F64 = jnp.float64
CONFIGS = {"cy49r1": ({}, cases.CY49R1),
           "cy50r1": (dict(lciwa3=True, lciscal=True), cases.CY49R1)}


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
        # winds to 40 m/s: CHNKMIN and RNFAC act only above about 25 m/s
        self.frc["wswave"] = np.linspace(3.0, 40.0, NPTS)
        th = np.asarray(tb.th)[:, None]
        self.coswdif = np.cos(th - self.frc["wdwave"][None, :])
        self.sinwdif2 = np.sin(th - self.frc["wdwave"][None, :]) ** 2
        self.raorw = np.maximum(self.frc["aird"], 1.0) * 1e-3
        rng = np.random.default_rng(5)
        self.rnfac = 1.0 + 0.2 * rng.random(NPTS)
        self.halp = 0.004 + 0.01 * rng.random(NPTS)
        self.fld0 = 1e-4 * rng.standard_normal(self.fl.shape)
        self.sl0 = 1e-6 * rng.standard_normal(self.fl.shape)
        self.mij = rng.integers(10, tb.nfre, NPTS)

    def params(self, **flags):
        return (j_pp.set_phys_params(iphys=1, nang=self.tb.nang, **flags),
                t_pp.set_phys_params(iphys=1, nang=self.tb.nang, **flags))


@pytest.fixture(scope="module")
def prob():
    return P()


def _t(x):
    return torch.tensor(np.asarray(x, np.float64))


def _case(name, p):
    """(jax function, port function, float64 arguments)."""
    e, f, s = p.env, p.frc, p.stress
    jg, tg = j_gc.gc_tables(), t_gc.gc_tables()
    us = s["ufric"]
    if name == "ns_gc":
        return (lambda u: j_gc.ns_gc(u, jg), lambda u: t_gc.ns_gc(u, tg),
                (us,))
    if name == "omegagc":
        return (lambda u: j_gc.omegagc(u, jg)[1:],
                lambda u: t_gc.omegagc(u, tg)[1:], (us,))
    if name.startswith("stress_gc"):
        jp, tp = p.params(llgcbz0=True,
                          llnormagam=name.endswith("normagam"))
        z0 = 1e-4 * (1.0 + np.arange(NPTS) / NPTS)
        args = (0.4 + 0.2 * p.rnfac, us, z0, p.halp, p.rnfac)
        return (lambda a, u, z, h, r: j_gc.stress_gc(a, u, z, 1e-6, h, r, jg,
                                                     jp),
                lambda a, u, z, h, r: t_gc.stress_gc(a, u, z, 1e-6, h, r, tg,
                                                     tp), args)
    if name == "meansqs_lf":
        return (lambda fl, w: j_gc.meansqs_lf(20, fl, w, p.tb),
                lambda fl, w: t_gc.meansqs_lf(20, fl, w, p.tb),
                (p.fl, e["wavnum"]))
    if name == "halphap":
        jp, tp = p.params(llgcbz0=True)
        return (lambda fl, w, c: j_gc.halphap(fl, w, c, p.tb, jp),
                lambda fl, w, c: t_gc.halphap(fl, w, c, p.tb, tp),
                (p.fl, e["wavnum"], p.coswdif))
    if name.startswith("taut_z0_gc"):
        jp, tp = p.params(**cases.CY49R1)
        iusfg = int(name[-1])
        args = (f["wswave"], f["wdwave"], s["tauw"], s["tauwdir"], us,
                p.halp, p.rnfac)
        return (lambda *a: j_airsea.taut_z0_gc(*a, jp, iusfg=iusfg),
                lambda *a: t_airsea.taut_z0_gc(*a, tp, iusfg=iusfg)[:4],
                args)
    if name == "sdice3":
        args = (p.fl, p.fld0, p.sl0, e["wavnum"], e["cgroup"], f["cicover"],
                f["cithick"])
        return (lambda *a: j_sdice.sdice(*a, p.tb, 900.0, lciwa3=True),
                lambda *a: t_sdice.sdice(*a, p.tb, 900.0, lciwa3=True),
                args)
    if name == "sinput_normagam":
        jp, tp = p.params(**cases.CY49R1)
        args = (p.fl, e["wavnum"], e["cinv"], e["xk2cg"], f["wdwave"],
                f["wswave"], us, s["z0m"], p.coswdif, p.sinwdif2, p.raorw,
                f["wstar"], p.rnfac)
        return (lambda *a: j_sinput.sinput_ard(*a, p.tb, jp, ngst=2),
                lambda *a: t_sinput.sinput_ard(*a, p.tb, tp, ngst=2)[:4],
                args)
    if name.startswith("stresso"):
        flags = (dict(llgcbz0=True) if name.endswith("gcbz0")
                 else cases.CY49R1)
        jp, tp = p.params(**flags)
        cfg = t_impl.make_physics_config(p.tb, tp, idelt=900.0)
        rhow = np.where(np.arange(p.tb.nfre)[:, None] <= p.mij[None, :],
                        np.asarray(p.tb.rhowg_dfim)[:, None], 0.0)
        args = (p.fl, p.sl0, np.abs(p.sl0), e["cinv"], p.mij, rhow,
                f["wdwave"], us, s["z0m"], f["aird"], p.rnfac, p.coswdif,
                p.sinwdif2)
        kw = dict(x0tauhf=cfg.x0tauhf, wtauhf=cfg.wtauhf)
        return (lambda *a: j_stress.stresso(*a, p.tb, jp, **kw),
                lambda *a: t_stress.stresso(*a, p.tb, tp, **kw), args)
    raise KeyError(name)


@pytest.mark.parametrize("name", [
    "ns_gc", "omegagc", "stress_gc", "stress_gc_normagam", "meansqs_lf",
    "halphap", "taut_z0_gc0", "taut_z0_gc1", "sdice3", "sinput_normagam",
    "stresso_gcbz0", "stresso_cy49r1"])
def test_option_function_matches_reference_f64(prob, name):
    jf, tf, args = _case(name, prob)
    want = jax.jit(jf)(*(jnp.asarray(a) if np.asarray(a).dtype.kind == "i"
                         else jnp.asarray(a, F64) for a in args))
    got = tf(*(torch.tensor(a) if np.asarray(a).dtype.kind == "i"
               else _t(a) for a in args))
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10,
                                   atol=0.0, err_msg=f"{name}[{i}]")


def test_gc_tables_equal_reference():
    jg, tg = j_gc.gc_tables(), t_gc.gc_tables()
    assert tg.nwav == jg.nwav == 82
    for field in dataclasses.fields(tg):
        np.testing.assert_array_equal(np.asarray(getattr(tg, field.name)),
                                      np.asarray(getattr(jg, field.name)),
                                      err_msg=field.name)


@functools.lru_cache(maxsize=None)
def _chain(p, name, full, dtype):
    """(port state, reference state) of one IMPLSCH step, computed once a
    module."""
    extra, flags = CONFIGS[name]
    jp, tp = p.params(**flags)
    cj = j_impl.make_physics_config(p.tb, jp, idelt=900.0, **extra)
    ct = t_impl.make_physics_config(p.tb, tp, idelt=900.0, **extra)
    if not full:
        cj = dataclasses.replace(cj, lcflx=False, lstokes=False)
        ct = t_ipk.minimal_config(ct)
    jdt = F64 if dtype == torch.float64 else jnp.float32
    j = lambda d: {k: jnp.asarray(v, jdt) for k, v in d.items()}
    out_j, st_j = jax.jit(lambda fl, e, fr, s: j_impl.implsch(
        cj, fl, e, fr, **s))(jnp.asarray(p.fl, jdt), j(p.env), j(p.frc),
                             j(p.stress))
    t = lambda a: torch.tensor(np.asarray(a), dtype=dtype)
    out_t, st_t = t_impl.implsch(
        ct, t(p.fl), {k: t(v) for k, v in p.env.items()},
        {k: t(v) for k, v in p.frc.items()},
        *(t(p.stress[k]) for k in t_ipk.STRESS_KEYS))
    return out_t, st_t, np.asarray(out_j), st_j


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_implsch_options_match_reference_f64(prob, name, full):
    out_t, st_t, out_j, st_j = _chain(prob, name, full, torch.float64)
    np.testing.assert_allclose(out_t.numpy(), out_j, rtol=1e-10,
                               atol=1e-10 * np.abs(out_j).max())
    extra = {"frcut_tie", "xllws_margin", "gc_margin"}
    assert set(st_t) == set(st_j) | extra | ({"strnms"} if full else set())
    for k, v in st_j.items():
        np.testing.assert_allclose(st_t[k].numpy(), np.asarray(v),
                                   rtol=1e-10, atol=1e-14, err_msg=k)


@pytest.mark.parametrize("name,full", [("cy49r1", False), ("cy50r1", True)])
def test_implsch_options_match_reference_f32(prob, name, full):
    out_t, st_t, out_j, st_j = _chain(prob, name, full, torch.float32)
    np.testing.assert_allclose(out_t.numpy(), out_j, rtol=0.0,
                               atol=1e-6 * np.abs(out_j).max())
    for k, v in st_j.items():
        v = np.asarray(v, np.float64)
        np.testing.assert_allclose(
            st_t[k].numpy().astype(np.float64), v, rtol=0.0,
            atol=1e-5 * max(np.abs(v).max(), 1e-30), err_msg=k)


def test_gc_margin_marks_the_rows_whose_loops_can_exit_apart(prob):
    _, st64, _, _ = _chain(prob, "cy50r1", True, torch.float64)
    _, st32, _, _ = _chain(prob, "cy50r1", True, torch.float32)
    m = st64["gc_margin"]
    assert m.shape == (NPTS,) and bool((m >= 0.0).all())
    wide = m > 1e-2
    assert int(wide.sum()) > NPTS // 2
    torch.testing.assert_close(st32["ufric"][wide].double(),
                               st64["ufric"][wide], rtol=1e-5, atol=0.0)
    # without the gravity-capillary closure there is no such decision
    cfg = t_impl.make_physics_config(prob.tb, prob.params()[1], idelt=900.0)
    rows = torch.tensor(prob.fl.transpose(2, 0, 1).reshape(NPTS, -1))
    env2d = torch.cat([torch.tensor(prob.env[k]) for k in t_ipk.ENV_FIELDS])
    scal = torch.stack([torch.tensor(np.asarray(
        {**prob.frc, **prob.stress, **prob.env}[k], np.float64))
        for k in t_ipk.SCAL_IN])
    free = t_ipk.gc_margin(cfg, rows, env2d, scal, None,
                           nang=prob.tb.nang, nfre_red=prob.tb.nfre)
    assert bool(torch.isinf(free).all())
