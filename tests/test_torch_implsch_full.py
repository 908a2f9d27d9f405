"""The output-date (full-mode) physics against ``ecwam_tpu``.

On the inputs of tests/test_implsch_pallas.py:_problem (iphys=1, sea ice
on a tenth of the points, shallow and deep points), made from a numpy
seed and handed to both packages:
  * WNFLUXES, STOKESTRN (with and without the sea-ice strain) and FEMEAN
    in float64 at rtol 1e-10;
  * the plain full chain ``implsch.implsch`` against the reference's, every
    state key, float64, at the minimal chain's bounds (rtol 1e-8, atol
    1e-14, tests/test_torch_physics.py);
  * the SRL entry ``implsch_srl_plain(full=True)`` against the reference's
    SRL kernel ``implsch_pallas_srl(full=True)``, both sides fed float64,
    at tests/test_implsch_pallas.py:171-192's bounds: rtol 1e-6 on the
    spectrum and the stress rows, 1e-5 on phiocd, exact xllws and mij (the
    compact entry: tests/test_torch_implsch_compact.py).  The reference
    kernel runs through its plain reference, the XLA chain with the
    kernel's packed inputs and outputs (:func:`reference_srl`): the
    reference's own tests pin the kernel to that chain
    (tests/test_implsch_pallas.py: _check_kernel_vs_direct and the SRL
    layout tests), and interpreting the kernel here cost minutes of the
    tier-1 run.
The CUDA kernels are held against these plain versions in
tests/test_torch_gpu.py.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import test_implsch_pallas as tip
from ecwam_tpu.ops.physics import fluxes as j_fluxes
from ecwam_tpu.ops.physics import implsch as j_impl
from ecwam_tpu.ops.physics import implsch_pallas as j_ipk
from ecwam_tpu.ops.physics import means as j_means
from ecwam_tpu.ops.physics import stokes as j_stokes
from ecwam_tpu_torch.ops.physics import fluxes as t_fluxes
from ecwam_tpu_torch.ops.physics import implsch as t_impl
from ecwam_tpu_torch.ops.physics import implsch_cuda as t_ipk
from ecwam_tpu_torch.ops.physics import means as t_means
from ecwam_tpu_torch.ops.physics import stokes as t_stokes

NPTS = 64
F64 = jnp.float64


@pytest.fixture(scope="module")
def prob():
    tb, cfg, env, fl1, frc, stress = tip._problem(npts=NPTS)
    f64 = lambda d: {k: np.asarray(v, np.float64) for k, v in d.items()}
    rng = np.random.default_rng(7)
    fl = np.asarray(fl1, np.float64)
    return dict(tb=tb, cfg=cfg, env=f64(env), fl=fl, frc=f64(frc),
                stress=f64(stress),
                ssource=1e-6 * rng.standard_normal(fl.shape),
                rho=np.abs(rng.standard_normal((tb.nfre, NPTS))),
                phiwa=0.1 * rng.random(NPTS), em=0.5 * rng.random(NPTS),
                f1=0.1 + 0.2 * rng.random(NPTS))


def _t(x):
    return torch.tensor(np.asarray(x, np.float64))


def reference_chain(cfg, fl, env2d, scal, full):
    """The reference's IMPLSCH kernels (``implsch_pallas``/``_srl``)
    through their plain reference, the XLA chain ``impl.implsch``, with the
    kernels' packed inputs (``pack_env``/``pack_scal`` rows) and outputs:
    (fl1 (nang, nfre, n), the SCAL_OUT rows[, xllws]), in ``fl``'s dtype."""
    nfre = cfg.tables.nfre
    si = {k: jnp.asarray(scal[i]) for i, k in enumerate(j_ipk.SCAL_IN)}
    env = {k: jnp.asarray(env2d[i * nfre:(i + 1) * nfre])
           for i, k in enumerate(j_ipk.ENV_FIELDS)}
    env.update(depth=si["depth"], emaxdpt=si["emaxdpt"])
    frc = {k: si[k] for k in j_ipk.SCAL_IN[:j_ipk.N_FRC]}
    stress = {k: si[k] for k in j_ipk.STRESS_KEYS}
    out, st = jax.jit(lambda *a: j_impl.implsch(cfg, *a[:3], **a[3]))(
        jnp.asarray(fl), env, frc, stress)
    keys = j_ipk.SCAL_OUT_FULL if full else j_ipk.STRESS_KEYS
    rows = jnp.stack([st[k].astype(out.dtype) if k in st else
                      jnp.zeros_like(st["ufric"]) for k in keys])
    return (out, rows) + ((st["xllws"],) if full else ())


def reference_srl(cfg, f_srl, env2d, scal, tail, *, nang, nfre_red, full):
    """:func:`reference_chain` on SRL rows: (f_srl, rows, tail[, xllws])
    in the reference kernel's layout (without its lane pad)."""
    nfre, nsrl = cfg.tables.nfre, f_srl.shape[0]
    fl = np.concatenate([f_srl.reshape(nsrl, nang, nfre_red),
                         tail.reshape(nsrl, nang, nfre - nfre_red)], axis=2)
    res = reference_chain(cfg, fl.transpose(1, 2, 0), env2d, scal, full)
    out = np.asarray(res[0]).transpose(2, 0, 1)
    return ((out[:, :, :nfre_red].reshape(nsrl, -1), res[1],
             out[:, :, nfre_red:].reshape(nsrl, -1)) + tuple(res[2:]))


def _case(name, p):
    """(jax function of arrays, torch function of arrays, arrays)."""
    tb, par, e, f, s = p["tb"], p["cfg"].params, p["env"], p["frc"], \
        p["stress"]
    if name.startswith("wnfluxes"):
        kw = dict(lwamrsetci=name == "wnfluxes")
        args = (p["ssource"], e["cinv"], p["rho"], f["cicover"], p["phiwa"],
                p["em"], p["f1"], f["wswave"], f["wdwave"], s["ufric"],
                f["aird"])
        return (lambda *a: j_fluxes.wnfluxes(*a, tb, par, **kw),
                lambda *a: t_fluxes.wnfluxes(*a, tb, par, **kw), args)
    if name.startswith("stokestrn"):
        kw = dict(lstrn=name.endswith("lstrn"))
        args = (p["fl"], e["wavnum"], e["stokfac"], e["depth"], f["wswave"],
                f["wdwave"], f["cicover"], f["cithick"])
        return (lambda *a: j_stokes.stokestrn(*a, tb, **kw),
                lambda *a: t_stokes.stokestrn(*a, tb, **kw), args)
    if name == "femean":
        return (lambda a: j_means.femean(a, tb),
                lambda a: t_means.femean(a, tb), (p["fl"],))
    raise KeyError(name)


@pytest.mark.parametrize("name", ["wnfluxes", "wnfluxes_no_ice_adjustment",
                                  "stokestrn", "stokestrn_lstrn", "femean"])
def test_function_matches_reference_f64(prob, name):
    jf, tf, args = _case(name, prob)
    want = jax.jit(jf)(*(jnp.asarray(a, F64) for a in args))
    got = tf(*map(_t, args))
    if isinstance(want, dict):
        assert set(got) == set(want)
        pairs = [(k, got[k], want[k]) for k in want]
    else:
        pairs = [(i, g, w) for i, (g, w) in enumerate(zip(got, want))]
    for k, g, w in pairs:
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10,
                                   atol=0.0, err_msg=f"{name}[{k}]")


def test_full_chain_matches_reference_f64(prob):
    p = prob
    out_j, st_j = jax.jit(lambda f, e, fr, s: j_impl.implsch(
        p["cfg"], f, e, fr, **s))(
        jnp.asarray(p["fl"]), {k: jnp.asarray(v) for k, v in p["env"].items()},
        {k: jnp.asarray(v) for k, v in p["frc"].items()},
        {k: jnp.asarray(v) for k, v in p["stress"].items()})
    cfg_t = t_impl.make_physics_config(p["tb"], p["cfg"].params,
                                       idelt=p["cfg"].idelt)
    out_t, st_t = t_impl.implsch(
        cfg_t, _t(p["fl"]), {k: _t(v) for k, v in p["env"].items()},
        {k: _t(v) for k, v in p["frc"].items()},
        *(_t(p["stress"][k]) for k in t_ipk.STRESS_KEYS))
    scale = np.abs(np.asarray(out_j)).max()
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=1e-8,
                               atol=1e-14 * scale)
    # the port adds the cut's tie distance, the mask's margin and the
    # (zero) strain row
    assert set(st_t) == set(st_j) | {"frcut_tie", "xllws_margin", "strnms"}
    assert torch.equal(st_t["xllws"] != 0.0, st_t["xllws_margin"] > 0.0)
    assert set(t_ipk.SCAL_OUT_FULL) | {"xllws"} <= set(st_t)
    for k, v in st_j.items():
        np.testing.assert_allclose(st_t[k].numpy(), np.asarray(v),
                                   rtol=1e-8, atol=1e-14, err_msg=k)


def _srl(p, nfre_red):
    """SRL rows of the problem (a shuffled row map with duplicates) and
    the packed env/scalar rows, float64 numpy."""
    nang, nfre = p["tb"].nang, p["tb"].nfre
    src = np.random.default_rng(3).permutation(np.arange(NPTS + 32) % NPTS)
    rows3 = p["fl"].transpose(2, 0, 1)[src]
    f_srl = rows3[:, :, :nfre_red].reshape(len(src), -1)
    tail = rows3[:, :, nfre_red:].reshape(len(src), -1)
    env = {k: jnp.asarray(v[..., src]) for k, v in p["env"].items()}
    frc = {k: jnp.asarray(v[src]) for k, v in p["frc"].items()}
    st = {k: jnp.asarray(v[src]) for k, v in p["stress"].items()}
    env2d = np.asarray(j_ipk.pack_env(env, nfre, F64))
    scal = np.asarray(j_ipk.pack_scal(frc, st, env, len(src), F64))
    return src, f_srl, tail, env2d, scal


def _port_cfg(p, full):
    cfg = t_impl.make_physics_config(p["tb"], p["cfg"].params,
                                     idelt=p["cfg"].idelt)
    return cfg if full else t_ipk.minimal_config(cfg)


def _assert_full_rows(got, want, what):
    """Rows of SCAL_OUT_FULL at test_implsch_pallas.py's bounds."""
    st_g = t_ipk.unpack_scal_out(torch.as_tensor(got), full=True)
    st_w = j_ipk.unpack_scal_out(jnp.asarray(want), full=True)
    for k in t_ipk.SCAL_OUT_MIN:
        np.testing.assert_allclose(st_g[k].numpy(), np.asarray(st_w[k]),
                                   rtol=1e-6, atol=1e-12, err_msg=f"{what} {k}")
    np.testing.assert_array_equal(st_g["mij"].numpy(), np.asarray(st_w["mij"]))
    np.testing.assert_allclose(st_g["phiocd"].numpy(),
                               np.asarray(st_w["phiocd"]), rtol=1e-5,
                               atol=1e-9, err_msg=f"{what} phiocd")


def test_srl_full_matches_interpret_kernel(prob):
    p = prob
    nang, nfre, nred = p["tb"].nang, p["tb"].nfre, 20
    src, f_srl, tail, env2d, scal = _srl(p, nred)
    L, LT = nang * nred, nang * (nfre - nred)
    res = reference_srl(p["cfg"], f_srl, env2d, scal, tail, nang=nang,
                        nfre_red=nred, full=True)
    f_t, so_t, t_t, x_t = t_ipk.implsch_srl(
        _port_cfg(p, True), *map(_t, (f_srl, env2d, scal, tail)), nang=nang,
        nfre_red=nred, full=True)
    np.testing.assert_allclose(f_t.numpy(), np.asarray(res[0])[:, :L],
                               rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(t_t.numpy(), np.asarray(res[2])[:, :LT],
                               rtol=1e-6, atol=1e-12)
    _assert_full_rows(so_t.numpy(), res[1], "srl")
    np.testing.assert_array_equal(x_t.numpy(), np.asarray(res[3]))


def test_unpack_scal_out_round_trips(prob):
    p = prob
    src, f_srl, tail, env2d, scal = _srl(p, 20)
    _, so, _, _ = t_ipk.implsch_srl_plain(
        _port_cfg(p, True), *map(_t, (f_srl, env2d, scal, tail)),
        nang=p["tb"].nang, nfre_red=20, full=True)
    st = t_ipk.unpack_scal_out(so, full=True)
    assert tuple(st) == t_ipk.SCAL_OUT_FULL and st["mij"].dtype == torch.int64
    torch.testing.assert_close(t_ipk.pack_scal_out(st, full=True), so)
    assert float(st["strnms"].abs().max()) == 0.0


def test_full_errors_forgive_only_mask_flips_on_the_edge():
    """A differing windsea-mask bin is held out only where the float64
    margin puts it within the width of the mask's edge, and then only the
    rows that integrate the mask are zeroed at its point."""
    from ecwam_tpu_torch.model import cases
    n, keys = 4, t_ipk.SCAL_OUT_FULL
    want = torch.ones((len(keys), n), dtype=torch.float64)
    got = want.clone()
    for k in cases.MASK_FIELDS:
        got[keys.index(k), :2] += 0.5
    got[keys.index("ufric"), 0] += 0.5
    want_x = torch.zeros((2, 3, n))
    got_x = want_x.clone()
    got_x[0, 0, 0] = 1.0                  # on the edge
    got_x[1, 2, 1] = 1.0                  # off it
    margin = torch.full((2, 3, n), 0.7, dtype=torch.float64)
    margin[0, 0, 0], margin[1, 2, 1] = -1e-6, 0.3
    fe = cases.full_errors(got, want, got_x, want_x,
                           lambda pts: margin[..., pts], 1e-4)
    assert fe["edge"].tolist() == [1, 0, 0, 0]
    assert fe["off"].tolist() == [0, 1, 0, 0]
    assert fe["margin"].tolist() == [1e-6, 0.3, 0.0, 0.0]
    err = fe["err"]
    for k in cases.MASK_FIELDS:
        assert err[keys.index(k)].tolist() == [0.0, 0.5, 0.0, 0.0], k
    assert err[keys.index("ufric")].tolist() == [0.5, 0.0, 0.0, 0.0]
