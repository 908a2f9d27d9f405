"""The port's output-product catalog against ``ecwam_tpu.io.products``.

Every non-train ``CATALOG`` field (aliases included) is evaluated by both
packages' ``compute`` on the same state made from a seed: a wind sea
with a crossing swell on a 12×25 spectrum over 96 points with depths
from 3 to 999 m, the stress/flux/Stokes state, ice on some points, and
either no windsea mask (the step-0 output) or a random one.  In float64
every field agrees to 1e-10 of its largest magnitude; in float32 to
F32_TOL of it at every point (none of these points lies on one of the
float32 decision edges that ``extremes.kurtosis_margins`` and
``products.pp1d_margin`` measure for the card's hold-outs).  Also: the chunked
path equals the whole-field path (``test_full_chunked.py::
test_chunked_products_match_whole_field``), ``wdw`` goes through
``wdirspread``'s integrated (LLPEAKF false) form, ``msqs``/``msqs_mod``
through ``gc.meansqs``, and the swell-train fields raise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecwam_tpu.core import dispersion as j_disp
from ecwam_tpu.core import physparams as j_pp
from ecwam_tpu.core.spectral import build_spectral_tables as j_tables
from ecwam_tpu.io import products as j_products
from ecwam_tpu.model import preset as j_preset
from ecwam_tpu.ops.physics import gc as j_gc
from ecwam_tpu_torch.core import physparams as t_pp
from ecwam_tpu_torch.core.spectral import build_spectral_tables as t_tables
from ecwam_tpu_torch.io import extremes as t_extremes
from ecwam_tpu_torch.io import products as t_products
from ecwam_tpu_torch.ops.physics import gc as t_gc

NANG, NFRE, NPTS = 12, 25, 96
F64_TOL = 1e-10
F32_TOL = 2e-5         # of each field's largest magnitude
FIELDS = sorted(n for n in t_products.CATALOG
                if n not in t_products.TRAIN_FIELDS)
STATE_KEYS = ("ufric", "tauw", "tauwdir", "z0m", "z0b", "chrnck", "ustokes",
              "vstokes", "phieps", "phiaw", "tauoc", "tauxd", "tauyd",
              "tauocxd", "tauocyd", "phiocd")


def problem(xllws: bool):
    """(tb, fl1, state, frc, env) as float64 numpy, from seed 11."""
    rng = np.random.default_rng(11)
    tb = j_tables(nang=NANG, nfre=NFRE)
    u10 = rng.uniform(4.0, 22.0, NPTS)
    wd = rng.uniform(0.0, 2.0 * np.pi, NPTS)
    fl1 = np.asarray(j_preset.mstart(tb, u10, wd), np.float64)
    # a swell crossing the wind sea at 90°-180°, of random height
    th = np.asarray(tb.th)[:, None, None]
    fr = np.asarray(tb.fr)[None, :, None]
    sdir = wd + rng.uniform(0.5 * np.pi, np.pi, NPTS)
    swell = (rng.uniform(0.0, 3.0, NPTS)
             * np.exp(-((fr - 0.07) / 0.01) ** 2)
             * np.maximum(np.cos(th - sdir), 0.0) ** 8)
    fl1 = fl1 * rng.uniform(0.8, 1.2, fl1.shape) + swell
    depth = np.concatenate([rng.uniform(3.0, 40.0, NPTS // 3),
                            rng.uniform(40.0, 999.0, NPTS - NPTS // 3)])
    props = j_disp.depth_properties(depth, tb.fr)
    env = {k: np.asarray(v, np.float64).T.copy() for k, v in props.items()}
    env["depth"] = depth
    ufric = 0.035 * u10 + rng.uniform(-0.02, 0.02, NPTS)
    state = {k: rng.uniform(0.1, 1.0, NPTS) for k in STATE_KEYS}
    state.update(ufric=ufric, tauw=0.8 * ufric**2,
                 z0b=rng.uniform(1e-5, 1e-3, NPTS),
                 chrnck=rng.uniform(0.008, 0.03, NPTS),
                 phiocd=rng.uniform(-2.0, 0.5, NPTS),
                 ustokes=rng.normal(0.0, 0.1, NPTS),
                 vstokes=rng.normal(0.0, 0.1, NPTS))
    if xllws:
        state["xllws"] = (rng.random(fl1.shape) < 0.4).astype(np.float64)
    ice = rng.random(NPTS) < 0.2
    frc = dict(wswave=u10, wdwave=wd, aird=rng.uniform(1.1, 1.3, NPTS),
               wstar=rng.uniform(0.0, 1.0, NPTS),
               cicover=np.where(ice, rng.uniform(0.0, 1.0, NPTS), 0.0),
               cithick=np.where(ice, rng.uniform(0.1, 2.0, NPTS), 0.0))
    return tb, fl1, state, frc, env


def _torch(d, dtype):
    return {k: torch.tensor(v, dtype=dtype) for k, v in d.items()}


def _jax(d, dtype):
    return {k: jnp.asarray(v, dtype) for k, v in d.items()}


def both(xllws: bool, dtype, names=FIELDS, llgcbz0=False):
    """(reference, port) fields as float64 numpy, and the problem."""
    tb, fl1, state, frc, env = problem(xllws)
    jd = {torch.float64: jnp.float64, torch.float32: jnp.float32}[dtype]
    want = j_products.compute(
        list(names), jnp.asarray(fl1, jd), tb, _jax(state, jd),
        _jax(frc, jd), j_pp.set_phys_params(1, nang=NANG, llgcbz0=llgcbz0),
        env=_jax(env, jd), llgcbz0=llgcbz0)
    ttb = t_tables(nang=NANG, nfre=NFRE)
    got = t_products.compute(
        list(names), torch.tensor(fl1, dtype=dtype), ttb,
        _torch(state, dtype), _torch(frc, dtype),
        t_pp.set_phys_params(1, nang=NANG, llgcbz0=llgcbz0),
        env=_torch(env, dtype), llgcbz0=llgcbz0)
    want = {n: np.asarray(v, np.float64) for n, v in want.items()}
    got = {n: v.double().numpy() for n, v in got.items()}
    return want, got, (ttb, fl1, env)


def _rel(a, b):
    return np.abs(a - b) / max(np.abs(b).max(), 1e-300)


@pytest.mark.parametrize("xllws", [False, True], ids=["step0", "mask"])
def test_catalog_matches_reference_f64(xllws):
    want, got, _ = both(xllws, torch.float64)
    assert set(got) == set(FIELDS)
    for n in FIELDS:
        assert got[n].shape == (NPTS,), n
        np.testing.assert_array_less(_rel(got[n], want[n]), F64_TOL,
                                     err_msg=n)


def test_catalog_gc_closure_f64():
    """``cdww`` under LLGCBZ0 and the mean-square slopes."""
    names = ["cdww", "msqs", "msqs_mod", "mss"]
    want, got, _ = both(True, torch.float64, names, llgcbz0=True)
    for n in names:
        np.testing.assert_array_less(_rel(got[n], want[n]), F64_TOL,
                                     err_msg=n)


@pytest.mark.parametrize("xllws", [False, True], ids=["step0", "mask"])
def test_catalog_matches_reference_f32(xllws):
    want, got, _ = both(xllws, torch.float32)
    for n in FIELDS:
        np.testing.assert_array_less(_rel(got[n], want[n]), F32_TOL,
                                     err_msg=n)


def test_decision_margins():
    """The float64 margins the card's hold-outs read: one per point,
    non-negative, and zero where a point sits on the edge."""
    _, fl1, _, _, env = problem(False)
    ttb = t_tables(nang=NANG, nfre=NFRE)
    fl = torch.tensor(fl1)
    m = t_extremes.kurtosis_margins(fl, torch.tensor(env["depth"]), ttb)
    m["pp1d"] = t_products.pp1d_margin(fl, ttb)
    for k, v in m.items():
        assert v.shape == (NPTS,) and bool((v >= 0.0).all()), k
    # a bin at exactly a tenth of its point's maximum is on PP1D's edge
    fl[0, 3, 0] = 0.1 * fl[..., 0].max()
    assert float(t_products.pp1d_margin(fl, ttb)[0]) == 0.0


def test_wdw_is_the_integrated_spread():
    tb, fl1, _, _, _ = problem(False)
    ttb = t_tables(nang=NANG, nfre=NFRE)
    fl = torch.tensor(fl1)
    em = t_products.means_mod.femean(fl, ttb)[0]
    integ = t_products.wdirspread(fl, em, ttb, llpeakf=False).numpy()
    peak = t_products.wdirspread(fl, em, ttb).numpy()
    want = np.asarray(j_products.wdirspread(
        jnp.asarray(fl1), j_products.means_mod.femean(jnp.asarray(fl1),
                                                      tb)[0],
        tb, llpeakf=False))
    np.testing.assert_array_less(_rel(integ, want), F64_TOL)
    assert not np.allclose(integ, peak)
    assert ((integ >= 0.0) & (integ <= np.sqrt(2.0) + 1e-12)).all()


@pytest.mark.parametrize("xkmss", ["gc", "model"])
def test_meansqs_matches_reference(xkmss):
    tb, fl1, state, frc, env = problem(False)
    ttb = t_tables(nang=NANG, nfre=NFRE)
    cut = (float(j_gc.gc_tables().xk[-1]) if xkmss == "gc"
           else float((2.0 * np.pi * tb.fr[-1]) ** 2 / 9.806))
    params = j_pp.set_phys_params(1, nang=NANG)
    cosw = np.cos(np.asarray(tb.th)[:, None] - frc["wdwave"][None, :])
    want = np.asarray(j_gc.meansqs(
        cut, jnp.asarray(fl1), jnp.asarray(env["wavnum"]),
        jnp.asarray(state["ufric"]), jnp.asarray(cosw), tb, params))
    got = t_gc.meansqs(cut, torch.tensor(fl1), torch.tensor(env["wavnum"]),
                       torch.tensor(state["ufric"]), torch.tensor(cosw), ttb,
                       t_pp.set_phys_params(1, nang=NANG)).numpy()
    np.testing.assert_array_less(_rel(got, want), F64_TOL)
    # the gravity-capillary part and the resolved part both contribute
    assert (got > 0.0).all()


@pytest.mark.parametrize("chunk", [16, 40])
def test_chunked_matches_whole_field(chunk):
    """compute_chunked over column views equals compute to 1e-12 in
    float64 (the chunks need not divide the point count; a reduction may
    be vectorised otherwise over fewer columns), with a second-order
    stand-in applied per chunk."""
    tb, fl1, state, frc, env = problem(True)
    ttb = t_tables(nang=NANG, nfre=NFRE)
    params = t_pp.set_phys_params(1, nang=NANG)
    fl = torch.tensor(fl1)
    st, fr, en = (_torch(d, torch.float64) for d in (state, frc, env))
    st["sep"] = t_products.sepwisw(fl, st.pop("xllws"), en["cinv"],
                                   st["ufric"], fr["wswave"], fr["wdwave"],
                                   ttb)
    so = lambda f, e: f * (1.0 + 0.01 * e["depth"] / 1000.0)
    whole = t_products.compute(FIELDS, so(fl, en), ttb, st, fr, params,
                               env=en)
    got = t_products.compute_chunked(
        FIELDS, lambda s, n: fl[..., s:s + n], NPTS, ttb, st, fr, params,
        env=en, chunk=chunk, so_correct=so)
    for n in FIELDS:
        assert got[n].shape == (NPTS,), n
        np.testing.assert_allclose(got[n].numpy(), whole[n].numpy(),
                                   rtol=1e-12, atol=1e-300, err_msg=n)


def test_swell_trains_raise():
    """The trains need the per-bin swell mask: a state of the chunked
    full-mode step (per-point ``sep`` rows, no windsea mask) refuses them,
    as does the chunked output path, as in the reference."""
    tb, fl1, state, frc, env = problem(False)
    ttb = t_tables(nang=NANG, nfre=NFRE)
    st = _torch(state, torch.float64)
    st["sep"] = {"esea": torch.zeros(NPTS, dtype=torch.float64)}
    args = (torch.tensor(fl1), ttb, st,
            _torch(frc, torch.float64), t_pp.set_phys_params(1, nang=NANG))
    with pytest.raises(NotImplementedError, match="per-bin swell mask"):
        t_products.compute(["swh", "p042"], *args,
                           env=_torch(env, torch.float64))
    with pytest.raises(NotImplementedError, match="chunked"):
        t_products.compute_chunked(["p045"], None, NPTS, *args[1:])
    assert t_products.TRAIN_FIELDS == j_products.TRAIN_FIELDS
    assert set(t_products.CATALOG) == set(j_products.CATALOG)
