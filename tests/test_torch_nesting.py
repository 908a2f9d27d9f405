"""The port's boundary nesting (``ecwam_tpu_torch.model.nesting``) against
the reference's (``ecwam_tpu/model/nesting.py``) and the f64 oracle
(``tests/oracle/nesting.py``), on the CPU in float64:

  * ROTSPEC, STRSPEC and INTSPEC (the zero-energy cases included) and the
    mean parameters against the reference functions at rtol 1e-12, and
    against the oracle at the tolerances of tests/test_nesting.py;
  * the MBOUNC/MBOUNF tables equal to the reference's;
  * the boundary file (npz) written by either package and read by the
    other: the same records, the same time interpolation;
  * the rim written in place (``put_points``: the SRL rows and tail of
    ``FastWaveModel``, the compact field of ``WaveModel``) equal to the
    compact ``apply_boundary``, the wrap slots after the next
    ``advect_srl`` included, and the next step equal to the round trip's;
  * the coarse side's ``take_points`` equal to the whole field's columns.
The CLI (the ``nesting:`` block and ``bouint``) is
tests/test_torch_nesting_cli.py.
"""

import numpy as np
import pytest
import torch

from ecwam_tpu.core import grid as j_grid
from ecwam_tpu.core import spectral as j_sp
from ecwam_tpu.model import nesting as jn
from ecwam_tpu_torch.core import grid as t_grid
from ecwam_tpu_torch.core import spectral as t_sp
from ecwam_tpu_torch.model import driver, nesting as tn, setup
from ecwam_tpu_torch.ops import propagation_fused as pfz
from tests.oracle import nesting as oref

from test_nesting import _spec

RTOL = 1e-12
START = "20230101000000"
RECT = (-24.0, 24.0, 60.0, 120.0)


@pytest.fixture(scope="module")
def tb():
    return t_sp.build_spectral_tables(12, 25)


def _t(a):
    return torch.as_tensor(a, dtype=torch.float64)


def _close(got, want, rtol=RTOL, atol=0.0, what=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                               err_msg=what)


@pytest.mark.parametrize("rthet", [0.0, 0.3, 2.1, -0.7, 5.9])
def test_rotspec(tb, rthet):
    f = _spec(tb, 1)
    got = tn.rotspec(_t(f), _t(np.full(f.shape[0], rthet)))
    assert got.dtype == torch.float64
    _close(got, jn.rotspec(f, np.full(f.shape[0], rthet)))
    for b in range(f.shape[0]):
        _close(got[b], oref.rotspec_ref(f[b], rthet))


@pytest.mark.parametrize("gamma", [1.0, 1.1, 1.1**2, 1.05, 0.95, 1.0 / 1.1,
                                   1.21001, 1.1**-3, 1.0 + 1e-13])
def test_strspec(tb, gamma):
    """Exact powers of the ratio (1.1, 1.21, 1/1.1, 1.1⁻³) sit on a bin
    edge of the truncated log10 ratio: the indices are the reference's."""
    f = _spec(tb, 2)
    got = tn.strspec(_t(f), _t(np.full(f.shape[0], gamma)), tb.fr)
    _close(got, jn.strspec(f, np.full(f.shape[0], gamma), tb.fr))
    for b in range(f.shape[0]):
        _close(got[b], oref.strspec_ref(f[b], gamma, np.asarray(tb.fr)),
               rtol=1e-10, atol=1e-13, what=f"gamma={gamma}")


def test_mean_params(tb):
    f = _spec(tb, 3)
    for got, want in zip(tn.mean_params(_t(f), tb), jn.mean_params(f, tb)):
        assert isinstance(got, torch.Tensor)
        _close(got, want)


def test_intspec(tb):
    f1, f2 = _spec(tb, 3), _spec(tb, 4)
    w2 = np.asarray([0.0, 0.25, 0.5, 0.75, 1.0])
    got = tn.intspec(_t(f1), _t(f2), w2, tb)
    want = jn.intspec(f1, f2, w2, tb)
    for g, w in zip(got, want):
        _close(g, w)
    em1, fm1, th1 = jn.mean_params(f1, tb)
    em2, fm2, th2 = jn.mean_params(f2, tb)
    for b in range(f1.shape[0]):
        fo, emo, fmo, tho = oref.intspec_ref(
            np.asarray(tb.fr), 1.0, w2[b], f1[b], fm1[b], em1[b], th1[b],
            f2[b], fm2[b], em2[b], th2[b])
        _close(got[0][b], fo, rtol=1e-10, atol=1e-13)
        _close([got[1][b], got[2][b], got[3][b]], [emo, fmo, tho],
               rtol=1e-10)
    # identical spectra interpolate to themselves
    out = tn.intspec(_t(f1), _t(f1), np.full(f1.shape[0], 0.37), tb)[0]
    _close(out, f1, rtol=1e-9, atol=1e-12)


def test_intspec_zero_energy_cases(tb):
    """The EM==0 branches (intspec.F90:120-160) on the stored means."""
    f = _spec(tb, 6)
    nb = f.shape[0]
    z = np.zeros_like(f)
    w2 = np.full(nb, 0.25)
    mz = (np.zeros(nb), np.full(nb, 0.1), np.zeros(nb))
    mf = jn.mean_params(f, tb)
    for a, b, ma, mb, want in ((z, f, mz, mf, 0.25 * f),
                               (f, z, mf, mz, 0.75 * f)):
        got = tn.intspec(_t(a), _t(b), w2, tb, means1=ma, means2=mb)
        ref = jn.intspec(a, b, w2, tb, means1=ma, means2=mb)
        _close(got[0], want)
        for g, r in zip(got, ref):
            _close(g, r)


def _grids(m):
    coarse = m.regular_grid(xdella=3.0)
    fine = m.regular_grid(xdella=1.0, amosop=-15.0, amonop=15.0)
    blocks = [m.build_sea_point_block(g, np.full((g.ngy, g.ngx), 4000.0))
              for g in (coarse, fine)]
    return coarse, fine, blocks


def test_boundary_tables_equal_reference():
    got, want = [], []
    for m, nm, out in ((t_grid, tn, got), (j_grid, jn, want)):
        coarse, fine, (cblk, fblk) = _grids(m)
        cb = nm.coarse_boundary(coarse, cblk, -15.0, 15.0, 30.0, 60.0)
        out += [cb, nm.fine_boundary(fine, fblk, cb)]
    for g, w in zip(got, want):
        for k in ("idx", "lat", "lon", "s", "ibfl", "ibfr", "bfw"):
            if hasattr(w, k):
                np.testing.assert_array_equal(getattr(g, k), getattr(w, k))
    assert got[0].rect == want[0].rect and got[1].idx.size > 10


def _records(tb, npts, seed=7):
    """Two dates of a field of ``npts`` points: shapes varying by point."""
    rng = np.random.default_rng(seed)
    base = _spec(tb, seed, 1)[0]
    f = base[..., None] * (0.5 + rng.random(npts))
    g = np.roll(base, 2, axis=0)[..., None] * (0.5 + rng.random(npts))
    return f, 2.0 * g


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_boundary_file_across_packages(tb, tmp_path, writer):
    """A file written by either package reads the same in both: records,
    means, and the INTSPEC time interpolation between them."""
    coarse, _, (cblk, _) = _grids(t_grid)
    cb = tn.coarse_boundary(coarse, cblk, -15.0, 15.0, 30.0, 60.0)
    fa, fb_ = _records(tb, cblk.nsea)
    path = str(tmp_path / "wam_boundary.npz")
    dates = ("20220101000000", "20220101060000")
    if writer == "port":
        wr = tn.BoundaryWriter(cb, tb)
        for d, f in zip(dates, (fa, fb_)):
            wr.add(d, _t(f)[..., torch.as_tensor(cb.idx.astype(np.int64))])
    else:
        wr = jn.BoundaryWriter(cb, j_sp.build_spectral_tables(12, 25))
        for d, f in zip(dates, (fa, fb_)):
            wr.add(d, f)
    wr.save(path)
    z = np.load(path)
    assert z["spec"].dtype == np.float32 and z["em"].dtype == np.float64
    bt = tn.BoundaryFile(path, tb, device="cpu")
    bj = jn.BoundaryFile(path, j_sp.build_spectral_tables(12, 25))
    np.testing.assert_array_equal(bt.dates, bj.dates)
    assert bt.spec.device.type == "cpu"
    np.testing.assert_array_equal(bt.coarse_boundary().s,
                                  bj.coarse_boundary().s)
    for d in dates + ("20220101030000", "20220101013000", "20211231000000",
                      "20220102000000"):
        (sg, mg), (sw, mw) = bt.at(d), bj.at(d)
        _close(sg, sw, what=d)
        for g, w in zip(mg, mw):
            _close(g, w, what=d)
    # the records' means, whoever wrote them, are the reference's
    want = jn.mean_params(np.moveaxis(fa[..., cb.idx], -1, 0), tb)
    for k, w in zip(("em", "fm", "thq"), want):
        _close(z[k][0], w, what=k)


def _nest(tb, device="cpu"):
    """A boundary file for the 6° grid's nest ``RECT``: a 12° port model's
    boundary points at its cold start and 4 steps later, 1 h apart."""
    ms = setup.build_model(grid_name="12.0", nang=12, nfre=25, pad_to=64,
                           idelpro=900.0, idelt=900.0, dtype=torch.float64,
                           device=device)
    m = driver.FastWaveModel(ms, driver.constant_wind_forcing(
        ms.n_real, 14.0, 0.7), START)
    cb = tn.coarse_boundary(ms.grid, ms.blk, *RECT)
    wr = tn.BoundaryWriter(cb, ms.tb)
    wr.add(START, m.take_points(cb.idx))
    whole = m.fl1
    np.testing.assert_array_equal(m.take_points(cb.idx),
                                  whole[..., cb.idx.astype(np.int64)])
    m.advance(4)
    wr.add("20230101010000", m.take_points(cb.idx))
    return wr


@pytest.fixture(scope="module")
def nest_file(tb, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("nest") / "wam_boundary.npz")
    _nest(tb).save(path)
    return path


def _fine(kind, nfre_red=None):
    ms = setup.build_model(grid_name="6.0", nang=12, nfre=25,
                           nfre_red=nfre_red, pad_to=64, idelpro=900.0,
                           idelt=900.0, dtype=torch.float64, device="cpu",
                           weights_mode="fused" if kind == "fast"
                           else "cached")
    cls = driver.FastWaveModel if kind == "fast" else driver.WaveModel
    return ms, (lambda: cls(ms, driver.constant_wind_forcing(
        ms.n_real, 9.0, 2.0), START))


@pytest.mark.parametrize("kind,nfre_red", [("fast", 20), ("fast", None),
                                           ("dense", None)])
def test_rim_in_place_equals_compact_apply_boundary(tb, nest_file, kind,
                                                    nfre_red):
    """The rim written in place equals the compact ``apply_boundary``
    through the round trip (the reference's ``model.fl1 =
    apply_boundary(model.fl1, …)``), and so does the next step."""
    ms, new = _fine(kind, nfre_red)
    bf = tn.BoundaryFile(nest_file, ms.tb, device="cpu")
    fb = tn.fine_boundary(ms.grid, ms.blk, bf.coarse_boundary())
    assert fb.idx.size > bf.lat.size
    a, b = new(), new()
    a.advance(1)
    b.advance(1)
    d14 = driver.format_date(a.date)             # 00:15, between records
    a.put_points(fb.idx, tn.boundary_spectra(bf, fb, d14))
    b.fl1 = tn.apply_boundary(b.fl1, bf, fb, d14)
    assert torch.equal(a.fl1, b.fl1)
    rim = a.take_points(fb.idx)
    assert bool(torch.isfinite(rim).all()) and float(rim.max()) > 0.0
    # the reference's apply_boundary on the same compact field
    jbf = jn.BoundaryFile(nest_file, j_sp.build_spectral_tables(12, 25))
    want = jn.apply_boundary(np.zeros((12, 25, ms.n_pad)), jbf, fb, d14)
    _close(rim, want[..., fb.idx], what="rim vs reference")
    if kind == "fast":
        # wrap slots: stale until the next advect_srl refreshes them from
        # the canonical rows, then equal to the round trip's
        tabs = a.fp.tabs
        refreshed = pfz.refresh_wraps(a._f_srl.clone(), tabs)
        wp = tabs["wrap_pos"]
        assert torch.equal(refreshed[wp], b._f_srl[wp])
        rows = a.fp.from_srl_pad
        assert torch.equal(refreshed[rows], b._f_srl[rows])
        assert bool(torch.isfinite(a._f_srl).all())
    a.advance(1)
    b.advance(1)
    assert torch.equal(a.fl1, b.fl1)
    for k in a.stress:
        assert torch.equal(a.stress[k], b.stress[k]), k


def test_apply_boundary_numpy_and_tensor(tb, nest_file):
    """``apply_boundary`` copies a numpy field and writes a tensor in
    place, as the reference's numpy and jax branches."""
    ms, _ = _fine("dense")
    bf = tn.BoundaryFile(nest_file, ms.tb, device="cpu")
    fb = tn.fine_boundary(ms.grid, ms.blk, bf.coarse_boundary())
    fl = np.ones((12, 25, ms.n_pad))
    out = tn.apply_boundary(fl, bf, fb, "20230101003000")
    assert np.all(fl == 1.0) and out is not fl
    t = torch.ones((12, 25, ms.n_pad), dtype=torch.float32)
    assert tn.apply_boundary(t, bf, fb, "20230101003000") is t
    np.testing.assert_array_equal(t.numpy(), out.astype(np.float32))
    mask = np.ones(ms.n_pad, bool)
    mask[fb.idx] = False
    assert np.all(out[..., mask] == 1.0)
