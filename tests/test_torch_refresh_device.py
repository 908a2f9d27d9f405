"""The hourly current refresh on the model's device, on the CPU.

``FusedPropagation.refresh`` forms GRADI's current gradients in float64
on the model's device (``ops/propagation.gradi_rows`` on a stencil
gathered to the SRL rows) in place of the host's ``ops/propagation.gradi``,
which stays as the oracle:

  * GRADI's current gradients on tensors equal the host's to the bit (the
    host's at irefra 2 and 3), on O24 (aqua planet: land only past the
    polar rows) and on the golden grid (land and a shoal), with currents
    that make every branch count: land neighbours, neighbours with
    (u, v) == (0, 0) (land for the current gradients) and gradients past
    the clip at CURRENT_GRADIENT_MAX·cosφ.  Both run the same float64
    operations in the same order, so no tolerance is needed;
  * the ``uv`` and ``grads`` tables and the CFL mask equal the host path
    the refresh replaced (``cases.host_refresh``), float32 tables
    included: each is the same float64 number rounded once to float32,
    so the tables are equal to the bit (one float32 rounding apart is
    what the card test allows); the CFL retry bites on
    ``cases.currents_kw(cfl=True)``;
  * with depth refraction alone (irefra 1) the gradients are set once and
    a refresh changes nothing; the refresh of currents given as tensors
    makes no host GRADI and no host upload;
  * two forcing hours of ``FastWaveModel`` with currents, the cycle-49
    switches and polar ice (the benchmark's ``o320_cy49r2`` configuration
    at O24) against ``wavebench.reference.model.Reference``, followed
    stage by stage from the model's own state: after each NEWWIND the
    refraction tables equal the reference's (its frozen host GRADI) to
    the bit, and after each hour's steps the spectrum and the stress
    fields agree within STATE_RTOL of each field's largest value.
"""

import numpy as np
import pytest
import torch

from ecwam_tpu_torch import tracing
from ecwam_tpu_torch.model import cases
from ecwam_tpu_torch.model import driver as tdrv
from ecwam_tpu_torch.model import setup as tsetup
from ecwam_tpu_torch.model.fusedstep import FusedPropagation
from ecwam_tpu_torch.ops import propagation as prop

# the port's plain path against the benchmark's frozen copy of it, both
# float32 on the CPU over one forcing hour: the same algebra, so the
# spectrum and stress agree to a few float32 roundings of each field's
# largest value (read: 0 on O24); well below the bfloat16 state's 4e-3
STATE_RTOL = 1e-6
O24 = dict(grid_name="O24", nang=12, nfre=14, nfre_red=12, idelpro=900.0,
           idelt=1800.0, pad_to=64)


def _grid(name: str, irefra: int) -> dict:
    if name == "golden":
        return cases.golden_kw(irefra=irefra)
    return dict(O24, irefra=irefra)


def _currents(n: int, seed: int = 5):
    """0.35·N(0, 1) m/s in u and v, every 7th point still (u = v = 0:
    land for the current gradients), every 11th point's u 60 times
    stronger (its gradients pass the clip)."""
    rng = np.random.default_rng(seed)
    u, v = 0.35 * rng.standard_normal((2, n))
    u[::7] = v[::7] = 0.0
    u[3::11] *= 60.0
    return u, v


@pytest.mark.parametrize("irefra", [2, 3])
@pytest.mark.parametrize("grid", ["O24", "golden"])
def test_device_gradi_equals_host_gradi(grid, irefra):
    ms = tsetup.build_model(device="cpu", **_grid(grid, irefra))
    st = ms.stencil
    n = st.klon.shape[0]
    u, v = (np.append(a, 0.0) for a in _currents(n))
    want = prop.gradi(st, ms.fused_env["depth_ext"], u, v, irefra)
    gs = prop.gradi_stencil(st, np.arange(n + 1), "cpu")
    got = prop.gradi_rows(gs, torch.as_tensor(u), torch.as_tensor(v))
    assert set(got) == {"duphi", "dvphi", "dulam", "dvlam"}
    for k, g in got.items():
        w = torch.as_tensor(np.append(want[k], 0.0))
        assert torch.equal(g, w), k
    # every branch counts: land neighbours, still neighbours, the clip
    assert bool(gs.land[:, :n].any())
    idx = gs.idx.long()[:, :n]
    still = (torch.as_tensor(u)[idx] == 0) & (torch.as_tensor(v)[idx] == 0)
    assert bool((still & ~gs.land[:, :n]).any())
    clipped = got["dulam"][:n].abs() == gs.cgmax[:n]
    assert 0 < int(clipped.sum()) < n


@pytest.mark.parametrize("case", ["golden2", "golden3", "cfl3"])
def test_refresh_tables_equal_the_host_path(case):
    if case == "cfl3":
        kw = cases.currents_kw(3, cfl=True)
        u, v = kw["currents"]
        rng = np.random.default_rng(9)
        u, v = u * (0.8 + 0.4 * rng.random(u.size)), v[::-1].copy()
    else:
        kw = cases.golden_kw(irefra=int(case[-1]), currents=True)
        u, v = _currents(kw["currents"][0].size)
    ms = tsetup.build_model(device="cpu", **kw)
    fp = FusedPropagation(ms)
    r = cases.refresh_vs_host(fp, tsetup.pad_point_field(ms, u),
                              tsetup.pad_point_field(ms, v))
    assert r["uv_off"] == r["grads_off"] == 0, r
    assert r["uv_gap"] == r["grads_gap"] == 0.0, r
    assert r["mask_differ"] == 0, r
    if case == "cfl3":
        assert 0 < r["masked"] < ms.fused.nsrl
    assert tracing.report()["counters"]["cfl_dropped_rows"] == r["masked"]


def test_depth_refraction_is_set_once():
    ms = tsetup.build_model(device="cpu", **cases.golden_kw(irefra=1))
    fp = FusedPropagation(ms)
    n = ms.n_pad
    zero = np.zeros(n)
    g = prop.gradi(ms.stencil, ms.fused_env["depth_ext"], np.append(zero, 0),
                   np.append(zero, 0), 1)
    dco = np.asarray(ms.stencil.cosphm1_pt, np.float64)
    want = np.zeros((n + 1, 8))
    want[:-1, 0], want[:-1, 1] = g["ddphi"], g["ddlam"] * dco
    want = torch.as_tensor(want[np.asarray(ms.fused.srl_src)],
                           dtype=ms.dtype)
    assert torch.equal(fp.tabs["grads"], want)
    before = fp.tabs["grads"].clone()
    fp.refresh(*_currents(n))
    assert torch.equal(fp.tabs["grads"], before)
    assert fp.cfl_bad is None and "uv" not in fp.tabs


def test_refresh_of_tensors_stays_off_the_host(monkeypatch):
    kw = cases.golden_kw(irefra=3, currents=True)
    ms = tsetup.build_model(device="cpu", **kw)
    fp = FusedPropagation(ms)
    u, v = (torch.as_tensor(tsetup.pad_point_field(ms, a), dtype=ms.dtype)
            for a in _currents(ms.n_real))
    fp.refresh(u, v)
    want = {k: fp.tabs[k].clone() for k in ("uv", "grads")}
    fp.refresh()

    def host(*a, **k):
        raise AssertionError("host work inside refresh")
    monkeypatch.setattr(prop, "gradi", host)
    monkeypatch.setattr(FusedPropagation, "_t", host)
    fp.refresh(u, v)
    for k, w in want.items():
        assert torch.equal(fp.tabs[k], w), k


def test_two_hours_follow_the_reference(tmp_path):
    from wavebench import forcing as forcing_mod
    from wavebench.reference.model import Reference
    from wavebench.tests.tiny import CURRENTS
    bk = dict(O24, irefra=2, llgcbz0=True, llnormagam=True)
    lat, lon = forcing_mod.point_latlon(bk)
    frc = forcing_mod.Forcing(CURRENTS, lat, lon, 2**33 + 17, 3600.0)
    ms = tsetup.build_model(**bk, currents=frc.currents0(), device="cpu")
    m = tdrv.FastWaveModel(ms, frc.provider, forcing_mod.START)
    ref = Reference(bk, "cpu", cache_dir=str(tmp_path),
                    currents=frc.currents0())
    k_steps, n = 4, ms.n_real
    m.advance(k_steps)
    for hour in (1, 2):
        ref.put_state(m.fl1, m.stress)
        m.newwind(m.date)
        ref.newwind(frc.fields(hour))
        assert frc.period(tdrv.format_date(m.date)) == hour
        for k in ("uv", "grads"):
            assert torch.equal(m.fp.tabs[k], ref.fp.tabs[k]), (hour, k)
        assert torch.equal(m.fp.cfl_bad, ref.fp.cfl_bad)
        m.advance(k_steps)
        ref.advance(k_steps)
        pairs = [("fl1", m.fl1, ref.fl1())]
        pairs += [(k, m.stress[k], ref.stress()[k]) for k in m.stress]
        for k, got, want in pairs:
            got, want = got[..., :n], want[..., :n]
            gap = float((got - want).abs().max() / want.abs().max())
            assert gap <= STATE_RTOL, (hour, k, gap)
