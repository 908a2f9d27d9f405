"""Plain-torch SRL advection against ``ecwam_tpu``'s XLA formulation.

The same compact spectrum (numpy, from a seed) goes through
``ecwam_tpu`` ``FusedPropagation(backend="xla").advect_srl`` and the
port's ``FusedPropagation.advect_srl`` on the configurations of
tests/test_fused_pallas.py (basic, fast-wave sub-band ifrelfmax=5,
depth refraction irefra=1).  float64 at rtol 1e-10; float32 at
test_fused_pallas's rtol 2e-6 / atol 1e-8.  The CUDA kernel is held
against the plain version in tests/test_torch_gpu.py.

Kernel A's tables (``ops/propagation_rebase.py``) against the reference's
Pallas pack (``ecwam_tpu/ops/propagation_pallas.py: pack_tables``) on the
golden, shallow and currents grids: the rebase offsets, extents, window
bases and shifted taps exactly; the plain pass from the rebased tables
against it from the original ones (float64, 1e-12 of max, the CFL mask
equal); the all-open-water flag against the reference's detection.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ecwam_tpu.model import setup as jsetup
from ecwam_tpu.model.fusedstep import FusedPropagation as JFused
from ecwam_tpu.ops import propagation_pallas as jpk
from ecwam_tpu_torch.model import cases
from ecwam_tpu_torch.model import setup as tsetup
from ecwam_tpu_torch.model.fusedstep import FusedPropagation
from ecwam_tpu_torch.ops import propagation_cuda as pcu
from ecwam_tpu_torch.ops import propagation_fused as pfz
from ecwam_tpu_torch.ops import propagation_rebase as prb
from test_torch_gpu import ADVECT_CONFIGS, advect_kw, jonswap


def _advect_both(name, jdt, tdt):
    kw = advect_kw(name)
    ms_j = jsetup.build_model(dtype=jdt, weights_mode="fused", **kw)
    ms_t = tsetup.build_model(dtype=tdt, device="cpu", **kw)
    f = jonswap(ms_j.n_pad, ms_j.tb)
    fx = JFused(ms_j, backend="xla")
    want = fx.from_srl(
        fx.advect_srl(fx.to_srl(jnp.asarray(f, jdt), fx.bundle), fx.bundle),
        fx.bundle)
    fp = FusedPropagation(ms_t)
    got = fp.from_srl(fp.advect_srl(fp.to_srl(torch.as_tensor(f, dtype=tdt))))
    n = ms_j.n_real
    return got.numpy()[..., :n], np.asarray(want)[..., :n]


@pytest.mark.parametrize("name", sorted(ADVECT_CONFIGS))
def test_advect_srl_matches_reference_f64(name):
    got, want = _advect_both(name, jnp.float64, torch.float64)
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=0.0)


@pytest.mark.parametrize("name", sorted(ADVECT_CONFIGS))
def test_advect_srl_matches_reference_f32(name):
    got, want = _advect_both(name, jnp.float32, torch.float32)
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-8)


def test_compact_advect_keeps_unadvected_tail():
    ms = tsetup.build_model(grid_name="6.0", nang=12, nfre=10, nfre_red=8,
                            idelpro=900.0, idelt=900.0, pad_to=64,
                            dtype=torch.float64, device="cpu")
    fp = FusedPropagation(ms)
    f = torch.as_tensor(jonswap(ms.n_pad, ms.tb))
    out = fp.advect(f)
    assert out.shape == f.shape
    torch.testing.assert_close(out[:, 8:], f[:, 8:], rtol=0, atol=0)
    assert torch.isfinite(out).all()


# ---------------------------------------------------------------------------
# kernel A's rebased taps and obstruction flag against the reference's pack
# ---------------------------------------------------------------------------

REBASE_CONFIGS = {
    "golden": cases.golden_kw,
    "shallow": cases.shallow_kw,
    "currents": lambda: cases.currents_kw(3, cfl=True),
}


def _reference_pack(kw):
    """The reference's Pallas table pack (``propagation_pallas.pack_tables``
    through its FusedPropagation) and its FusedTables, float64."""
    ms_j = jsetup.build_model(dtype=jnp.float64, weights_mode="fused", **kw)
    fx = JFused(ms_j, backend="pallas")
    return ms_j.fused, {k: np.asarray(v) for k, v in fx.bundle["pk"].items()}


@pytest.mark.parametrize("name", sorted(REBASE_CONFIGS))
def test_rebased_taps_match_reference_pack(name):
    """lo, extents, rebased window bases and shifted taps equal the
    reference's ``_rebase_taps``/``_shift_taps`` as its pack applies them,
    and its packed tables."""
    kw = REBASE_CONFIGS[name]()
    ft_j, pk = _reference_pack(kw)
    ft = tsetup.build_model(dtype=torch.float64, device="cpu", **kw).fused
    rb = prb.rebase(ft)
    S, nseg, nsrl = ft.S, ft.nseg, ft.nsrl
    body = slice(1, nseg + 1)
    ew2 = pk["ewtok"].shape[0]
    assert rb.ew2 == ew2
    for side, (base, taps) in enumerate(((ft_j.dn_base, ft_j.taps_dn),
                                         (ft_j.up_base, ft_j.taps_up))):
        full = np.zeros(nsrl // S, np.int64)
        full[body] = base
        lo, ext = jpk._rebase_taps(np.asarray(taps), full, S)
        np.testing.assert_array_equal(rb.lo[:, side], lo[body])
        np.testing.assert_array_equal(rb.ext[:, side], ext[body])
        np.testing.assert_array_equal(
            (rb.dn_base, rb.up_base)[side],
            (pk["dn_full"], pk["up_full"])[side][body])
        np.testing.assert_array_equal(
            (rb.taps_dn, rb.taps_up)[side],
            jpk._shift_taps(np.asarray(taps), lo, S, ew2))
    # the pack folds the shifted taps into ptab's free columns
    packed = pk["ptab"][:, jpk.PT_TAPS:jpk.PT_TAPS + 6 * ew2]
    np.testing.assert_array_equal(packed[:, :3 * ew2],
                                  rb.taps_dn.reshape(nsrl, -1))
    np.testing.assert_array_equal(packed[:, 3 * ew2:],
                                  rb.taps_up.reshape(nsrl, -1))
    # the kernel's columns: [lat, corE, corW, 0] per side and column
    kt = prb.kernel_tables(rb, torch.float64, "cpu")
    k = kt["ktaps"].numpy()
    np.testing.assert_array_equal(k[:, 0, :, :3],
                                  np.swapaxes(rb.taps_dn, 1, 2))
    np.testing.assert_array_equal(k[:, 1, :, :3],
                                  np.swapaxes(rb.taps_up, 1, 2))
    assert not k[..., 3].any()
    np.testing.assert_array_equal(kt["kseg"].numpy(),
                                  np.concatenate([rb.lo, rb.ext], axis=1))


@pytest.mark.parametrize("name", sorted(REBASE_CONFIGS))
def test_plain_advect_same_from_rebased_tables(name):
    """The plain pass from the rebased windows and taps (width ew2) equals
    it from the original ones (width EW), float64, with the CFL mask and
    the CHECKCFL maxima."""
    ms = tsetup.build_model(dtype=torch.float64, device="cpu",
                            **REBASE_CONFIGS[name]())
    fp = FusedPropagation(ms)
    rb = prb.rebase(ms.fused)
    f = fp.to_srl(torch.as_tensor(jonswap(ms.n_pad, ms.tb)))
    f = pfz.refresh_wraps(f, fp.tabs)
    kw = dict(nang=fp.nang, nf=fp.nfre_red, S=ms.fused.S,
              irefra=ms.irefra, with_cfl="stats")
    want = pcu.advect_plain(f, fp.tabs, fp.lc, EW=ms.fused.EW, **kw)
    tabs = dict(fp.tabs, dn_base=torch.as_tensor(rb.dn_base),
                up_base=torch.as_tensor(rb.up_base),
                taps_dn=torch.as_tensor(rb.taps_dn),
                taps_up=torch.as_tensor(rb.taps_up))
    got = pcu.advect_plain(f, tabs, fp.lc, EW=rb.ew2, **kw)
    assert rb.ew2 < ms.fused.EW
    scale = float(want[0].abs().max())
    assert float((got[0] - want[0]).abs().max()) <= 1e-12 * scale
    assert torch.equal(got[1], want[1])
    for g, w in zip(got[2], want[2]):
        assert abs(float(g) - float(w)) <= 1e-12 * max(abs(float(w)), 1.0)


@pytest.mark.parametrize("name", ["golden", "open"])
def test_obs_flag_matches_reference(name):
    """All-open water (the kernel reads no obstruction table) as the
    reference's pack detects it: its obstruction table is then a token."""
    kw = cases.golden_kw() if name == "golden" else advect_kw("basic")
    _, pk = _reference_pack(kw)
    ref_ones = pk["obs"].shape == (8, 128) and not pk["obs"].any()
    ft = tsetup.build_model(dtype=torch.float64, device="cpu", **kw).fused
    assert prb.obs_ones(ft.obs) == ref_ones == (name == "open")
    fp_tabs = FusedPropagation(
        tsetup.build_model(dtype=torch.float64, device="cpu", **kw)).tabs
    assert fp_tabs["obs_ones"] == ref_ones
