"""The port's model build against ``ecwam_tpu``'s, table by table.

``ecwam_tpu_torch.model.setup.build_model`` carries the numpy builders
(stencil, fused SRL tables, DIA tables) out of JAX modules; on the 6°
aqua grid and on the golden-trajectory topo grid every table must equal
the reference's: index arrays exactly, float arrays within rtol 1e-12
(float64 builds).  ``setup_from_arrays`` must hand the reference's
tables over unchanged.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ecwam_tpu.model import setup as jsetup
from ecwam_tpu_torch.model import setup as tsetup
from ecwam_tpu_torch.model.cases import golden_kw

RTOL = 1e-12


CONFIGS = {
    "6deg": lambda: dict(grid_name="6.0", nang=12, nfre=25, idelpro=900.0,
                         idelt=900.0, pad_to=64),
    "golden_topo": golden_kw,
}


def _both(name):
    kw = CONFIGS[name]()
    ms_j = jsetup.build_model(dtype=jnp.float64, weights_mode="fused", **kw)
    ms_t = tsetup.build_model(dtype=torch.float64, device="cpu", **kw)
    return ms_j, ms_t


def _same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, what
    if np.issubdtype(a.dtype, np.floating):
        np.testing.assert_allclose(b, a, rtol=RTOL, atol=0.0, err_msg=what)
    else:
        np.testing.assert_array_equal(b, a, err_msg=what)


def _compare_tables(ms_j, ms_t):
    for obj in ("stencil", "fused"):
        tj, tt = getattr(ms_j, obj), getattr(ms_t, obj)
        for f in dataclasses.fields(tj):
            _same(getattr(tj, f.name), getattr(tt, f.name), f"{obj}.{f.name}")
    for k, v in ms_j.fused_env.items():
        _same(v, ms_t.fused_env[k], f"fused_env.{k}")
    for k in ("wavnum", "cinv", "cgroup", "xk2cg", "omosnh2kd", "stokfac",
              "depth", "emaxdpt"):
        for key in (k, k + "_ext"):
            _same(ms_j.env[key], ms_t.env[key].numpy(), f"env.{key}")
    pj, pt = ms_j.phys, ms_t.phys
    for f in ("sat_indices", "sat_weights", "wtauhf"):
        _same(getattr(pj, f), getattr(pt, f), f"phys.{f}")
    # the port's own copy of the PhysParams class: compare field by field
    assert pj.x0tauhf == pt.x0tauhf
    assert dataclasses.asdict(pj.params) == dataclasses.asdict(pt.params)
    for f in dataclasses.fields(pj.dia):
        _same(getattr(pj.dia, f.name), getattr(pt.dia, f.name),
              f"dia.{f.name}")
    for f in ("n_real", "n_pad", "idelpro", "idelt", "delpro_lf",
              "ifrelfmax", "irefra"):
        assert getattr(ms_j, f) == getattr(ms_t, f), f


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_build_model_tables_match_reference(name):
    _compare_tables(*_both(name))


def _arrays(ms_j):
    """A reference ModelSetup's tables and env as host numpy."""
    return dict(
        grid=ms_j.grid, blk=ms_j.blk, tb=ms_j.tb, params=ms_j.phys.params,
        stencil={f.name: getattr(ms_j.stencil, f.name)
                 for f in dataclasses.fields(ms_j.stencil)},
        fused={f.name: getattr(ms_j.fused, f.name)
               for f in dataclasses.fields(ms_j.fused)},
        env={k: np.asarray(v) for k, v in ms_j.env.items()},
        n_real=ms_j.n_real, n_pad=ms_j.n_pad, idelpro=ms_j.idelpro,
        idelt=ms_j.idelt, delpro_lf=ms_j.delpro_lf,
        ifrelfmax=ms_j.ifrelfmax, irefra=ms_j.irefra)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_setup_from_arrays_carries_reference_tables(name):
    ms_j, _ = _both(name)
    ms_t = tsetup.setup_from_arrays(dtype=torch.float64, device="cpu",
                                    **_arrays(ms_j))
    _compare_tables(ms_j, ms_t)
    # identical, not merely close: the tables were handed over
    np.testing.assert_array_equal(ms_t.fused.taps_dn, ms_j.fused.taps_dn)
    np.testing.assert_array_equal(ms_t.env["wavnum_ext"].numpy(),
                                  np.asarray(ms_j.env["wavnum_ext"]))


def test_pad_point_field_replicates_point_zero():
    ms = tsetup.build_model(grid_name="12.0", nang=12, nfre=8, pad_to=64,
                            device="cpu")
    v = np.arange(ms.n_real, dtype=np.float64) + 1.0
    out = tsetup.pad_point_field(ms, v)
    assert out.shape == (ms.n_pad,)
    np.testing.assert_array_equal(out[: ms.n_real], v)
    assert (out[ms.n_real:] == 1.0).all()


def test_unported_options_raise():
    """What build_model still refuses, as the reference does: OTF weights
    with fast waves under current refraction, and an unknown weight mode.
    The dense modes build no SRL tables; u* forcing builds."""
    with pytest.raises(NotImplementedError, match="'fused' and 'cached'"):
        tsetup.build_model(grid_name="12.0", nang=12, nfre=8, irefra=2,
                           ifrelfmax=3, delpro_lf=450.0,
                           weights_mode="otf", device="cpu")
    with pytest.raises(ValueError, match="weights_mode"):
        tsetup.build_model(grid_name="12.0", nang=12, nfre=8,
                           weights_mode="dense", device="cpu")
    for mode in ("cached", "otf"):
        ms = tsetup.build_model(grid_name="12.0", nang=12, nfre=8,
                                weights_mode=mode, device="cpu")
        assert ms.fused is None and ms.fused_env is None
    ms = tsetup.build_model(grid_name="12.0", nang=12, nfre=8, icode_wnd=1,
                            device="cpu")
    assert ms.phys.icode_wnd == 1 and ms.fused is not None


@pytest.mark.parametrize("mode", ["fused", "cached"])
def test_table_cache_round_trip(tmp_path, mode):
    """``build_model(cache_dir=...)`` writes the host tables once and a
    second build reads them back: the same stencil, SRL tables and env
    (with obstructions, whose key the copy hashes table by table)."""
    import os
    kw = dict(golden_kw(), weights_mode=mode, device="cpu",
              cache_dir=str(tmp_path))
    a = tsetup.build_model(**kw)
    files = os.listdir(tmp_path)
    assert len(files) == 1 and files[0].startswith("wamtables_")
    b = tsetup.build_model(**kw)
    assert os.listdir(tmp_path) == files
    for f in ("klat", "kcor", "wlat", "obscor", "tanph_pt"):
        np.testing.assert_array_equal(getattr(a.stencil, f),
                                      getattr(b.stencil, f))
    assert (a.fused is None) == (b.fused is None) == (mode != "fused")
    if a.fused is not None:
        np.testing.assert_array_equal(a.fused.srl_src, b.fused.srl_src)
    for k, v in a.env.items():
        assert torch.equal(v, b.env[k]), k
