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
    with pytest.raises(NotImplementedError, match="ROADMAP A4"):
        tsetup.build_model(grid_name="12.0", nang=12, nfre=8, icode_wnd=1,
                           device="cpu")
    with pytest.raises(NotImplementedError):
        tsetup.build_model(grid_name="12.0", nang=12, nfre=8,
                           weights_mode="cached", device="cpu")
