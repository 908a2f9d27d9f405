"""The port's copies of the JAX package's numpy modules against their
originals.

``ecwam_tpu_torch.{core.constants, core.physparams, core.spectral,
core.dispersion, core.grid, core.bathy, ops.physics.tables, model.preset,
io.norms}`` are copies of the ``ecwam_tpu`` modules of the same paths
(numpy only), kept so that the port imports nothing of the JAX package.
Each builder must give exactly what its original gives on the same inputs
(``array_equal``: they run the same numpy code).
"""

import dataclasses

import numpy as np
import pytest

from ecwam_tpu.core import bathy as j_bathy
from ecwam_tpu.core import constants as j_c
from ecwam_tpu.core import dispersion as j_disp
from ecwam_tpu.core import grid as j_grid
from ecwam_tpu.core import physparams as j_pp
from ecwam_tpu.core import spectral as j_sp
from ecwam_tpu.io import norms as j_norms
from ecwam_tpu.model import preset as j_preset
from ecwam_tpu.ops.physics import tables as j_tables
from ecwam_tpu_torch.core import bathy as t_bathy
from ecwam_tpu_torch.core import constants as t_c
from ecwam_tpu_torch.core import dispersion as t_disp
from ecwam_tpu_torch.core import grid as t_grid
from ecwam_tpu_torch.core import physparams as t_pp
from ecwam_tpu_torch.core import spectral as t_sp
from ecwam_tpu_torch.io import norms as t_norms
from ecwam_tpu_torch.model import preset as t_preset
from ecwam_tpu_torch.ops.physics import tables as t_tables


def _same(a, b, what="value"):
    """Equal values: dataclasses field by field, dicts key by key, tuples
    item by item, arrays with array_equal."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, what
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name), f"{what}.{f.name}")
    elif isinstance(a, dict):
        assert set(a) == set(b), what
        for k in a:
            _same(a[k], b[k], f"{what}[{k!r}]")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{what}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a),
                                      err_msg=what)
    else:
        assert a == b, what


def _golden_topo(m):
    return m.synthetic_topo(invres=2, features=[
        dict(kind="land", lon=(40.0, 44.0), lat=(0.0, 12.0), elev=300.0),
        dict(kind="shoal", lon=(80.0, 92.0), lat=(-12.0, 0.0), elev=-15.0)])


def _bathymetry(bathy, grid, sp):
    topo = _golden_topo(bathy)
    wg = grid.regular_grid(12.0, name="t12")
    tb = sp.build_spectral_tables(nang=12, nfre=18, nfre_red=15)
    b, obs = bathy.make_bathymetry(topo, wg, tb.fr, nfre_red=15)
    blk = grid.build_sea_point_block(wg, b)
    return topo, b, obs, blk, bathy.obstructions_to_block(obs, blk)


def _mstart(preset, sp):
    rng = np.random.default_rng(0)
    tb = sp.build_spectral_tables(nang=12, nfre=25)
    return preset.mstart(tb, 6.0 + 6.0 * rng.random(40),
                         rng.random(40) * 2.0 * np.pi)


def _norms(norms, _):
    v = np.random.default_rng(1).random(50)
    e = norms.norm_entry("swh", "20230101000000", v, v > 0.9)
    return e, norms.format_line(e), norms.ieee_hex(0.1)


BUILDERS = {
    "constants": lambda m: {k: v for k, v in vars(m["c"]).items()
                            if k.isupper()},
    "spectral_12x18x15": lambda m: m["sp"].build_spectral_tables(
        nang=12, nfre=18, nfre_red=15),
    "spectral_36x36x29": lambda m: m["sp"].build_spectral_tables(
        nang=36, nfre=36, nfre_red=29),
    "regular_grid_12": lambda m: m["grid"].regular_grid(12.0),
    "octahedral_grid_O24": lambda m: m["grid"].octahedral_grid(24),
    "sea_point_block_O24": lambda m: m["grid"].build_sea_point_block(
        m["grid"].octahedral_grid(24),
        m["grid"].aqua_bathymetry(m["grid"].octahedral_grid(24))),
    "golden_topo_bathymetry": lambda m: _bathymetry(m["bathy"], m["grid"],
                                                    m["sp"]),
    "dispersion": lambda m: (
        m["disp"].depth_properties(np.array([5.0, 20.0, 150.0, 999.0]),
                                   m["sp"].build_spectral_tables(
                                       nang=12, nfre=25).fr),
        m["disp"].depth_limited_energy(np.array([5.0, 20.0, 999.0]))),
    "set_phys_params": lambda m: (m["pp"].set_phys_params(1, nang=36),
                                  m["pp"].set_phys_params(0, nang=12)),
    "saturation_weights": lambda m: m["pp"].saturation_weights(
        36, *(lambda tb: (tb.th, tb.delth))(
            m["sp"].build_spectral_tables(nang=36, nfre=36))),
    "tables": lambda m: (
        m["tables"].tabu_swellft(),
        m["tables"].x0_tauhf(m["pp"].set_phys_params(1, nang=36)),
        m["tables"].wtauhf(m["pp"].set_phys_params(1, nang=36))),
    "preset_mstart": lambda m: _mstart(m["preset"], m["sp"]),
    "norms": lambda m: _norms(m["norms"], None),
}

JAX_MODULES = dict(c=j_c, sp=j_sp, grid=j_grid, bathy=j_bathy, disp=j_disp,
                   pp=j_pp, tables=j_tables, preset=j_preset, norms=j_norms)
PORT_MODULES = dict(c=t_c, sp=t_sp, grid=t_grid, bathy=t_bathy, disp=t_disp,
                    pp=t_pp, tables=t_tables, preset=t_preset, norms=t_norms)


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_copy_matches_original(name):
    _same(BUILDERS[name](JAX_MODULES), BUILDERS[name](PORT_MODULES), name)


@pytest.mark.parametrize("module", sorted(PORT_MODULES))
def test_copy_names_its_source(module):
    mod, orig = PORT_MODULES[module], JAX_MODULES[module]
    rel = orig.__name__.replace(".", "/") + ".py"
    assert f"``{rel}``" in mod.__doc__
    assert mod.__name__ == orig.__name__.replace("ecwam_tpu",
                                                 "ecwam_tpu_torch", 1)


def test_cideac_copy_matches_original():
    """``ecwam_tpu_torch/data/cideac.npz``, SDICE1's deactivation table,
    is a copy of ``ecwam_tpu/data/cideac.npz``."""
    from ecwam_tpu.ops.physics import sdice as j_sdice
    from ecwam_tpu_torch.ops.physics import sdice as t_sdice
    _same(j_sdice.load_cideac(), t_sdice.load_cideac(), "cideac")
    assert t_sdice.load_cideac()["cideac"].shape == (16, 36)
