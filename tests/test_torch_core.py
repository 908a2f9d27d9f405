"""The port's copies of the JAX package's numpy modules against their
originals.

``ecwam_tpu_torch.{core.constants, core.physparams, core.spectral,
core.dispersion, core.grid, core.bathy, ops.physics.tables, model.preset,
io.norms, config.schema, config.namelist, io.outcontrol, io.restart,
io.waminfo, io.forcing, io.grib, io.gribout, io.multio, io.partition,
io.outspec, model.tablecache, native, parallel.decomp, parallel.decomp2d,
parallel.fused_shard}`` are copies of the ``ecwam_tpu``
modules of the same paths (numpy only), kept so that the port imports
nothing of the JAX package.  Each case must give exactly what its original
gives on the same inputs (``array_equal``: they run the same numpy code;
files written by both are equal byte for byte), and the files of
``io.outspec`` read across the two packages.  The one deliberate difference:
``model.tablecache.build_key`` hashes each obstruction table on its own,
with its shape and dtype (ADVICE.md), so its keys differ from the
original's where obstructions are given (its own test).
"""

import dataclasses
import functools
import os
import tempfile

import numpy as np
import pytest

from ecwam_tpu import native as j_native
from ecwam_tpu.config import namelist as j_namelist
from ecwam_tpu.config import schema as j_schema
from ecwam_tpu.core import bathy as j_bathy
from ecwam_tpu.core import constants as j_c
from ecwam_tpu.core import dispersion as j_disp
from ecwam_tpu.core import grid as j_grid
from ecwam_tpu.core import physparams as j_pp
from ecwam_tpu.core import spectral as j_sp
from ecwam_tpu.io import forcing as j_forcing
from ecwam_tpu.io import grib as j_grib
from ecwam_tpu.io import gribout as j_gribout
from ecwam_tpu.io import multio as j_multio
from ecwam_tpu.io import norms as j_norms
from ecwam_tpu.io import outcontrol as j_outcontrol
from ecwam_tpu.io import outspec as j_outspec
from ecwam_tpu.io import partition as j_partition
from ecwam_tpu.io import restart as j_restart
from ecwam_tpu.io import waminfo as j_waminfo
from ecwam_tpu.model import preset as j_preset
from ecwam_tpu.model import tablecache as j_tablecache
from ecwam_tpu.ops.physics import tables as j_tables
from ecwam_tpu.parallel import decomp as j_decomp
from ecwam_tpu.parallel import decomp2d as j_decomp2d
from ecwam_tpu.parallel import fused_shard as j_fused_shard
from ecwam_tpu_torch import native as t_native
from ecwam_tpu_torch.config import namelist as t_namelist
from ecwam_tpu_torch.config import schema as t_schema
from ecwam_tpu_torch.core import bathy as t_bathy
from ecwam_tpu_torch.core import constants as t_c
from ecwam_tpu_torch.core import dispersion as t_disp
from ecwam_tpu_torch.core import grid as t_grid
from ecwam_tpu_torch.core import physparams as t_pp
from ecwam_tpu_torch.core import spectral as t_sp
from ecwam_tpu_torch.io import forcing as t_forcing
from ecwam_tpu_torch.io import grib as t_grib
from ecwam_tpu_torch.io import gribout as t_gribout
from ecwam_tpu_torch.io import multio as t_multio
from ecwam_tpu_torch.io import norms as t_norms
from ecwam_tpu_torch.io import outcontrol as t_outcontrol
from ecwam_tpu_torch.io import outspec as t_outspec
from ecwam_tpu_torch.io import partition as t_partition
from ecwam_tpu_torch.io import restart as t_restart
from ecwam_tpu_torch.io import waminfo as t_waminfo
from ecwam_tpu_torch.model import preset as t_preset
from ecwam_tpu_torch.model import tablecache as t_tablecache
from ecwam_tpu_torch.ops.physics import tables as t_tables
from ecwam_tpu_torch.parallel import decomp as t_decomp
from ecwam_tpu_torch.parallel import decomp2d as t_decomp2d
from ecwam_tpu_torch.parallel import fused_shard as t_fused_shard


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


@functools.lru_cache(maxsize=None)
def _shard_setup():
    """The 12° aqua grid's padded stencil, SRL tables and rows (the port's
    build; both packages' copies take the same numpy tables)."""
    from ecwam_tpu_torch.model import setup as tsetup
    return tsetup.build_model(grid_name="12.0", nang=12, nfre=25,
                              nfre_red=20, pad_to=64, device="cpu")


def _decomp(m):
    ms = _shard_setup()
    rs = np.asarray(ms.blk.row_start)
    dc = m["decomp"]
    ss = dc.build_sharded_stencil(ms.stencil, 4, row_start=rs)
    v = np.arange(3 * ms.n_pad, dtype=np.float64).reshape(3, ms.n_pad)
    return (dc.row_cuts(rs, ms.n_pad, 4), dc.compute_halo_width(
        ms.stencil, 4), ss, dc.build_sharded_stencil(ms.stencil, 4),
        ss.to_layout(v), ss.from_layout(ss.to_layout(v)))


def _decomp2d(m):
    ms = _shard_setup()
    rs = np.asarray(ms.blk.row_start)
    d2 = m["decomp2d"]
    return (d2.assign_shards(ms.n_pad, rs, 2, 2),
            d2.build_sharded2d_stencil(ms.stencil, 2, 2, rs))


def _fused_shard(m):
    ms = _shard_setup()
    fs = m["fused_shard"]
    kxlt = np.asarray(ms.blk.kxlt)
    ss = t_decomp.build_sharded_stencil(
        ms.stencil, 3, row_start=np.asarray(ms.blk.row_start))
    need = fs.required_halo(ms.fused, ss.perm, ss.g2l, ss.shard_size, 3,
                            kxlt)
    fst = fs.build_fused_shard_tables(ms.fused, ms.fused_env, ss.perm,
                                      ss.g2l, ss.shard_size, 3,
                                      max(need, ss.halo), kxlt)
    g = np.arange(2 * ms.fused.nsrl, dtype=np.float64).reshape(-1, 2)
    return need, fst, fs.slice_global_srl(fst, g)


def _norms(norms, _):
    v = np.random.default_rng(1).random(50)
    e = norms.norm_entry("swh", "20230101000000", v, v > 0.9)
    return e, norms.format_line(e), norms.ieee_hex(0.1)


YAML = """
grid: 12.0
directions: 12
frequencies: 15
physics_frequencies: 18
bathymetry: aqua
advection: {timestep: "00:15"}
physics: {timestep: 1800}
analysis.begin: 2023-01-01 00:00:00
begin: ${analysis.begin}
end: 2023-01-01 06:00:00
forcings:
    at:
      - {begin: 2023-01-01 00:00:00, end: 2023-01-01 06:00:00, timestep: "01:00"}
output:
    fields:
        name: [swh, mwd, p062, wsk]
        format: grib
        at:
          - timestep: "03:00"
    restart:
        at:
          - time: 2023-01-01 03:00:00
irefra: 2
llgcbz0: T
lsecondorder: F
validation:
    single_precision:
      - {name: swh, average: 1.0}
"""

NAMELIST = """
&NALINE
  NANG = 12, NFRE = 25, NFRE_RED = 20,
  CBPLTDT = "20230101000000", CEPLTDT = "20230101060000",
  IDELPRO = 900, IDELT = 900, IDELINT = 3600,
  IPHYS = 0, IREFRA = 1, LSECONDORDER = F, LGRIBOUT = T,
  GFLAG(1)=T, GFLAG(2)=T, NFLAG(1)=T,
/
&NAOS CLSOUT="20230101030000" /
"""


def _outcontrol(oc):
    ctl = oc.OutputControl.from_names(["swh", "mwd", "p062", "ci", "ust"],
                                      grib_restart=True)
    rng = np.random.default_rng(2)
    fields = {n: rng.random(30) for n in ctl.output_names()}
    masked = oc.apply_output_masks(fields, cicover=rng.random(30),
                                   licerun=True)
    return (ctl.output_names(), ctl.grib_names(), ctl.norm_names(),
            ctl.file_names(), ctl.itobout, ctl.ipfgtbl, masked)


def _in_tmp(fn):
    """``fn(directory)`` → (its result, {file name: bytes} written)."""
    with tempfile.TemporaryDirectory() as d:
        out = fn(d)
        files = {}
        for root, _, names in os.walk(d):
            for n in names:
                path = os.path.join(root, n)
                with open(path, "rb") as f:
                    files[os.path.relpath(path, d)] = f.read()
    return out, files


def _restart(rst, _):
    rng = np.random.default_rng(3)
    stress = {k: rng.random(20) for k in rst.STRESS_KEYS}
    frc = {"wswave": rng.random(20), "cicover": rng.random(20)}

    def run(d):
        fn = rst.save_restart(d, "20230101030000", rng.random((12, 15, 20)),
                              stress, frc)
        return (rst.restart_name("20230101030000"),
                rst.load_restart(fn, nang=12, nfre=18))
    out, _files = _in_tmp(run)         # npz members carry timestamps
    return out


def _waminfo(wi, _):
    def run(d):
        fn = os.path.join(d, "waminfo")
        wi.write_waminfo(fn, begin14="20230101000000",
                         end14="20230102000000",
                         restart_date14="20230101060000",
                         last_spectra_date14="20230101060000")
        return wi.read_waminfo(fn)
    return _in_tmp(run)


def _forcing(frc, _):
    ff = frc.synthetic_forcing_file([20230101000000, 20230101060000])
    lat = np.linspace(-70.0, 70.0, 25)
    lon = np.linspace(0.0, 355.0, 25)
    prov = ff.provider(lat, lon)
    return prov("20230101000000"), prov("20230101030000")


def _grib_fields(m):
    grid = m["grid"].regular_grid(12.0)
    blk = m["grid"].build_sea_point_block(
        grid, m["grid"].aqua_bathymetry(grid))
    rng = np.random.default_rng(4)
    return grid, blk, {n: 3.0 * rng.random(blk.nsea)
                       for n in ("swh", "mwd", "p062")}


def _gribout(m):
    grid, blk, fields = _grib_fields(m)

    def run(d):
        path = os.path.join(d, "MPP.grib")
        m["gribout"].write_fields(path, fields, blk, grid, "20230101030000")
        msgs = m["grib"].read_messages(path)
        return [(g.meta, g.values, g.pl) for g in msgs]
    return _in_tmp(run)


def _multio(m):
    grid, blk, fields = _grib_fields(m)

    def run(d):
        sink = m["multio"].MultioSink(os.path.join(d, "fdb"))
        m["multio"].write_fields_to_sink(sink, fields, blk, grid,
                                         "20230101030000")
        sink.close()
        fdb = m["multio"].FdbLite(os.path.join(d, "fdb"))
        return fdb.list_keys(), fdb.retrieve(param="swh")
    return _in_tmp(run)


def _outspec_case(gm):
    """Random spectra (3 directions, 4 frequencies) on an O24 aqua block."""
    grid = gm.octahedral_grid(24)
    blk = gm.build_sea_point_block(grid, gm.aqua_bathymetry(grid))
    return grid, blk, np.random.default_rng(8).random((3, 4, blk.nsea))


POINTS = [(10.0, 20.0), (-45.0, 300.0), (70.0, 5.0)]


def _outspec(m):
    """OUTSPEC's GRIB spectra written and read back, and the point-output
    journal of three positions at two dates (its npz compared by content:
    the archive stamps its members with the time)."""
    grid, blk, fl1 = _outspec_case(m["grid"])
    o = m["outspec"]

    def run(d):
        path = os.path.join(d, "SPEC.grib")
        o.write_spectra(path, fl1, blk, grid, "20230101030000")
        back = o.read_spectra(path, blk, grid, nang=3, nfre=4)
        po = o.PointOutput(POINTS, blk, grid)
        po.append("20230101030000", fl1)
        po.append("20230101060000", 2.0 * fl1)
        fn = po.write(os.path.join(d, "points.npz"))
        journal = o.load_points(fn)
        os.remove(fn)
        return back, po.indices, journal
    return _in_tmp(run)


def _sep3tr(m):
    """Two swell systems and noise on 6 points, a random swell mask."""
    tb = m["sp"].build_spectral_tables(nang=12, nfre=25)
    rng = np.random.default_rng(5)
    fl1 = 1e-4 * rng.random((12, 25, 6))
    fl1[1:4, 4:7] += 8.0
    fl1[7:10, 9:12] += 4.0
    swm = (rng.random(fl1.shape) < 0.9).astype(np.float64)
    sep = dict(swm=swm, flsw=np.maximum(fl1, 1e-32) * swm)
    for k in ("eswell", "fswell", "thswell", "fsea"):
        sep[k] = rng.random(6)
    return [m["partition"].sep3tr(fl1, np.full(6, mij, np.int32), sep,
                                  np.full(6, 3.0), np.zeros(6), tb,
                                  ntrain=nt)
            for mij, nt in ((24, 3), (12, 2))]


def _tablecache(m):
    """A stencil, a sea-point block and a dispersion env through the
    cache's save and load, and a key without obstructions."""
    grid = m["grid"].regular_grid(12.0)
    blk = m["grid"].build_sea_point_block(grid,
                                          m["grid"].aqua_bathymetry(grid))
    bathy = m["grid"].aqua_bathymetry(grid)
    tc = m["tablecache"]
    key = tc.build_key(grid, bathy, nang=12, nfre=25, nfre_red=20,
                       pad_to=64, seg=0, obstructions=None)
    props = dict(wavnum=np.random.default_rng(6).random((5, 3)),
                 cgroup=np.ones((2000, 2)))

    def run(d):
        tc.save(d, key, blk=blk, stencil=blk, fused=None, props=props)
        return tc.load(d, key, blk_cls=type(blk), st_cls=type(blk),
                       ft_cls=None)
    return key, _in_tmp(run)[0], tc._flatten("p", props, {})


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
    "schema": lambda m: (m["schema"].RunConfig.from_yaml(YAML),
                         m["schema"].RunConfig.from_yaml(YAML).build_kwargs(),
                         m["schema"].RunConfig.from_yaml(YAML).output_dates(),
                         m["schema"].RunConfig.from_yaml(YAML)
                         .forcing_dates()),
    "namelist": lambda m: m["namelist"].namelist_to_config(NAMELIST),
    "outcontrol": lambda m: _outcontrol(m["outcontrol"]),
    "restart": lambda m: _restart(m["restart"], None),
    "waminfo": lambda m: _waminfo(m["waminfo"], None),
    "forcing": lambda m: _forcing(m["forcing"], None),
    "grib_gribout_native": _gribout,
    "block_to_grid_land_O24": lambda m: [m["gribout"].block_to_grid(
        np.arange(blk.nsea, dtype=np.float64), blk, wg) for wg, blk in (
        (m["grid"].regular_grid(12.0, name="t12"),
         _bathymetry(m["bathy"], m["grid"], m["sp"])[3]),
        (m["grid"].octahedral_grid(24), m["grid"].build_sea_point_block(
            m["grid"].octahedral_grid(24),
            m["grid"].aqua_bathymetry(m["grid"].octahedral_grid(24)))))],
    "multio": _multio,
    "outspec_grib_and_points": _outspec,
    "partition_sep3tr": _sep3tr,
    "tablecache_save_load_key": _tablecache,
    "decomp_bands": _decomp,
    "decomp2d_patches": _decomp2d,
    "fused_shard_tables": _fused_shard,
}

JAX_MODULES = dict(c=j_c, sp=j_sp, grid=j_grid, bathy=j_bathy, disp=j_disp,
                   pp=j_pp, tables=j_tables, preset=j_preset, norms=j_norms,
                   schema=j_schema, namelist=j_namelist,
                   outcontrol=j_outcontrol, restart=j_restart,
                   waminfo=j_waminfo, forcing=j_forcing, grib=j_grib,
                   gribout=j_gribout, multio=j_multio, native=j_native,
                   partition=j_partition, tablecache=j_tablecache,
                   outspec=j_outspec, decomp=j_decomp, decomp2d=j_decomp2d,
                   fused_shard=j_fused_shard)
PORT_MODULES = dict(c=t_c, sp=t_sp, grid=t_grid, bathy=t_bathy, disp=t_disp,
                    pp=t_pp, tables=t_tables, preset=t_preset, norms=t_norms,
                    schema=t_schema, namelist=t_namelist,
                    outcontrol=t_outcontrol, restart=t_restart,
                    waminfo=t_waminfo, forcing=t_forcing, grib=t_grib,
                    gribout=t_gribout, multio=t_multio, native=t_native,
                    partition=t_partition, tablecache=t_tablecache,
                    outspec=t_outspec, decomp=t_decomp, decomp2d=t_decomp2d,
                    fused_shard=t_fused_shard)


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_copy_matches_original(name):
    _same(BUILDERS[name](JAX_MODULES), BUILDERS[name](PORT_MODULES), name)


@pytest.mark.parametrize("module", sorted(PORT_MODULES))
def test_copy_names_its_source(module):
    mod, orig = PORT_MODULES[module], JAX_MODULES[module]
    root = os.path.dirname(os.path.dirname(os.path.dirname(j_c.__file__)))
    rel = os.path.relpath(orig.__file__, root)
    assert f"``{rel}``" in mod.__doc__
    assert mod.__name__ == orig.__name__.replace("ecwam_tpu",
                                                 "ecwam_tpu_torch", 1)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_outspec_files_read_across_packages(writer, tmp_path):
    """OUTSPEC's spectra file and the point journal, written by one
    package's module, read by the other's as by the writer's own."""
    w, r = ((t_outspec, j_outspec) if writer == "port"
            else (j_outspec, t_outspec))
    grid, blk, fl1 = _outspec_case(t_grid)
    path = str(tmp_path / "SPEC.grib")
    w.write_spectra(path, fl1, blk, grid, "20230101030000")
    _same(r.read_spectra(path, blk, grid, nang=3, nfre=4),
          w.read_spectra(path, blk, grid, nang=3, nfre=4), "spectra")
    po = w.PointOutput(POINTS, blk, grid)
    po.append("20230101030000", fl1)
    fn = po.write(str(tmp_path / "points.npz"))
    got = r.load_points(fn)
    _same(got, w.load_points(fn), "points")
    np.testing.assert_array_equal(got["spectra"][0],
                                  np.moveaxis(fl1[..., po.indices], -1, 0))


def test_tablecache_key_hashes_each_obstruction_table():
    """The copy's one difference from its original: ``build_key`` hashes
    each obstruction table on its own with its shape and dtype, so a
    table and its broadcast copy, or two tables of other shapes, get
    different keys, and tables that do not broadcast together are taken
    (the original broadcasts them first: it maps the first pair to one
    key and raises on the last)."""
    grid = t_grid.regular_grid(12.0)
    bathy = t_grid.aqua_bathymetry(grid)

    def key(obs, tc=t_tablecache):
        return tc.build_key(grid, bathy, nang=12, nfre=25, nfre_red=20,
                            pad_to=64, seg=0, obstructions=obs)
    one = np.ones((20, 1))
    wide = np.ones((20, 50))
    odd = (np.ones((20, 50, 2)), np.ones((20, 50, 2)), np.ones((20, 50, 4)))
    assert key({"a": one}) != key({"a": wide})
    assert key(odd) != key(odd[:2] + (np.ones((20, 50, 2)),))
    assert key(odd) != key(tuple(a.astype(np.float32) for a in odd))
    assert key(odd) == key(tuple(a.copy() for a in odd))
    assert key(None) == key(None, j_tablecache)
    with pytest.raises(ValueError):
        key(dict(enumerate(odd)), j_tablecache)


def test_cideac_copy_matches_original():
    """``ecwam_tpu_torch/data/cideac.npz``, SDICE1's deactivation table,
    is a copy of ``ecwam_tpu/data/cideac.npz``."""
    from ecwam_tpu.ops.physics import sdice as j_sdice
    from ecwam_tpu_torch.ops.physics import sdice as t_sdice
    _same(j_sdice.load_cideac(), t_sdice.load_cideac(), "cideac")
    assert t_sdice.load_cideac()["cideac"].shape == (16, 36)


def test_native_builds_outside_the_source():
    """The port's codecs are its own copies, built under ``build/`` and
    never beside the source or from the JAX package's library."""
    for name in ("grib1.cc", "grib2.cc"):
        with open(os.path.join(os.path.dirname(j_native.__file__), name),
                  "rb") as a, open(os.path.join(
                      os.path.dirname(t_native.__file__), name), "rb") as b:
            assert a.read() == b.read(), name
    lib = t_native.load("grib1")
    assert os.path.dirname(lib._name) == t_native.BUILD_DIR
    assert lib._name.startswith(os.path.join(
        os.path.dirname(os.path.dirname(t_native._DIR)), "build"))
    assert not any(f.endswith(".so")
                   for f in os.listdir(os.path.dirname(t_native.__file__)))
