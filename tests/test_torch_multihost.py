"""The port's multi-process scaffolding in one process.

After tests/test_multihost.py, on ``ecwam_tpu_torch.parallel.multihost``
and ``.sharded`` with in-process CPU shards:
  * the ring of shards is host-major and names this rank's shards;
  * a parallel restart written by an 8-shard model reassembles bit for
    bit into the global state, re-shards onto 4 shards, and the step from
    it equals the 8-shard step (float32, rtol 2e-4 as the reference's
    test); the reference's files read in the port and the port's in the
    reference (the same names and npz layout);
  * the gathered norms are the same bits at 4 and 8 shards;
  * the writer-rank split writes every field once (OUTGRID's role).
"""

import jax
import numpy as np
import pytest

from ecwam_tpu.model import setup as jsetup
from ecwam_tpu.model import stepper as jstepper
from ecwam_tpu.parallel import multihost as jmultihost
from ecwam_tpu.parallel import sharded as jsharded
from ecwam_tpu_torch.model import preset
from ecwam_tpu_torch.model import setup as tsetup
from ecwam_tpu_torch.model import stepper as tstepper
from ecwam_tpu_torch.parallel import multihost, sharded

DATE = "20230101000000"
KW = dict(grid_name="6.0", nang=12, nfre=25, idelpro=900.0, idelt=900.0,
          pad_to=64, weights_mode="cached")


def _model():
    return tsetup.build_model(**KW, device="cpu")


def _state(ms, seed=3):
    rng = np.random.default_rng(seed)
    ws = 8.0 + 4.0 * rng.random(ms.n_pad)
    wd = rng.random(ms.n_pad) * 2 * np.pi
    fl1 = np.asarray(preset.mstart(ms.tb, ws, wd), np.float32)
    frc = dict(wswave=ws, wdwave=wd, aird=np.full(ms.n_pad, 1.225),
               wstar=np.zeros(ms.n_pad), cicover=np.zeros(ms.n_pad))
    stress = {k: v.numpy() for k, v in
              tstepper.initial_stress(ms, frc).items()}
    return fl1, frc, stress


def _mesh(k):
    return multihost.make_point_mesh(["cpu"] * k)


def test_point_mesh_host_major():
    mesh = _mesh(3)
    assert mesh.n_shards == 3 and mesh.local == (0, 1, 2)
    assert list(mesh.ranks) == sorted(mesh.ranks) == [0, 0, 0]
    assert all(d.type == "cpu" for d in mesh.devices)
    assert not mesh.multiprocess
    with pytest.raises(ValueError):
        multihost.make_point_mesh([])
    # one process needs no group; a second init would be a programming
    # error, and a named backend needs the store's address
    multihost.init_distributed(None, 1, 0)
    with pytest.raises(ValueError, match="address"):
        multihost.init_distributed(None, 1, 0, backend="gloo")


def _put(sm, fl1, frc, stress):
    return (sm.device_put(fl1),
            {k: sm.device_put(v) for k, v in frc.items()},
            {k: sm.device_put(v) for k, v in stress.items()})


def test_parallel_restart_roundtrip_across_shard_counts(tmp_path):
    ms = _model()
    fl1, frc, stress = _state(ms)
    sm8 = sharded.build_sharded_model(ms, _mesh(8))
    f8, frc8, s8 = _put(sm8, fl1, frc, stress)
    files = multihost.save_sharded_restart(str(tmp_path), DATE, sm8, f8, s8)
    assert len(files) == 8
    fl1_g, stress_g = multihost.load_sharded_restart(str(tmp_path), DATE,
                                                     ms.n_pad)
    np.testing.assert_array_equal(fl1_g, fl1)
    for k, v in stress.items():
        np.testing.assert_array_equal(stress_g[k], v.astype(np.float32))
    # the reference reads the port's files
    j_fl1, j_stress = jmultihost.load_sharded_restart(str(tmp_path), DATE,
                                                      ms.n_pad)
    np.testing.assert_array_equal(j_fl1, fl1_g)
    for k in stress:
        np.testing.assert_array_equal(j_stress[k], stress_g[k])

    # restart on another shard count: 4 shards, one step each
    sm4 = sharded.build_sharded_model(ms, _mesh(4))
    f4, frc4, s4 = _put(sm4, fl1_g, frc, stress_g)
    out4, _ = sm4.step_full(f4, frc4, s4)
    out8, _ = sm8.step_full(f8, frc8, s8)
    np.testing.assert_allclose(sm4.from_layout(out4), sm8.from_layout(out8),
                               rtol=2e-4, atol=1e-10)


def test_reference_restart_reads_in_the_port(tmp_path):
    """A restart the reference's 4-shard model wrote reassembles in the
    port and places onto the port's 8 shards."""
    import jax.numpy as jnp
    jms = jsetup.build_model(**KW, dtype=jnp.float32)
    ms = _model()
    fl1, frc, stress = _state(ms)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]), ("pts",))
    jsm = jsharded.build_sharded_model(jms, mesh)
    jstress = jstepper.initial_stress(jms, {k: jnp.asarray(v)
                                            for k, v in frc.items()})
    files = jmultihost.save_sharded_restart(
        str(tmp_path), DATE, jsm, jsm.device_put(fl1),
        {k: jsm.device_put(np.asarray(v)) for k, v in jstress.items()})
    assert len(files) == 4
    fl1_g, stress_g = multihost.load_sharded_restart(str(tmp_path), DATE,
                                                     ms.n_pad)
    np.testing.assert_array_equal(fl1_g, fl1)
    sm = sharded.build_sharded_model(ms, _mesh(8))
    back = sm.from_layout(sm.device_put(fl1_g))
    np.testing.assert_array_equal(back, fl1_g)
    for k, v in jstress.items():
        np.testing.assert_array_equal(stress_g[k], np.asarray(v))


def test_sharded_norms_shard_count_invariant():
    ms = _model()
    fl1, _, _ = _state(ms, seed=5)
    em = fl1.sum(axis=(0, 1))
    out = {}
    for nsh in (4, 8):
        sm = sharded.build_sharded_model(ms, _mesh(nsh))
        out[nsh] = sm.norms(sm.device_put(em))
    assert out[4] == out[8]


def test_writer_rank_distributed_output(tmp_path):
    from ecwam_tpu_torch.core.grid import (aqua_bathymetry,
                                           build_sea_point_block,
                                           regular_grid)
    from ecwam_tpu_torch.io.outcontrol import OutputControl

    grid = regular_grid(12.0)
    blk = build_sea_point_block(grid, aqua_bathymetry(grid))
    names = ["swh", "mwd", "mwp", "pp1d", "shww"]
    oc = OutputControl.from_names(names, fmt="grib", nproc=3, lfdb=True)
    rng = np.random.default_rng(3)
    fields = {nm: rng.uniform(0.5, 4.0, blk.nsea) for nm in names}
    written = {}
    for pid in range(3):
        for fn in multihost.write_distributed_fields(
                str(tmp_path), "20230101120000", fields, oc, blk, grid,
                process_index=pid, num_processes=3):
            written[pid] = fn
    msgs = 0
    for fn in written.values():
        with open(fn, "rb") as f:
            msgs += f.read().count(b"GRIB")
    assert msgs == len(names)
    assert [oc.writer_rank(nm) for nm in names] == [0, 1, 2, 0, 1]
    # one process with no group writes every field it owns as rank 0
    assert multihost.rank() == 0 and multihost.world_size() == 1
