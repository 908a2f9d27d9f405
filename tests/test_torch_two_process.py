"""Two processes under gloo: the port's sharded models across a process
boundary.

After tests/test_two_process.py:72.  Two Python processes join one gloo
group (``multihost.init_distributed`` on a free localhost port bound at
run time), each with 2 CPU shards of a 4-shard ring.  Each runs, on the
12° aqua grid in float64:
  * the fused model's kernel-architecture steps (2 fast steps): the
    adjacent rows of shards 1 and 2 cross the process boundary;
  * the cached model's step in row bands: its halo slabs cross it too;
  * the device norms, reduced with ``all_reduce`` over the group;
and writes its own shards' restart files.  The parent reassembles each
restart and holds it to the same model run in one process on 4 shards
(the same bits: each shard does the same arithmetic) and to the norms
of the gathered field.  The children and their group time out well
inside 180 s, so a hung peer fails the test rather than the run.
"""

import ast
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import torch

from ecwam_tpu_torch.model import setup as tsetup
from ecwam_tpu_torch.model.fusedstep import FusedPropagation
from ecwam_tpu_torch.parallel import multihost, sharded

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 150
GROUP_TIMEOUT_S = 60
FUSED, CACHED = "20230101000000", "20230101001500"

COMMON = textwrap.dedent("""
    import numpy as np
    import torch
    from ecwam_tpu_torch.model import preset
    from ecwam_tpu_torch.model import setup as tsetup
    from ecwam_tpu_torch.model import stepper as tstepper
    from ecwam_tpu_torch.parallel import multihost, sharded

    KW = dict(grid_name="12.0", nang=12, nfre=25, nfre_red=20,
              idelpro=900.0, idelt=900.0, pad_to=32, dtype=torch.float64,
              device="cpu")

    def inputs(ms):
        rng = np.random.default_rng(0)
        n = ms.n_pad
        frc = dict(wswave=8.0 + 4.0 * rng.random(n),
                   wdwave=rng.random(n) * 2.0 * np.pi,
                   aird=np.full(n, 1.225), wstar=np.zeros(n),
                   cicover=np.zeros(n))
        fl1 = np.asarray(preset.mstart(ms.tb, frc["wswave"],
                                       frc["wdwave"]), np.float64)
        stress = {k: v.numpy() for k, v in
                  tstepper.initial_stress(ms, frc).items()}
        return fl1, frc, stress

    def run(mesh, outdir):
        ms = tsetup.build_model(**KW, weights_mode="fused")
        fl1, frc, stress = inputs(ms)
        sm = sharded.build_sharded_model(ms, mesh)
        rows, tail = sm.put_rows(fl1)
        s6 = sm.put_stress6(stress)
        frc6 = sm.put_forcing(frc)
        for _ in range(2):
            rows, tail, s6 = sm.step_rows(rows, tail, s6, frc6)
        parts = sm.rows_to_parts(rows, tail)
        st = {k: sm.state_parts(s6, i)
              for i, k in enumerate(sharded.ipk.STRESS_KEYS)}
        multihost.save_sharded_restart(outdir, "FUSED", sm, parts, st)
        swh = [4.0 * torch.sqrt(torch.einsum(
            "kmn,m->n", p, torch.as_tensor(ms.tb.dfim))) for p in parts]
        norms = sm.norms_device(swh)
        fused_bytes = sm.halo_bytes

        mc = tsetup.build_model(**KW, weights_mode="cached")
        sc = sharded.build_sharded_model(mc, mesh)
        f = sc.device_put(fl1)
        frc_s = {k: sc.device_put(v) for k, v in frc.items()}
        sts = {k: sc.device_put(v) for k, v in stress.items()}
        f, state = sc.step_full(f, frc_s, sts)
        multihost.save_sharded_restart(
            outdir, "CACHED", sc, f, {k: state[k] for k in sts})
        return norms, fused_bytes, sc.halo_bytes
""").replace('"FUSED"', repr(FUSED)).replace('"CACHED"', repr(CACHED))

CHILD = COMMON + textwrap.dedent("""
    import sys
    torch.set_num_threads(1)
    pid, port, outdir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    multihost.init_distributed(f"localhost:{port}", 2, pid,
                               backend="gloo", timeout_s=GROUP_TIMEOUT_S)
    mesh = multihost.make_point_mesh(["cpu", "cpu"])
    assert mesh.n_shards == 4 and mesh.multiprocess, mesh
    assert mesh.local == ((0, 1) if pid == 0 else (2, 3)), mesh
    norms, fb, cb = run(mesh, outdir)
    assert fb > 0 and cb > 0, (fb, cb)
    print(f"child {pid} norms {norms!r}", flush=True)
    multihost.shutdown()
    print(f"child {pid} wrote shards OK", flush=True)
""").replace("GROUP_TIMEOUT_S", str(GROUP_TIMEOUT_S))


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    p = s.getsockname()[1]
    s.close()
    return p


def test_two_process_halo_and_restart(tmp_path):
    port = _free_port()
    script = tmp_path / "child.py"
    script.write_text(CHILD)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [ROOT] + os.environ.get("PYTHONPATH", "")
                   .split(os.pathsep)))
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(pid), str(port), str(tmp_path)],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for pid in range(2)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, _ = p.communicate()
            out += "\n[timed out]"
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"child {pid} failed:\n{out[-3000:]}"
        assert f"child {pid} wrote shards OK" in out

    # the same runs in one process, on the same 4 shards
    ns = {}
    exec(compile(COMMON, "common", "exec"), ns)
    one = tmp_path / "one"
    norms, _, _ = ns["run"](multihost.make_point_mesh(["cpu"] * 4),
                            str(one))
    ms = tsetup.build_model(**ns["KW"], weights_mode="fused")
    for date in (FUSED, CACHED):
        fl1_g, stress_g = multihost.load_sharded_restart(str(tmp_path),
                                                         date, ms.n_pad)
        fl1_1, stress_1 = multihost.load_sharded_restart(str(one), date,
                                                         ms.n_pad)
        assert np.isfinite(fl1_g).all()
        np.testing.assert_array_equal(fl1_g, fl1_1)
        for k in stress_1:
            np.testing.assert_array_equal(stress_g[k], stress_1[k])
    # the group's all_reduce norms: each child's are the one process's
    # (the sum in another order: the average to rounding)
    for pid, out in enumerate(outs):
        line = next(ln for ln in out.splitlines()
                    if ln.startswith(f"child {pid} norms "))
        got = ast.literal_eval(line.split(" norms ", 1)[1])
        assert got["count"] == norms["count"] == 288
        assert got["minimum"] == norms["minimum"]
        assert got["maximum"] == norms["maximum"]
        np.testing.assert_allclose(got["average"], norms["average"],
                                   rtol=1e-13)
    # and the restart is the fused trajectory of one device
    fl1, frc, stress = ns["inputs"](ms)
    fl1_f, _ = multihost.load_sharded_restart(str(tmp_path), FUSED,
                                              ms.n_pad)
    fp = FusedPropagation(ms)
    frc_t = {k: torch.as_tensor(v) for k, v in frc.items()}
    env2d, denv, frc6, s6 = fp.build_phys_srl(
        frc_t, {k: torch.as_tensor(v) for k, v in stress.items()})
    sm1 = sharded.build_sharded_model(ms, multihost.make_point_mesh(["cpu"]))
    rows, tail = sm1.put_rows(fl1)
    f, t = rows[0], tail[0]
    for _ in range(2):
        f = fp.advect_srl(f)
        f, s6, t = fp.phys_srl(f, s6, frc6, denv, env2d, t)
    want = sm1.rows_to_compact([f], [t])
    n = ms.n_real
    np.testing.assert_array_equal(fl1_f[..., :n], want[..., :n])
