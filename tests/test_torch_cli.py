"""The port's command line (``python -m ecwam_tpu_torch``) against the
reference's, on the CPU.

  * ``preproc``/``preset``/``run`` with ``--device cpu`` in a subprocess
    on ``test_config_cli.py``'s 12° YAML (second order on, the default):
    12 statistics lines, GRIB output and the 2 h restart, with ``jax``
    and ``ecwam_tpu`` blocked from importing;
  * a run resumed from the port's own mid-run restart equals the
    uninterrupted run exactly (the comparisons with the reference's CLI
    are ``test_torch_cli_reference.py`` and ``test_torch_cli_restart.py``);
  * the namelist config, the CHECKCFL abort, ``--validate``, the SIGTERM
    restart and resume (as ``test_signal_stop.py``), the FDB output and
    the refusals (an unknown weight mode; the swell trains and u* forcing
    on the fused route; nesting and ``bouint`` are
    ``test_torch_nesting.py``'s);
  * ``weights_mode: cached`` and ``otf`` (the dense ``WaveModel``) with
    the swell-train fields: statistics.log against the reference's CLI,
    which takes its own ``WaveModel`` on the CPU for these modes, within
    1e-5 of each entry, and the train fields in the GRIB output;
  * ``chip_smoke.py``'s CLI phase rehearsed at a small size;
  * ``run --trace FILE`` writes the run's spans as a Chrome trace.
"""

import dataclasses
import datetime as dt
import json
import os
import signal
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

from ecwam_tpu.cli import main as j_cli
from ecwam_tpu_torch.cli import checks as t_checks
from ecwam_tpu_torch.cli import main as t_cli
from ecwam_tpu_torch.config.schema import RunConfig
from ecwam_tpu_torch.io import forcing as t_forcing
from ecwam_tpu_torch.io import grib as t_grib
from ecwam_tpu_torch.io import multio as t_multio

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the CLI's processes at a 12° size need no more than one thread each;
# the tier-1 run shares the machine's cores among 6 workers
ONE_THREAD = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")

# test_config_cli.py's RUN_CFG
RUN_CFG = """
grid:        12.0
directions:  12
frequencies: 15
bathymetry:  aqua
advection:
    timestep: 900
physics:
    timestep: 900
begin: 2023-01-01 00:00:00
end:   2023-01-01 02:00:00
forcings:
    at:
      - begin: 2023-01-01 00:00:00
        end:   2023-01-01 02:00:00
        timestep: 01:00
output:
    fields:
        name: [swh, mwd, mwp, wind]
        at:
          - timestep: 01:00
    restart:
        at:
          - time: 2023-01-01 02:00:00
"""



def forcing_file(tmp_path) -> str:
    """Hourly analytic winds for 0-3 h in a forcing file: a run resumed
    at 2 h reads the winds of the uninterrupted run (the synthetic
    fallback indexes its records from the run's own begin)."""
    path = str(tmp_path / "forcing.npz")
    t_forcing.synthetic_forcing_file(
        [20230101000000 + 10000 * h for h in range(4)]).save(path)
    return path


def three_h(frc: str) -> str:
    """A 3 h run from the forcing file ``frc``: the 2 h restart, and the
    end at 3 h."""
    return RUN_CFG.replace("end:   2023-01-01 02:00:00",
                           "end:   2023-01-01 03:00:00").replace(
        "        end:   2023-01-01 02:00:00",
        "        end:   2023-01-01 03:00:00").replace(
        "forcings:\n", f"forcings:\n    file: {frc}\n")


def leg2(frc: str) -> str:
    """The second leg of :func:`three_h`, resumed from the 2 h restart."""
    return three_h(frc).replace("begin: 2023-01-01 00:00:00\nend",
                                "begin: 2023-01-01 02:00:00\nend")


def _cfg(text=RUN_CFG, **repl):
    for k, v in repl.items():
        text = text.replace(k, v)
    return RunConfig.from_yaml(text)


def _blocked_cli(*args):
    """``python -m ecwam_tpu_torch ...`` with jax and ecwam_tpu blocked."""
    code = ("import runpy, sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['ecwam_tpu'] = None\n"
            f"sys.argv = ['ecwam_tpu_torch', *{list(args)!r}]\n"
            "runpy.run_module('ecwam_tpu_torch', run_name='__main__')\n")
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=ROOT, timeout=300, env=ONE_THREAD)


def test_cli_end_to_end(tmp_path):
    cfgfile = tmp_path / "cfg.yml"
    cfgfile.write_text(RUN_CFG)
    rundir = str(tmp_path / "run")
    for cmd in ("preproc", "preset", "run"):
        r = _blocked_cli(cmd, "--config", str(cfgfile), "--rundir", rundir,
                         "--device", "cpu")
        assert r.returncode == 0, r.stderr
    assert os.path.exists(os.path.join(rundir, "wam_grid_tables.npz"))
    assert "resumed from" in r.stdout
    lines = [ln for ln in open(os.path.join(rundir, "statistics.log"))
             if not ln.startswith("#")]
    # 3 output dates (0h,1h,2h) × 4 fields
    assert len(lines) == 12, lines
    for p in (ln.split() for ln in lines if ln.split()[2] == "swh"):
        assert 0.0 < float(p[3]) < 20.0
    assert os.path.exists(os.path.join(rundir, "restart_20230101020000.npz"))
    msgs = t_grib.read_messages(os.path.join(rundir,
                                             "MPP20230101020000.grib"))
    assert len(msgs) == 4


def test_cli_without_device_needs_the_card(tmp_path):
    cfgfile = tmp_path / "cfg.yml"
    cfgfile.write_text(RUN_CFG)
    r = _blocked_cli("run", "--config", str(cfgfile), "--rundir",
                     str(tmp_path / "run"))
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert r.returncode != 0
    assert "CUDA is not available" in r.stderr


NAMELIST = """
&NALINE
  CLDOMAIN = "12.0",
  NANG = 12, NFRE = 15,
  CBPLTDT = "20230101000000", CEPLTDT = "20230101010000",
  IDELPRO = 900, IDELT = 900, IDELINT = 1800,
  LSECONDORDER = T, LGRIBOUT = T,
  GFLAG(1)=T, GFLAG(2)=T, NFLAG(1)=T, NFLAG(2)=T,
/
"""


def port_run(text, rundir):
    return t_cli.run_model(RunConfig.from_yaml(text), str(rundir),
                           quiet=True, device="cpu")


def test_resume_equals_uninterrupted(tmp_path):
    """The 2 h restart resumed to 3 h ends equal to the 3 h run, in fl1
    and all six stress fields, exactly."""
    frc = forcing_file(tmp_path)
    full, _ = port_run(three_h(frc), tmp_path / "full")
    rst = "restart_20230101020000.npz"
    os.makedirs(tmp_path / "leg2")
    os.link(tmp_path / "full" / rst, tmp_path / "leg2" / rst)
    resumed, _ = port_run(leg2(frc), tmp_path / "leg2")
    assert resumed.timers.steps == 4
    np.testing.assert_array_equal(resumed.fl1.numpy(), full.fl1.numpy())
    for k, v in full.stress.items():
        np.testing.assert_array_equal(resumed.stress[k].numpy(), v.numpy(),
                                      err_msg=k)


def test_namelist_config_runs(tmp_path):
    f = tmp_path / "wam_namelist"
    f.write_text(NAMELIST)
    cfg = t_cli.load_config(str(f))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        j_cli.load_config(str(f)))
    assert cfg.grid == "12.0" and cfg.adv_timestep == 900.0
    _, log = t_cli.run_model(cfg, str(tmp_path / "run"), quiet=True,
                             device="cpu")
    names = {e["name"] for e in log.entries}
    assert {"swh", "mwd"} <= names
    assert len({e["time"] for e in log.entries}) == 3


def test_checkcfl_aborts(tmp_path):
    cfg = _cfg(**{"timestep: 900": "timestep: 90000"})
    with pytest.raises(RuntimeError, match="CFL-CRITERION NOT FULFILLED"):
        t_cli.run_model(cfg, str(tmp_path), quiet=True, device="cpu")


def test_validate(tmp_path):
    cfgfile = tmp_path / "cfg.yml"
    good = RUN_CFG + "validation:\n    single_precision:\n"
    cfgfile.write_text(good)
    rundir = str(tmp_path / "run")
    assert t_cli.main(["run", "--config", str(cfgfile), "--rundir", rundir,
                       "--device", "cpu", "--validate"]) == 0
    # a recorded swh average the run cannot give fails validation
    cfgfile.write_text(good + "      - name: swh\n"
                              "        time: 20230101020000\n"
                              "        average: 99.0\n")
    assert t_cli.main(["validate", "--config", str(cfgfile),
                       "--rundir", rundir]) == 1


def test_fdb_output(tmp_path):
    cfg = RunConfig.from_dict(dict(
        grid="12.0", directions=12, frequencies=25, bathymetry="aqua",
        begin="20220101000000", end="20220101003000",
        advection={"timestep": 1800}, physics={"timestep": 1800},
        output={"fields": {"name": ["swh", "mwp"], "format": "fdb",
                           "at": [{"timestep": 1800}]}}))
    t_cli.run_model(cfg, str(tmp_path), quiet=True, device="cpu")
    db = t_multio.FdbLite(str(tmp_path / "fdb"))
    assert any(k["param"] == "swh" for k in db.list_keys())
    assert len(db.retrieve(param="swh")) >= 1


SIG_CFG = textwrap.dedent("""
    grid:        12.0
    directions:  12
    frequencies: 15
    bathymetry:  aqua
    advection:
        timestep: 900
    physics:
        timestep: 900
    begin: 2023-01-01 00:00:00
    end:   2023-01-03 00:00:00
    output:
        fields:
            name: [swh]
            format: binary
            at:
              - timestep: 01:00
""")

SIG_CHILD = textwrap.dedent("""
    import sys
    from ecwam_tpu_torch.config.schema import RunConfig
    from ecwam_tpu_torch.cli.main import run_model
    cfg = RunConfig.from_yaml(sys.argv[1])
    print("loop-start", flush=True)
    run_model(cfg, sys.argv[2], device="cpu")
    print("loop-done", flush=True)
""")


def test_sigterm_writes_restart_and_resumes(tmp_path):
    cfgf = tmp_path / "run.yml"
    cfgf.write_text(SIG_CFG)
    child = tmp_path / "child.py"
    child.write_text(SIG_CHILD)
    rundir = tmp_path / "run"
    env = dict(ONE_THREAD, PYTHONPATH=os.pathsep.join(
        [ROOT] + os.environ.get("PYTHONPATH", "").split(os.pathsep)))
    p = subprocess.Popen([sys.executable, str(child), str(cfgf),
                          str(rundir)], env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
    t0 = time.time()
    line = ""
    while time.time() - t0 < 120:
        line = p.stdout.readline()
        if "loop-start" in line or not line:
            break
    assert "loop-start" in line, "model loop never started"
    # the handler is installed before the model is built: a signal
    # during set-up stops the run after its first step
    time.sleep(1)
    p.send_signal(signal.SIGTERM)
    try:
        out = p.communicate(timeout=120)[0]
    except subprocess.TimeoutExpired:
        p.kill()
        out = p.communicate()[0]
    assert p.returncode == 0, f"child rc={p.returncode}:\n{out[-2000:]}"
    assert "signal received" in out, out[-2000:]
    assert "loop-done" in out
    rsts = sorted(f for f in os.listdir(rundir) if f.startswith("restart_"))
    assert rsts, os.listdir(rundir)
    info = open(rundir / "waminfo").read()
    date14 = rsts[-1][len("restart_"):len("restart_") + 14]
    assert date14 in info

    # resume: begin at the checkpoint date, two more steps
    d = dt.datetime.strptime(date14, "%Y%m%d%H%M%S")
    cfg2 = SIG_CFG.replace("begin: 2023-01-01 00:00:00",
                           f"begin: {d:%Y-%m-%d %H:%M:%S}").replace(
        "end:   2023-01-03 00:00:00",
        f"end:   {d + dt.timedelta(seconds=1800):%Y-%m-%d %H:%M:%S}")
    model, _ = t_cli.run_model(RunConfig.from_yaml(cfg2), str(rundir),
                               quiet=True, device="cpu")
    assert model.timers.steps == 2
    assert np.isfinite(model.swh()).all()


@pytest.mark.parametrize("case", ["weights_mode", "trains", "ustar"])
def test_refusals(tmp_path, case):
    if case == "ustar":
        # u* forcing runs in the dense WaveModel only, as in the reference
        from ecwam_tpu_torch.model import driver, setup
        ms = setup.build_model(grid_name="12.0", nang=12, nfre=15,
                               icode_wnd=1, device="cpu")
        with pytest.raises(NotImplementedError, match="icode_wnd"):
            driver.FastWaveModel(ms, driver.constant_wind_forcing(ms.n_real),
                                 "20230101000000")
        return
    text = {"weights_mode": RUN_CFG + "weights_mode: dense\n",
            "trains": RUN_CFG.replace("[swh, mwd, mwp, wind]",
                                      "[swh, p042]")}[case]
    err, match = {"weights_mode": (ValueError, "weights_mode"),
                  "trains": (NotImplementedError,
                             "per-bin windsea mask")}[case]
    with pytest.raises(err, match=match):
        t_cli.run_model(RunConfig.from_yaml(text), str(tmp_path),
                        quiet=True, device="cpu")


@pytest.mark.parametrize("mode", ["cached", "otf"])
def test_dense_weights_modes_match_reference(tmp_path, mode):
    from test_torch_cli_reference import WIDE_FIELDS, ref_run, same_stats
    from test_torch_cli_reference import wide
    from ecwam_tpu_torch.model import driver
    frc = forcing_file(tmp_path)
    fields = WIDE_FIELDS + list(t_checks.TRAINS)
    text = wide(three_h(frc)).replace(", ".join(WIDE_FIELDS),
                                      ", ".join(fields))
    text += f"weights_mode: {mode}\n"
    model, got = port_run(text, tmp_path / "port")
    assert type(model) is driver.WaveModel
    assert model.setup.weights_mode == mode and model.setup.fused is None
    ref, want = ref_run(text, tmp_path / "ref")
    assert type(ref).__name__ == "WaveModel"
    assert len(got.entries) == 3 * len(fields)
    same_stats(got, want, 1e-5)
    trains = {e["name"] for e in got.entries if e["name"] in t_checks.TRAINS
              and e["maximum"] > 0.0}
    assert {"p042", "p043", "p044"} <= trains
    msgs = t_grib.read_messages(str(tmp_path / "port" /
                                    "MPP20230101030000.grib"))
    assert len(msgs) == len(fields)


def test_smoke_cli_phase_on_cpu():
    """``chip_smoke.py``'s CLI phase, rehearsed on the CPU at a small size
    (the card's limits; no kernel launches to count here): the 12° runs,
    the resumed runs equal bit for bit, the O24 run's statistics, the
    second-order timing and the products against float64."""
    import torch
    import chip_smoke
    out = chip_smoke.cli_phase(
        torch.device("cpu"), rows=200, launches=False,
        full=dict(grid="O24", directions=12, frequencies=12,
                  physics_frequencies=15, adv=900, phys=1800))
    assert out["small_stats"] == 0.0          # plain on both sides here
    assert out["timers"].dates == 6
    fields = out["products"]["fields"]
    assert set(fields) == set(t_checks.FIELDS)
    assert max(v[0] for v in fields.values()) <= chip_smoke.PRODUCT_TOL
    assert out["secspom_ms"] > 0.0


def test_run_trace_writes_the_spans(tmp_path):
    """``run --trace FILE``: every step's ``advect`` and ``phys``, each
    output date's stages with the second order inside the products, the
    restart and the set-up, as complete events of a Chrome trace, with
    the totals beside them."""
    cfgfile = tmp_path / "cfg.yml"
    cfgfile.write_text(RUN_CFG)
    path = tmp_path / "trace.json"
    rundir = tmp_path / "run"
    assert t_cli.main(["run", "--config", str(cfgfile), "--rundir",
                       str(rundir), "--device", "cpu", "--trace",
                       str(path)]) == 0
    assert (rundir / "statistics.log").exists()
    doc = json.loads(path.read_text())
    ev = doc["traceEvents"]
    assert all(e["ph"] == "X" and e["dur"] >= 0 for e in ev)
    count = {}
    for e in ev:
        count[e["name"]] = count.get(e["name"], 0) + 1
    # 2 h of 900 s steps, output at 0, 1 and 2 h, new winds at 1 and 2 h
    assert count == {
        "setup.tables": 1, "setup.upload": 1, "model.init": 1,
        "advect": 8, "phys": 8, "newwind": 2, "newwind.forcing": 2,
        "newwind.upload": 2, "newwind.rows": 2, "output.products": 3,
        "output.secondorder": 3, "output.d2h": 3, "output.write": 3,
        "restart": 1}
    parents = {e["name"]: e["args"].get("parent") for e in ev}
    assert parents["output.secondorder"] == "output.products"
    assert parents["newwind.upload"] == "newwind"
    assert parents["advect"] is None
    totals = doc["otherData"]["totals"]
    assert totals["advect"]["count"] >= 8 and totals["phys"]["host_s"] > 0
