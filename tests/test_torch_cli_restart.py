"""A restart written by the port's CLI resumes in the reference's.

The port runs ``test_torch_cli.three_h`` (the 12° YAML of
``test_config_cli.py`` for 3 h from a forcing file, the 2 h restart,
second order on); the
reference CLI, on its fast path as in ``test_torch_cli_reference.py``,
resumes from the port's 2 h restart to 3 h, and its 3 h statistics agree
with the port's within STATS_RTOL of each entry's largest magnitude.
"""

import os

from test_torch_cli import forcing_file, leg2, port_run, three_h
from test_torch_cli_reference import (STATS_RTOL, ref_run,  # noqa: F401
                                      reference_fast_path, same_stats)


def test_reference_resumes_port_restart(tmp_path, reference_fast_path):
    frc = forcing_file(tmp_path)
    _, want = port_run(three_h(frc), tmp_path / "port")
    rst = "restart_20230101020000.npz"
    os.makedirs(tmp_path / "ref_from_port")
    os.link(tmp_path / "port" / rst, tmp_path / "ref_from_port" / rst)
    model, got = ref_run(leg2(frc), tmp_path / "ref_from_port")
    assert isinstance(model, reference_fast_path)
    assert model.timers.steps == 4
    same_stats(got, want, STATS_RTOL, dates={"20230101030000"})
