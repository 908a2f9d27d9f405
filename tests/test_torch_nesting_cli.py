"""Boundary nesting through the port's command line against the
reference's, on the CPU: tests/test_nesting.py's coarse→fine case (a 12°
coarse run writes the boundary spectra of the rectangle [-24, 24] ×
[60, 120] at its output dates; a 6° fine run reads them from its run
directory and overwrites its rim after every step), 12×25, 1 h:

  * on each route of the port's CLI: ``weights_mode: fused``, its
    default (``FastWaveModel``, the rim written in place in the SRL rows
    and tail), against the reference's default on the CPU (its dense
    ``WaveModel`` in ``fused`` weights: the same advection and physics,
    the state kept compact between steps), and ``cached``/``otf`` (the
    port's dense ``WaveModel``) against the reference's ``WaveModel`` on
    cached weights (its OTF weights are the same numbers);
  * the coarse boundary files agree within 1e-6 of the largest record
    value (the means within 1e-6 relative), the fine rim spectra within
    1e-5 of their largest value and the statistics within 1e-5 of each
    entry (the limit of tests/test_torch_cli_reference.py);
  * ``bouint``'s output (to 15 min) equal to the reference's: the dates,
    the float32 records and the means within 1e-12.
"""

import os
import shutil

import numpy as np
import pytest

from ecwam_tpu.cli import main as j_cli
from ecwam_tpu.config.schema import RunConfig as JRunConfig
from ecwam_tpu_torch.cli import main as t_cli
from ecwam_tpu_torch.config.schema import RunConfig as TRunConfig
from ecwam_tpu_torch.model import nesting as tn

from test_torch_cli_reference import same_stats

RECT = [-24.0, 24.0, 60.0, 120.0]
BASE = dict(
    grid="12.0", directions=12, frequencies=25, bathymetry="aqua",
    begin="20220101000000", end="20220101010000",
    advection={"timestep": 1800}, physics={"timestep": 1800},
    output={"fields": {"name": ["swh"], "format": "binary",
                       "at": [{"timestep": 1800}]}})
STATS_RTOL = 1e-5


def _run(cfg, rundir, port):
    if port:
        return t_cli.run_model(TRunConfig.from_dict(cfg), str(rundir),
                               quiet=True, device="cpu")
    return j_cli.run_model(JRunConfig.from_dict(cfg), str(rundir),
                           quiet=True)


def _coarse_fine(tmp_path, mode, port):
    """The coarse run, then the fine run reading the coarse file from its
    own run directory (a relative path), in weight mode ``mode`` (None:
    the CLI's default); returns (coarse file, fine model, fine statistics
    log)."""
    side = "port" if port else "ref"
    extra = {} if mode is None else {"weights_mode": mode}
    crun, frun = tmp_path / f"{side}_coarse", tmp_path / f"{side}_fine"
    _run({**BASE, **extra, "nesting": {"coarse": {"rect": RECT}}}, crun,
         port)
    bc = str(crun / "wam_boundary.npz")
    os.makedirs(frun)
    shutil.copy(bc, frun / "coarse.npz")
    model, log = _run({**BASE, **extra, "grid": "6.0",
                       "nesting": {"fine": {"file": "coarse.npz"}}}, frun,
                      port)
    return bc, model, log


def _rim(model, bc):
    from ecwam_tpu.core import spectral
    from ecwam_tpu.model import nesting as jn
    bf = jn.BoundaryFile(bc, spectral.build_spectral_tables(12, 25))
    ft = jn.fine_boundary(model.setup.grid, model.setup.blk,
                          bf.coarse_boundary())
    return np.asarray(model.fl1, np.float64)[..., ft.idx], ft


def _same_file(got, want, tol=1e-6):
    g, w = np.load(got), np.load(want)
    assert sorted(g.files) == sorted(w.files)
    for k in ("dates", "lat", "lon", "s", "rect", "fr", "th"):
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    assert g["spec"].dtype == w["spec"].dtype == np.float32
    np.testing.assert_allclose(g["spec"], w["spec"], rtol=0,
                               atol=tol * np.abs(w["spec"]).max())
    for k in ("em", "fm", "thq"):
        np.testing.assert_allclose(g[k], w[k], rtol=tol, err_msg=k)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's coarse and fine runs, by weight mode."""
    return {mode: _coarse_fine(tmp_path_factory.mktemp("ref"), mode, False)
            for mode in (None, "cached")}


@pytest.mark.parametrize("mode", [None, "cached", "otf"])
def test_nesting_coarse_to_fine_matches_reference(tmp_path, reference,
                                                  mode):
    bc_t, m_t, log_t = _coarse_fine(tmp_path, mode, True)
    bc_j, m_j, log_j = reference[mode and "cached"]
    assert type(m_t).__name__ == ("WaveModel" if mode else "FastWaveModel")
    assert m_t.setup.weights_mode == (mode or "fused")
    assert type(m_j).__name__ == "WaveModel"
    assert np.load(bc_t)["dates"].size == 2
    _same_file(bc_t, bc_j)
    rim_t, ft = _rim(m_t, bc_t)
    rim_j, _ = _rim(m_j, bc_j)
    assert np.isfinite(rim_t).all() and rim_t.max() > 0.0
    np.testing.assert_allclose(rim_t, rim_j, rtol=0,
                               atol=STATS_RTOL * np.abs(rim_j).max())
    # the rim as the port wrote it: its own read path gives the same
    np.testing.assert_array_equal(
        m_t.take_points(ft.idx).numpy(), m_t.fl1.numpy()[..., ft.idx])
    assert len(log_t.entries) == len(log_j.entries) == 3
    same_stats(log_t, log_j, STATS_RTOL)


def test_bouint_matches_reference(tmp_path):
    _run({**BASE, "nesting": {"coarse": {"rect": RECT}}}, tmp_path, True)
    src = str(tmp_path / "wam_boundary.npz")
    out_t, out_j = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    assert t_cli.main(["bouint", "--input", src, "--output", out_t,
                       "--timestep", "900", "--device", "cpu"]) == 0
    assert j_cli.main(["bouint", "--input", src, "--output", out_j,
                       "--timestep", "900"]) == 0
    g, w = np.load(out_t), np.load(out_j)
    np.testing.assert_array_equal(g["dates"], w["dates"])
    assert g["dates"].size == 3
    np.testing.assert_array_equal(g["spec"], w["spec"])
    for k in ("em", "fm", "thq"):
        np.testing.assert_allclose(g[k], w[k], rtol=1e-12, err_msg=k)
    # the interpolated file reads back at its own dates as stored
    from ecwam_tpu_torch.core import spectral
    bf = tn.BoundaryFile(out_t, spectral.build_spectral_tables(12, 25),
                         device="cpu")
    np.testing.assert_array_equal(bf.at("20220101004500")[0].numpy(),
                                  g["spec"][1].astype(np.float64))


def test_bouint_runs_on_the_card_by_default(tmp_path):
    """Without ``--device`` the program asks for the card, and fails
    where CUDA is absent instead of running on the host."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _run({**BASE, "nesting": {"coarse": {"rect": RECT}}}, tmp_path, True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_cli.main(["bouint", "--input", str(tmp_path / "wam_boundary.npz"),
                    "--output", str(tmp_path / "o.npz"),
                    "--timestep", "900"])
