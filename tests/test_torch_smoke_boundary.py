"""``chip_smoke.py``'s phase 10 (nesting through the CLI, coupling,
assimilation, ``phys_srl_chunked``) rehearsed on the CPU at a small size:
O24 → O48 in place of O160 → O320 (12 directions, 15 frequencies, 12
advected), O24 at 12×25/20 in place of O320 36×36/29, 200 observations;
the card's limits, no kernel launches to count here."""

import torch

import chip_smoke


def test_smoke_boundary_phase_on_cpu():
    small = dict(directions=12, frequencies=12, physics_frequencies=15,
                 adv=900, phys=1800)
    out = chip_smoke.boundary_phase(
        torch.device("cpu"), coarse=dict(small, grid="O24"),
        fine=dict(small, grid="O48"),
        o320=dict(grid_name="O24", nang=12, nfre=25, nfre_red=20,
                  pad_to=64),
        nobs=200, check_points=500, chunk=512, launches=False)
    nest = out["nest"]
    assert nest["rim_points"] > nest["coarse_points"] > 10
    assert nest["rim_ms"] > 0.0 and nest["step_ms"] > 0.0
    assert set(nest["times"]) == {"rim", "intspec", "round_trip"}
    cpl = out["coupling"]
    assert cpl["sanity"]["tau_share"] >= 0.95
    assert set(cpl["times"]) == {"push_atmosphere", "advance_8",
                                 "push_ocean", "advance_8b",
                                 "wave_to_atmosphere", "wave_to_ocean"}
    da = out["assimilation"]
    assert da["oi_err"] <= chip_smoke.OI_CHECK_TOL
    assert da["swh_err"] <= chip_smoke.WAMASSI_SWH_RTOL
    ch = out["chunked"]
    assert ch["same"] or ch["err"] <= chip_smoke.RIM_TOL
