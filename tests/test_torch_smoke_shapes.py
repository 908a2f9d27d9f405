"""``chip_smoke.py``'s phase 11 (kernel B/C beyond its default build's
shapes) rehearsed on the CPU at a small size: O24 at 36×20/16 (72×20/16
for the wide build) in place of O320 36×36/29, slices of 512 rows; the
card's limits, no kernel launches to count or time here."""

import torch

import chip_smoke


def test_smoke_shapes_phase_on_cpu():
    out = chip_smoke.shapes_phase(
        torch.device("cpu"),
        over=dict(grid_name="O24", nfre=20, nfre_red=16, pad_to=64),
        rows=512, launches=False)
    assert set(out["switches"]) == set(chip_smoke.FLUX_SWITCHES)
    for sw, r in out["switches"].items():
        assert r["n_off"] == 0 and r["spec_rel"] <= chip_smoke.PHYS_TOL, sw
    zero = out["switches"]["lcflx"]["rows"]
    assert zero["tauoc"] == 0.0 and zero["phieps"] == 0.0
    w = out["wide"]
    assert w["advect"][0] <= chip_smoke.ADVECT_TOL
    assert w["minimal"]["n_off"] == 0 and w["full"]["n_off"] == 0
    assert w["full"]["compact"]["same_as_srl"]
    for key in ("ustar_options", "ustar_options_storm"):
        r = out[key]
        assert r["n_off"] == 0 and "wswave" in r["rows"], key
    assert out["nfre66"]["full"]["off_edge"] == 0
