"""``chip_smoke.py``'s phase 12 (the multi-device slice) rehearsed on the
CPU at a small size: O24 at 36×20/16 in place of O320 36×36/29 (and
144×20/16 for kernel B past 128 directions), the cached model on the
golden 12° grid, gloo in place of NCCL at world size 1; the card's
limits, no kernel launches to count or time here."""

import torch

import chip_smoke


def test_smoke_sharded_phase_on_cpu():
    out = chip_smoke.sharded_phase(
        torch.device("cpu"),
        over=dict(grid_name="O24", nfre=20, nfre_red=16, pad_to=64),
        launches=False)
    for k in chip_smoke.SHARD_COUNTS:
        r = out["fused"][k]
        assert r["bit_for_bit"], k
        assert r["halo_bytes_step"] > 0 and r["rows"] > 0
    assert out["advect"][0] <= chip_smoke.ADVECT_TOL
    assert out["implsch"]["n_off"] == 0
    for name, r in out["cached"].items():
        assert r["fl1"] <= chip_smoke.TRAJ_TOL, name
    assert out["nccl"]["rel"] <= 1e-12
    for mode in ("minimal", "full"):
        r = out["wide"][mode]
        assert r["n_off"] == 0 and r["spec_rel"] <= chip_smoke.PHYS_TOL
