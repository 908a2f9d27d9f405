"""The frozen work counters against ``chip_smoke.py``'s: the operations
of kernel B's chain equal ``chip_smoke.implsch_ops`` (the physics
configuration built by the reference); the bytes of a CTU pass equal
``chip_smoke.advect_bytes`` less the tables of the kernel that ran
(counted on the SRL rows, as chip_smoke counts)."""

import os
import sys

import pytest
import torch

from wavebench import work
from wavebench.reference.ecw.model import setup as ref_setup

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

CONFIGS = {
    "o640_like": dict(grid_name="O24", nang=12, nfre=14, nfre_red=12,
                      idelpro=900.0, idelt=900.0, ifrelfmax=2,
                      delpro_lf=450.0, pad_to=64),
    "currents_cy49_like": dict(grid_name="O24", nang=24, nfre=29, irefra=2,
                             llgcbz0=True, llnormagam=True, idelpro=450.0,
                             idelt=900.0, pad_to=64),
}
DATA = dict(above_cut=3.25, shallow=0.0, windsea=0.375, ice=0.0625,
            gc_terms=12.5)


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("full", [False, True])
def test_implsch_ops_equal_chip_smoke(name, full):
    import chip_smoke
    from ecwam_tpu_torch.model import setup
    kw = CONFIGS[name]
    port = setup.build_model(device="cpu", **kw)
    ref = ref_setup.build_model(device="cpu", **kw)
    assert work.implsch_ops(ref.phys, kw["nang"], full, **DATA) == \
        chip_smoke.implsch_ops(port.phys, kw["nang"], full, **DATA)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_advect_bytes_are_chip_smoke_less_the_kernel_tables(name):
    import chip_smoke
    from ecwam_tpu_torch.model import setup
    from ecwam_tpu_torch.model.fusedstep import FusedPropagation
    kw = CONFIGS[name]
    ms = setup.build_model(device="cpu", **kw)
    fp = FusedPropagation(ms)
    t = fp.tabs
    nsrl, nft = t["cg_srl"].shape
    f = torch.zeros((nsrl, kw["nang"] * nft))
    irefra = kw.get("irefra", 0)
    kernel_tables = chip_smoke.nbytes(
        t["cg_land"], t["sea_own"], t["cgland"], t["geom"], t["valid"],
        t["dn_base"], t["up_base"], t["kseg"], fp.lc["rows"])
    kernel_tables += nsrl * 6 * t["ktaps"].shape[2] * 4
    if not t["obs_ones"]:
        kernel_tables += chip_smoke.nbytes(t["obs"])
    assert (work.advect_bytes(nsrl, kw["nang"], nft, nft, irefra)
            + kernel_tables) == chip_smoke.advect_bytes(fp, f, f, irefra)


def test_bound_is_the_larger_of_the_two():
    assert work.bound_s(67e12, 0) == pytest.approx(1.0)
    assert work.bound_s(0, 3.35e12) == pytest.approx(1.0)
    assert work.bound_s(67e12, 6.7e12) == pytest.approx(2.0)
