"""The CUDA kernels against their plain versions, on an NVIDIA card.

Every test here needs a card and skips without one.  The module imports
no JAX, so that it runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_gpu.py

It also holds the JAX-free advection configurations and the JONSWAP
start that the port's CPU tests share; the golden configuration is
``ecwam_tpu_torch.model.cases``.

Tolerances, kernel against plain, both float32 on the card, each relative
to the field's maximum (PERF.md gives the readings they come from; the
same limits as chip_smoke.py):
  advection                max|k−p| ≤ ADVECT_TOL
  physics, one step        spectrum ≤ PHYS_TOL; stress rows ≤ STRESS_TOL;
                           full-mode rows ≤ FULL_ROW_TOL; windsea-mask
                           bins differ only within MASK_WIDTH of the
                           mask's edge (float64), ≤ XLLWS_SHARE of all
  4-step golden trajectory fl1 ≤ TRAJ_TOL; stress ≤ TRAJ_STRESS_TOL
  CFL current retry        the kernel's mask equals the plain version's;
                           CHECKCFL's violation count equal
  kernel A's OBS route     taken on the golden grid (obstructions), not
                           on open water
  op classes (kernel D)    equal for the layout classes, 1e-6 of max for
                           the others
  WaveModel, 4 steps       fl1 ≤ TRAJ_TOL; stress ≤ TRAJ_STRESS_TOL (each
                           weight mode, kernels A and C vs plain)
  kernel C, u* (UST)       as one physics step in full mode, the U10 row
                           ≤ STRESS_TOL (chip_smoke.check_compact)
  kernel C on chunk views  bit for bit the whole field's step
  kernel B on O320         bit for bit the digests of the kernel before
                           SNONLIN's pipeline (36 and 72 directions)
  the current refresh      on every O320 row at 24 and 36 directions the
                           card's tables equal the host GRADI's to one
                           float32 rounding (float64 on both, cast once),
                           the CFL mask identical; the refresh spans time
                           the device and ``cfl_dropped_rows`` counts the
                           mask
  the port's spans         the profiler's device operations the same
                           with them as without, none of their own;
                           StepTimers within SPAN_TOL of kernels A and
                           B's profiled time over 4 O320 steps; an
                           operator's profiler start inside its span to
                           SPAN_CLOCK_NS
With the cycle-49/50 options, a row off the limits whose
gravity-capillary decision margin (float64) lies within GC_WIDTH of its
edge is held out, at most one a grid; with ISNONLIN=2 likewise a row whose
PEAK_ANG peak lies within PEAK_WIDTH of the next direction maximum.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from ecwam_tpu_torch import device as tdevice
from ecwam_tpu_torch.core import grid as grid_mod
from ecwam_tpu_torch.model import driver as tdriver
from ecwam_tpu_torch.model import preset
from ecwam_tpu_torch.model import setup as tsetup
from ecwam_tpu_torch.model import cases
from ecwam_tpu_torch.model.cases import (compact_kernel_vs_plain,
                                         full_kernel_vs_plain,
                                         golden_kernel_vs_plain, golden_kw,
                                         physics_kernel_vs_plain, shallow_kw)
from ecwam_tpu_torch.model.fusedstep import FusedPropagation
from ecwam_tpu_torch.ops import propagation_cuda as pcu
from ecwam_tpu_torch.ops.physics import implsch_cuda as ipk
from ecwam_tpu_torch.tools import opclass as oc

ADVECT_TOL = 1e-5
PHYS_TOL = 2e-5
STRESS_TOL = 1e-5
FULL_ROW_TOL = 1e-4
XLLWS_SHARE = 1e-6
MASK_WIDTH = 1e-4
TRAJ_TOL = 2.5e-4
TRAJ_STRESS_TOL = 5e-3
GC_WIDTH = 1e-4
PEAK_WIDTH = 1e-5
SPAN_TOL = 0.02
SPAN_CLOCK_NS = 100_000


def refraction_kw():
    """A 6° grid with a wavy 50–350 m bottom (tests/test_fused_pallas.py's
    depth-refraction case)."""
    grid = grid_mod.regular_grid(6.0)
    bathy = np.full((grid.ngy, grid.ngx), -999.0)
    lats = np.linspace(0, np.pi, grid.ngy)[:, None]
    lons = np.linspace(0, 2 * np.pi, grid.ngx)[None, :]
    depth = 200.0 + 150.0 * np.sin(3 * lats) * np.cos(2 * lons)
    for k in range(1, grid.ngy - 1):
        bathy[k, : grid.nlonrgg[k]] = depth[k, : grid.nlonrgg[k]]
    return dict(grid=grid, bathy=bathy, irefra=1)


ADVECT_CONFIGS = {
    "basic": dict,
    "fast_waves": lambda: dict(delpro_lf=450.0, ifrelfmax=5),
    "depth_refraction": refraction_kw,
}
ADVECT_BASE = dict(nang=12, nfre=25, idelpro=900.0, idelt=900.0, pad_to=64)


def advect_kw(name):
    kw = dict(ADVECT_BASE, **ADVECT_CONFIGS[name]())
    if "grid" not in kw:
        kw["grid_name"] = "6.0"
    return kw


def jonswap(n, tb, seed=0):
    """Compact (nang, nfre, n) JONSWAP start under random 6–12 m/s winds."""
    rng = np.random.default_rng(seed)
    return preset.mstart(tb, 6.0 + 6.0 * rng.random(n),
                         rng.random(n) * 2.0 * np.pi)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(ADVECT_CONFIGS))
def test_advect_kernel_matches_plain_on_card(cuda, name):
    ms = tsetup.build_model(device=cuda, **advect_kw(name))
    f = torch.as_tensor(jonswap(ms.n_pad, ms.tb), dtype=torch.float32,
                        device=cuda)
    fk = FusedPropagation(ms)
    fpl = FusedPropagation(ms, plain=True)
    n0 = pcu.advect.launches
    got = fk.advect_srl(fk.to_srl(f))
    assert pcu.advect.launches == n0 + fk.nsub
    want = fpl.advect_srl(fpl.to_srl(f))
    err = (got - want).abs().max() / want.abs().max()
    assert float(err) <= ADVECT_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["golden", "shallow"])
def test_advect_obs_routes_match_plain_on_card(cuda, name):
    """Kernel A with obstructions (the golden grid: the OBS route) and on
    open water (the shallow grid: no obstruction table read), a pass and a
    sub-band pass, with the CHECKCFL pass."""
    kw = golden_kw() if name == "golden" else shallow_kw()
    a = cases.advect_kernel_vs_plain(kw, cuda)
    assert a["obs"] == (name == "golden")
    assert a["main"] <= ADVECT_TOL
    assert (a["sub"] or 0.0) <= ADVECT_TOL
    assert a["diag"]["n_violations"] == a["diag_plain"]["n_violations"]


@pytest.mark.gpu
def test_state_setters_take_card_tensors(cuda):
    """Fault C1 on the card: ``m.fl1 = m.fl1`` and ``m.stress =
    m.stress`` with the model's own CUDA tensors leave the state as it
    was, and a restart from them runs on."""
    from ecwam_tpu_torch.model.driver import FastWaveModel
    ms = cases.build_model(device=cuda, **golden_kw())
    prov = cases.provider(cases.golden_forcing(ms.n_real), 900.0)
    m = FastWaveModel(ms, prov, cases.START).advance(2, wind_every=2)
    fl1, stress = m.fl1.clone(), {k: v.clone() for k, v in m.stress.items()}
    assert fl1.is_cuda
    m.fl1 = m.fl1
    m.stress = m.stress
    assert torch.equal(m.fl1, fl1)
    for k in ipk.STRESS_KEYS:
        assert torch.equal(m.stress[k], stress[k]), k
    again = FastWaveModel(ms, prov, m.date, fl1=m.fl1, stress=m.stress)
    again.advance(2, wind_every=2)
    straight = FastWaveModel(ms, prov, cases.START).advance(4, wind_every=2)
    assert torch.equal(again.fl1, straight.fl1)
    for k in ipk.STRESS_KEYS:
        assert torch.equal(again.stress[k], straight.stress[k]), k


PHYSICS_CONFIGS = {
    "golden": golden_kw,
    "no_tail": lambda: dict(grid_name="12.0", nang=12, nfre=18,
                            idelpro=900.0, idelt=1800.0, pad_to=64),
    "shallow": shallow_kw,
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(PHYSICS_CONFIGS))
def test_physics_kernel_matches_plain_on_card(cuda, name):
    """With the tail block (golden, 18 frequencies, 15 advected), without
    it (all 18 advected), and in shallow water (SDIWBK, SBOTTOM and a cut
    inside the ladder)."""
    spec, stress, _ = physics_kernel_vs_plain(PHYSICS_CONFIGS[name](), cuda)
    assert spec <= PHYS_TOL and stress <= STRESS_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(PHYSICS_CONFIGS))
def test_full_mode_kernel_matches_plain_on_card(cuda, name):
    """Full mode (output dates): the spectrum, the 30 SCAL_OUT_FULL rows
    and the windsea mask."""
    r = full_kernel_vs_plain(PHYSICS_CONFIGS[name](), cuda, width=MASK_WIDTH)
    assert r["spec"] <= PHYS_TOL
    for key, e in r["rows"].items():
        assert e <= FULL_ROW_TOL, key
    assert r["off_edge"] == 0
    assert r["xllws"] <= XLLWS_SHARE * r["bins"]


@pytest.mark.gpu
@pytest.mark.parametrize("full", [False, True])
def test_compact_kernel_matches_plain_on_card(cuda, full):
    """Kernel C, the compact (nang, nfre, n) entry, in both modes."""
    r = compact_kernel_vs_plain(golden_kw(), cuda, full=full,
                                width=MASK_WIDTH)
    assert r["spec"] <= PHYS_TOL
    assert r["rows"] <= (FULL_ROW_TOL if full else STRESS_TOL)
    assert r["off_edge"] == 0
    assert r["xllws"] <= XLLWS_SHARE * r["bins"]


CURRENTS_CONFIGS = {
    "irefra2_fast_waves": lambda: cases.currents_kw(2, fast=True),
    "irefra3_cfl_retry": lambda: cases.currents_kw(3, cfl=True),
    "golden_irefra3": lambda: golden_kw(3, currents=True),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(CURRENTS_CONFIGS))
def test_advect_currents_kernel_matches_plain_on_card(cuda, name):
    """Kernel A with current refraction: an all-band pass, a sub-band pass
    (σ̇ over ifrelfmax+1 frequencies), and the CFL retry mask, which the
    kernel computes in the setup's refresh."""
    r = cases.advect_kernel_vs_plain(CURRENTS_CONFIGS[name](), cuda)
    assert r["main"] <= ADVECT_TOL
    assert (r["sub"] or 0.0) <= ADVECT_TOL
    assert r["cfl_differ"] == 0
    if name == "irefra3_cfl_retry":
        assert r["cfl_masked"] > 0


OPTION_CONFIGS = {
    "shallow_cy50r1": (lambda: shallow_kw(options=True), cases.shallow_ice),
    "golden_cy49r1": (lambda: dict(golden_kw(), **cases.CY49R1),
                      cases.storm),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(OPTION_CONFIGS))
def test_option_physics_kernels_match_plain_on_card(cuda, name):
    """Kernels B (both modes) and C (both modes) with the cycle-49/50
    options, on the shallow grid with polar ice and the golden grid."""
    make, frc = OPTION_CONFIGS[name]
    gc = dict(forcing=frc, gc_width=GC_WIDTH, off_tol=STRESS_TOL)
    spec, stress, held = physics_kernel_vs_plain(make(), cuda, **gc)
    assert spec <= PHYS_TOL and stress <= STRESS_TOL and held <= 1
    r = full_kernel_vs_plain(make(), cuda, width=MASK_WIDTH, **gc)
    assert r["spec"] <= PHYS_TOL and r["held"] <= 1
    for key, e in r["rows"].items():
        assert e <= FULL_ROW_TOL, key
    assert r["off_edge"] == 0
    for full in (False, True):
        c = compact_kernel_vs_plain(make(), cuda, full=full,
                                    width=MASK_WIDTH, **gc)
        assert c["spec"] <= PHYS_TOL and c["off_edge"] == 0
        assert c["rows"] <= (FULL_ROW_TOL if full else STRESS_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(cases.LEGACY_CASES))
def test_legacy_physics_kernels_match_plain_on_card(cuda, name):
    """Kernels B (both modes) and C (both modes) with the rest of the
    physics: iphys=0, ISNONLIN 0/2, SDICE1/2, LSTRN and the switches."""
    c = cases.legacy_case(name)
    hold = dict(forcing=c["forcing"], phys=c["phys"], gc_width=GC_WIDTH,
                peak_width=PEAK_WIDTH, off_tol=STRESS_TOL)
    spec, stress, held = physics_kernel_vs_plain(c["kw"], cuda, **hold)
    assert spec <= PHYS_TOL and stress <= STRESS_TOL and held <= 1
    r = full_kernel_vs_plain(c["kw"], cuda, width=MASK_WIDTH, **hold)
    assert r["spec"] <= PHYS_TOL and r["held"] <= 1
    for key, e in r["rows"].items():
        assert e <= FULL_ROW_TOL, key
    assert r["off_edge"] == 0
    for full in (False, True):
        k = compact_kernel_vs_plain(c["kw"], cuda, full=full,
                                    width=MASK_WIDTH, **hold)
        assert k["spec"] <= PHYS_TOL and k["off_edge"] == 0
        assert k["rows"] <= (FULL_ROW_TOL if full else STRESS_TOL)


# Kernel B/C's option sets on the shallow grid's state: the default
# instantiation, OPTS (cy50r1 under polar ice), EXT (ISNONLIN=2 and SDICE1)
# and EXT with JAN (iphys=0); with the two modes and the two layouts, all
# 16 instantiations of the default build, and the same four at 72
# directions (the wide build, KPL = 4); full mode's three switches (EXT);
# and 66 frequencies (the wide build's shared mask)
INSTANTIATIONS = {
    "default": (shallow_kw, {}, None),
    "opts": (lambda: shallow_kw(options=True), {}, cases.shallow_ice),
    "ext": (lambda: dict(shallow_kw(), isnonlin=2), dict(lciwa1=True),
            cases.shallow_ice),
    "jan": (lambda: dict(shallow_kw(), iphys=0), {}, cases.shallow_ice),
    "wide_default": (lambda: dict(shallow_kw(), nang=72), {}, None),
    "wide_opts": (lambda: dict(shallow_kw(options=True), nang=72), {},
                  cases.shallow_ice),
    "wide_ext": (lambda: dict(shallow_kw(), nang=72, isnonlin=2),
                 dict(lciwa1=True), cases.shallow_ice),
    "wide_jan": (lambda: dict(shallow_kw(), nang=72, iphys=0), {},
                 cases.shallow_ice),
    "wide128_default": (lambda: dict(shallow_kw(), nang=128), {}, None),
    "wide128_opts": (lambda: dict(shallow_kw(options=True), nang=128), {},
                     cases.shallow_ice),
    "no_lcflx": (shallow_kw, dict(lcflx=False), None),
    "no_lstokes": (shallow_kw, dict(lstokes=False), cases.shallow_ice),
    "no_lwvflx_snl": (shallow_kw, dict(lwvflx_snl=False), None),
    "nfre66": (lambda: dict(shallow_kw(), nfre=66), {}, None),
}
# a row count that is a multiple of neither the two rows a warp takes nor
# the warps of a block (the grid's rows repeated in order: a grid row held
# out counts once per copy, hence at most 2)
ODD_ROWS = 1000 + 13


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(INSTANTIATIONS))
@pytest.mark.parametrize("full", [False, True])
def test_each_instantiation_matches_plain_on_an_odd_row_count(cuda, name,
                                                              full):
    make, phys, frc = INSTANTIATIONS[name]
    hold = dict(forcing=frc, phys=phys, gc_width=GC_WIDTH,
                peak_width=PEAK_WIDTH, off_tol=STRESS_TOL, rows=ODD_ROWS)
    if full:
        r = full_kernel_vs_plain(make(), cuda, width=MASK_WIDTH, **hold)
        assert r["n"] == ODD_ROWS
        assert r["spec"] <= PHYS_TOL and r["held"] <= 2
        for key, e in r["rows"].items():
            assert e <= FULL_ROW_TOL, key
        assert r["off_edge"] == 0
        assert r["xllws"] <= XLLWS_SHARE * r["bins"]
    else:
        spec, stress, held = physics_kernel_vs_plain(make(), cuda, **hold)
        assert spec <= PHYS_TOL and stress <= STRESS_TOL and held <= 2
    c = compact_kernel_vs_plain(make(), cuda, full=full, width=MASK_WIDTH,
                                **hold)
    assert c["n"] == ODD_ROWS and c["held"] <= 2
    assert c["spec"] <= PHYS_TOL and c["off_edge"] == 0
    assert c["rows"] <= (FULL_ROW_TOL if full else STRESS_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(INSTANTIATIONS))
def test_two_launches_give_identical_bits_and_count_once(cuda, name):
    """Kernel B twice on one input, in both modes: equal bit for bit (no
    atomics, a fixed order of every sum); each call adds exactly one to
    its launch counter."""
    make, phys, frc = INSTANTIATIONS[name]
    ms, args = cases.physics_state(make(), cuda, frc, phys, rows=ODD_ROWS)
    kw = dict(nang=ms.tb.nang, nfre_red=ms.tb.nfre_red)
    for full in (False, True):
        cfg = ms.phys if full else ipk.minimal_config(ms.phys)
        runs = []
        for _ in range(2):
            n0 = (ipk.implsch_srl.launches, ipk.implsch_srl.full_launches)
            runs.append(ipk.implsch_srl(
                cfg, args[0].clone(), args[1], args[2],
                None if args[3] is None else args[3].clone(), full=full,
                **kw))
            n1 = (ipk.implsch_srl.launches, ipk.implsch_srl.full_launches)
            assert n1 == ((n0[0], n0[1] + 1) if full
                          else (n0[0] + 1, n0[1]))
        torch.cuda.synchronize()
        for a, b in zip(*runs):
            assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("name", oc.CLASSES)
def test_opclass_kernel_matches_plain_on_card(cuda, name):
    """Kernel D, each op class at K=8 over 16,384 lanes."""
    n0 = oc.opclass.launches
    r = oc.check(name, oc.start(16384, cuda), 8)
    assert oc.opclass.launches == n0 + 1
    assert r["ok"], r


@pytest.mark.gpu
def test_currents_trajectory_matches_plain_on_card(cuda):
    err, launched = golden_kernel_vs_plain(
        cuda, kw=golden_kw(3, currents=True))
    assert launched == dict(kernels=(8, 2), plain=(0, 0))
    assert err.pop("fl1") <= TRAJ_TOL
    for key, e in err.items():
        assert e <= TRAJ_STRESS_TOL, key


@pytest.mark.gpu
def test_device_default_is_the_card(cuda):
    assert tdevice.resolve(None) == torch.device("cuda")


@pytest.mark.gpu
def test_kernel_trajectory_matches_plain_on_card(cuda):
    err, launched = golden_kernel_vs_plain(cuda)
    assert launched == dict(kernels=(8, 2), plain=(0, 0))
    assert err.pop("fl1") <= TRAJ_TOL
    for key, e in err.items():
        assert e <= TRAJ_STRESS_TOL, key


@pytest.mark.gpu
def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    ms = tsetup.build_model(device=cuda, **advect_kw("basic"))
    fp = FusedPropagation(ms)
    f = fp.to_srl(torch.as_tensor(jonswap(ms.n_pad, ms.tb),
                                  dtype=torch.float32, device=cuda))
    kw = dict(nang=fp.nang, nf=fp.nfre_red, S=ms.fused.S, EW=ms.fused.EW,
              irefra=0)
    with pytest.raises(TypeError):
        pcu.advect(f.double(), fp.tabs, fp.lc, **kw)
    with pytest.raises(ValueError):
        pcu.advect(f[:-1], fp.tabs, fp.lc, **kw)
    with pytest.raises(ValueError):
        pcu.advect(f.t().contiguous().t(), fp.tabs, fp.lc, **kw)
    with pytest.raises(ValueError):
        pcu.advect(f, fp.tabs, fp.lc, **dict(kw, nw=fp.nfre_red + 1))
    with pytest.raises(KeyError):                  # currents need uv
        pcu.advect(f, fp.tabs, fp.lc, **dict(kw, irefra=2))
    with pytest.raises(ValueError):                # taps wider than EW
        pcu.advect(f, fp.tabs, fp.lc, **dict(kw, EW=0))
    cfg = ipk.minimal_config(ms.phys)
    # u* forcing: the compact entry takes it in either mode, the SRL
    # entry refuses it
    ipk.kernel_supports(dataclasses.replace(cfg, icode_wnd=1), compact=True)
    with pytest.raises(NotImplementedError, match="icode_wnd"):
        ipk.kernel_supports(dataclasses.replace(cfg, icode_wnd=1))
    env2d = torch.zeros((3 * ms.tb.nfre, f.shape[0]), device=cuda)
    scal = torch.zeros((len(ipk.SCAL_IN), f.shape[0]), device=cuda)
    with pytest.raises(ValueError):
        ipk.implsch_srl(cfg, f, env2d[:, :-1].contiguous(), scal,
                        nang=fp.nang, nfre_red=fp.nfre_red)
    with pytest.raises(TypeError):
        ipk.implsch_srl(cfg, f, env2d.double(), scal, nang=fp.nang,
                        nfre_red=fp.nfre_red)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", cases.WEIGHT_MODES)
@pytest.mark.parametrize("config", sorted(cases.WAVEMODEL_CASES))
def test_wavemodel_kernels_match_plain_on_card(cuda, config, mode):
    err, launched, want = cases.wavemodel_kernel_vs_plain(cuda, config, mode)
    assert launched == dict(kernels=want, plain=(0, 0))
    assert err.pop("fl1") <= TRAJ_TOL
    assert max(err.values()) <= TRAJ_STRESS_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("icode", [1, 2])
def test_ustar_kernel_matches_plain_on_card(cuda, icode):
    import chip_smoke
    ms, m = cases.ustar_model(cuda, icode)
    n0 = ipk.implsch_compact.launches
    m.advance(2)
    assert ipk.implsch_compact.launches == n0 + 2
    u10 = m.state["wswave"][:ms.n_real]
    assert 6.0 < float(u10.min()) and float(u10.max()) < 25.0
    r = chip_smoke.compact_check(ms.phys, *cases.wavemodel_inputs(m),
                                 reps=1)
    chip_smoke.check_compact(r, f"UST ICODE {icode}")
    assert "wswave" in r["rows"]


# u* forcing under the default physics and with every option set: the
# UST instantiations alone, with OPTS (cy50r1), EXT (ISNONLIN=2 with
# SDICE1 and LSTRN) and EXT with JAN (iphys=0, cy49r1), on the 12° u* case
USTAR_OPTIONS = {
    "ust_default": {},
    "ust_opts": dict(cases.CY50R1),
    "ust_ext": dict(isnonlin=2),
    "ust_jan": dict(cases.CY49R1, iphys=0),
}


# SHA-256 of kernel B's inputs and outputs on every SRL row of the O320
# state after two steps (ecwam_tpu_torch/tools/implsch_digest.py), as the
# kernel wrote them before SNONLIN's step loop became a pipeline (an
# H100 80GB HBM3, built for sm_90a): 36 directions through the
# default build, 72 through the wide build (four directions a lane)
EARLIER_DIGESTS = {
    36: {"in": "0a611be9f4ac715dec82117fd9dc37a32b73b9625a2be51dcf9edd34fead9927",
         "minimal": "3a033f9a8e9a54ffa8089cf8ce668cca1efb9d6a43b03431fef01141031e9b26",
         "full": "9020a5d219def7d4fdde3992f3a4d090c5423f330285de5b3b63b68b66673c2f"},
    72: {"in": "db49590289b207dd203e72d28a5d1ba68a5be09e608a5684bf3820cf919a2fe4",
         "minimal": "092f0810030a4d9ef9cd8ab85b4f34230f03aa34f241c63de5bdcf153dcd725c",
         "full": "412463feeeb6b2bd72f86d4510b70e8db994627869543bf86b935b164b9dcff0"},
}


@pytest.mark.gpu
@pytest.mark.parametrize("nang", sorted(EARLIER_DIGESTS))
def test_kernel_b_on_o320_equals_the_earlier_kernel_bit_for_bit(cuda, nang):
    """Kernel B minimal and full on every O320 SRL row after two steps
    (the model's own kernels A and B) gives, bit for bit, what the kernel
    before the SNONLIN pipeline gave, at 36 directions and through the
    wide build at 72."""
    from ecwam_tpu_torch.tools import implsch_digest
    assert implsch_digest.digests(cuda, nang) == EARLIER_DIGESTS[nang]


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(USTAR_OPTIONS))
def test_ustar_option_instantiations_match_plain_on_card(cuda, name):
    """Kernel C under u* with the options: 2 model steps through it, then
    one step against plain in full mode (chip_smoke.check_compact) and in
    minimal mode (spectrum ≤ PHYS_TOL, the 6 stress rows and U10 ≤
    STRESS_TOL, the direction on the circle as check_compact takes it)."""
    import chip_smoke
    ms, m = cases.ustar_model(cuda, 1, **USTAR_OPTIONS[name])
    if name == "ust_ext":
        ms = cases.with_phys(ms, lciwa1=True, lstrn=True)
        m = tdriver.WaveModel(ms, m.forcing_provider, cases.START)
        m = m.newwind(m.date)
    n0 = ipk.implsch_compact.launches
    m.advance(2)
    assert ipk.implsch_compact.launches == n0 + 2
    args = cases.wavemodel_inputs(m)
    r = chip_smoke.compact_check(ms.phys, *args, reps=1)
    chip_smoke.check_compact(r, f"UST {name}")
    cfg = ipk.minimal_config(ms.phys)
    got = ipk.implsch_compact(cfg, *args)
    want = ipk.implsch_compact_plain(cfg, *args)
    keys = ipk.out_keys(cfg, False)
    assert got[1].shape[0] == len(keys) == len(ipk.SCAL_OUT_UST_MIN)
    assert float((got[0] - want[0]).abs().max()
                 / want[0].abs().max()) <= PHYS_TOL
    # the wave-stress direction on the circle over 2π: under the case's
    # uniform wind direction it is round-off around 0 in both versions
    err = cases.row_errors(got[1], want[1])
    d = (got[1][keys.index("tauwdir")] - want[1][keys.index("tauwdir")]).abs()
    err[keys.index("tauwdir")] = float(
        torch.minimum(d, 2.0 * np.pi - d).max() / (2.0 * np.pi))
    assert float(err.max()) <= STRESS_TOL


@pytest.mark.gpu
def test_compact_chunk_views_match_the_whole_field_on_card(cuda):
    """Kernel C on four chunk views of a WaveModel's state (strided, no
    copy, written in place) gives the whole field's step bit for bit."""
    ms = tsetup.build_model(device=cuda, weights_mode="cached", **golden_kw())
    m = tdriver.WaveModel(ms, cases.provider(
        cases.golden_forcing(ms.n_real), 900.0), cases.START)
    m.advance(2)
    fl1, env2d, scal = cases.wavemodel_inputs(m)
    whole = ipk.implsch_compact(ms.phys, fl1, env2d, scal, full=True)
    out = fl1.clone()
    c = ms.n_pad // 4
    n0 = ipk.implsch_compact.launches
    for s in range(0, ms.n_pad, c):
        f = out[..., s:s + c]
        assert not f.is_contiguous()
        r = ipk.implsch_compact(ms.phys, f, env2d[:, s:s + c].contiguous(),
                                scal[:, s:s + c].contiguous(), full=True,
                                out=f)
        assert torch.equal(r[1], whole[1][:, s:s + c])
        assert torch.equal(r[2], whole[2][..., s:s + c])
    assert ipk.implsch_compact.launches == n0 + 4
    assert torch.equal(out, whole[0])
    with pytest.raises(ValueError):               # a view needs its out
        ipk.implsch_compact(ms.phys, fl1[..., :c], env2d[:, :c].contiguous(),
                            scal[:, :c].contiguous(), full=True)


@pytest.mark.gpu
@pytest.mark.parametrize("nang,full", [(136, False), (144, False),
                                       (144, True), (256, False),
                                       (256, True)])
def test_wide_kernel_past_128_directions_on_card(cuda, nang, full):
    """Kernel B's wide build past 128 directions (its further passes of
    the directions, W from global memory) against plain on the golden
    grid, one step in each mode."""
    kw = dict(golden_kw(), nang=nang)
    if full:
        r = full_kernel_vs_plain(kw, cuda, width=MASK_WIDTH)
        assert r["spec"] <= PHYS_TOL
        for key, e in r["rows"].items():
            assert e <= FULL_ROW_TOL, key
        assert r["off_edge"] == 0 and r["xllws"] <= XLLWS_SHARE * r["bins"]
    else:
        spec, stress, _ = physics_kernel_vs_plain(kw, cuda)
        assert spec <= PHYS_TOL and stress <= STRESS_TOL


@pytest.mark.gpu
def test_advect_past_128_directions_on_card(cuda):
    """Kernel A at 144 directions (36 bands of four) against plain on the
    golden grid: a pass and a sub-band pass."""
    a = cases.advect_kernel_vs_plain(dict(golden_kw(), nang=144), cuda)
    assert a["main"] <= ADVECT_TOL and (a["sub"] or 0.0) <= ADVECT_TOL


@pytest.mark.gpu
def test_sharded_phase_on_card(cuda):
    """chip_smoke's phase 12 at O24 36×20/16 on the card: the sharded
    fused model on 2 and 4 shards of one card bit for bit against
    FastWaveModel with kernels A and B launched k × passes and k ×
    physics steps; the cached model in patches and bands through kernel
    C; NCCL at world size 1; kernel B at 144 directions."""
    import chip_smoke
    out = chip_smoke.sharded_phase(
        cuda, over=dict(grid_name="O24", nfre=20, nfre_red=16, pad_to=64))
    for k in chip_smoke.SHARD_COUNTS:
        assert out["fused"][k]["bit_for_bit"], k
    for name, r in out["cached"].items():
        assert r["launches"] == 16, name
    assert out["nccl"]["rel"] <= 1e-12
    for mode in ("minimal", "full"):
        assert out["wide"][mode]["n_off"] == 0


def _device_events(prof) -> list:
    cuda = torch.autograd.DeviceType.CUDA
    return [e for e in prof.profiler.kineto_results.events()
            if e.device_type() == cuda]


def _profiled(fn):
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return prof


@pytest.mark.gpu
def test_spans_put_nothing_on_the_device_timeline(cuda, monkeypatch):
    """Under the profiler (tracing on: CUDA events, NVTX ranges and
    intervals) the device operations are the ones of a run whose spans
    are no-ops, and none is named after a span; the operators of
    ``newwind.rows`` start inside its intervals (the profiler's clock)."""
    from ecwam_tpu_torch import tracing
    ms = tsetup.build_model(grid_name="12.0", nang=12, nfre=18,
                            nfre_red=15, idelpro=900.0, idelt=1800.0,
                            pad_to=64, device=cuda)

    def run():
        m = tdriver.FastWaveModel(
            ms, tdriver.constant_wind_forcing(ms.n_real), "20230101000000")
        m.advance(2)
        n = len(tracing.report()["intervals"])
        prof = _profiled(lambda: (m.newwind(m.date), m.advance(2),
                                  m.advance(2, full_phys=True)))
        return prof, tracing.report()["intervals"][n:]
    prof, iv = run()
    on = {e.name() for e in _device_events(prof)}
    rows = [(s, e) for n, _, s, e in iv if n == "newwind.rows"]
    where = [e.start_ns() for e in prof.profiler.kineto_results.events()
             if e.name() == "aten::where"]
    # the TAUW cap's one torch.where
    assert len(rows) == 1
    assert sum(rows[0][0] - SPAN_CLOCK_NS <= t <= rows[0][1] + SPAN_CLOCK_NS
               for t in where) == 1
    monkeypatch.setattr(tdriver, "span",
                        lambda *a, **k: contextlib.nullcontext())
    prof, iv = run()
    off = {e.name() for e in _device_events(prof)}
    assert iv == []
    assert on == off
    assert not [n for n in on if n.startswith("ecwam")]
    assert any("advect_kernel" in n for n in on)


@pytest.mark.gpu
def test_step_timers_match_the_profiled_kernels(cuda):
    """StepTimers' propag + phys (CUDA events, never waited on while
    stepping) against the profiler's device time of kernels A and B over
    4 steps at O320, 36×36/29, physics every step."""
    ms = tsetup.build_model(grid_name="O320", nang=36, nfre=36,
                            nfre_red=29, idelpro=450.0, idelt=450.0,
                            device=cuda)
    m = tdriver.FastWaveModel(ms, tdriver.constant_wind_forcing(
        ms.n_real, 12.0), "20230101000000")
    m.advance(2)
    t0, n0 = m.timers.propag + m.timers.phys, m.timers.steps
    prof = _profiled(lambda: m.advance(4))
    timed = m.timers.propag + m.timers.phys - t0
    kern = [e for e in _device_events(prof) if "advect_kernel" in e.name()
            or "implsch_kernel" in e.name()]
    assert len(kern) == 8 and m.timers.steps - n0 == 4
    k_s = sum(e.duration_ns() for e in kern) * 1e-9
    assert abs(timed - k_s) <= SPAN_TOL * k_s, (timed, k_s)


def _o320_currents(nang, cuda):
    """An O320 setup at ``nang`` directions (36 frequencies, 29 advected,
    irefra 2, idelpro 450 s) built with the benchmark's jet and eddies,
    and that hour's (n_real,) current field a tenth stronger and its
    eddies turned by a quarter wave."""
    grid = grid_mod.octahedral_grid(320)
    blk = grid_mod.build_sea_point_block(grid, grid_mod.aqua_bathymetry(grid))
    lat, lon = cases.point_latlon(grid, blk)
    phi, lam = np.radians(lat), np.radians(lon)

    def field(a, p):
        return (a * 0.9 * np.exp(-(lat / 8.0) ** 2)
                - 0.3 * np.cos(3 * lam + p) * np.sin(2 * phi),
                0.3 * np.sin(3 * lam + p) * np.cos(phi))
    ms = tsetup.build_model(grid=grid, nang=nang, nfre=36, nfre_red=29,
                            idelpro=450.0, idelt=900.0, pad_to=8192,
                            irefra=2, currents=field(1.0, 0.0), device=cuda)
    return ms, field(1.1, np.pi / 6)


@pytest.mark.gpu
@pytest.mark.parametrize("nang", [24, 36])
def test_refresh_on_card_equals_the_host_gradi_on_o320(cuda, nang):
    """``FusedPropagation.refresh`` on the card against the host path it
    replaced (``cases.host_refresh``: GRADI on the host in float64, the
    table cast once, the CFL pass on it), on every O320 row: the
    hour's currents, where the CFL retry drops no row, and the same with
    150 m/s at every 997th point, where it drops the rows around them."""
    ms, (u, v) = _o320_currents(nang, cuda)
    fp = FusedPropagation(ms)
    spiked = u.copy()
    spiked[::997] = 150.0
    for name, uu in (("hour", u), ("spikes", spiked)):
        r = cases.refresh_vs_host(fp, tsetup.pad_point_field(ms, uu),
                                  tsetup.pad_point_field(ms, v))
        assert r["uv_off"] == r["grads_off"] == 0, (name, r)
        assert r["mask_differ"] == 0, (name, r)
        if name == "spikes":
            assert 0 < r["masked"] < ms.fused.nsrl, r


@pytest.mark.gpu
def test_refresh_spans_time_the_device(cuda):
    """NEWWIND with new currents: ``refresh`` and its ``refresh.gradi``
    and ``refresh.cfl`` record device time, one count each, and the
    counter ``cfl_dropped_rows`` reads the rows the retry masked."""
    from ecwam_tpu_torch import tracing
    kw = cases.currents_kw(3, cfl=True)
    u, v = kw["currents"]
    ms = tsetup.build_model(device=cuda, **kw)
    frc = dict(tdriver.constant_wind_forcing(ms.n_real)("x"), ucur=0.9 * u,
               vcur=v)
    m = tdriver.FastWaveModel(ms, lambda d: frc, cases.START)
    names = ("refresh", "refresh.gradi", "refresh.cfl")
    before = tracing.report()["totals"]
    m.newwind(m.date)
    rep = tracing.report()
    for n in names:
        t, t0 = rep["totals"][n], before.get(n, dict(count=0, device_s=0.0))
        assert t["count"] == t0["count"] + 1, n
        assert t["device_s"] > (t0["device_s"] or 0.0), n
    assert rep["counters"]["cfl_dropped_rows"] == int(m.fp.cfl_bad.sum()) > 0


@pytest.mark.gpu
def test_newwind_leaves_the_card_running(cuda):
    """NEWWIND with new currents (the hour's upload from pinned memory,
    the refresh with its CFL pass, the forcing rows and the TAUW cap)
    returns while the card still runs the work queued before it: nothing
    in it waits for the stream."""
    kw = cases.currents_kw(3, cfl=True)
    u, v = kw["currents"]
    ms = tsetup.build_model(device=cuda, **kw)
    frc = dict(tdriver.constant_wind_forcing(ms.n_real)("x"), ucur=0.9 * u,
               vcur=v)
    m = tdriver.FastWaveModel(ms, lambda d: frc, cases.START)
    m.newwind(m.date)
    torch.cuda.synchronize()
    stream = torch.cuda.current_stream()
    torch.cuda._sleep(1_000_000_000)
    m.newwind(m.date)
    assert not stream.query()
    torch.cuda.synchronize()
    assert int(m.fp.cfl_bad.sum()) > 0
