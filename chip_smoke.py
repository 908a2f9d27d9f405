"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases (any failure raises and the script exits non-zero):
  1. machine: card name and power limit, CUDA/torch/nvcc versions; build
     every kernel library (``_build.SOURCES``: csrc/advect.cu, the four
     builds of csrc/implsch.cu — SRL and compact entries, default and wide
     — and csrc/opclass.cu) with nvcc for sm_90a, in parallel, and log
     each kernel's registers and spills;
  2. small configurations: on the golden-trajectory grid (12° topo grid
     with obstructions, 12×18/15, irefra=1, ifrelfmax=3), 4 steps of
     ``FastWaveModel.advance`` through the kernels (8 advection and 2
     physics launches) and 4 through the plain PyTorch versions (none),
     both on the card, where fl1 and every stress field must agree; one
     advection pass and one sub-band pass, kernel A against plain, on that
     grid (with obstructions: the kernel's OBS route) and on a 3–21 m
     shallow grid (open water: no obstruction table read); one
     physics step, kernel against plain, in minimal and in full mode, on
     that grid and on a 3–21 m shallow grid (depth-induced breaking,
     bottom friction and a cut inside the ladder are active there); and
     the golden statistics.log trajectory — 5 output-date steps
     ``advance(1, full_phys=True)`` through the kernels — against the
     committed tests/golden/statistics_golden.json;
  3. full width (O320, 36 directions × 36 frequencies, 29 advected,
     idelpro 450 s, idelt 900 s, aqua planet, winds 8–12 m/s from seed 0,
     JONSWAP cold start; the rebased tap width and the OBS route logged,
     OBS must be false): 4 steps (2 physics) through the kernels, then one
     output-date step (``advance(1, full_phys=True)`` on a physics step,
     chunked full mode with the windsea/swell split), each with the launch
     counts set to 0 before it and read after; then each kernel against
     its plain version on the same input — advection over the whole
     domain, physics in both modes on the sea-point rows of a 32,768-row
     slice, the compact entry (kernel C) on the same slice in both modes —
     timed with CUDA events; then the compact entry's own path, both modes
     on every point of the compact field;
  4. where the time goes at O320: the mean of 8 more steps on the host
     clock (synchronised), 4 steps under ``torch.profiler`` for each
     kernel's share of device time and the device's busy share, and one
     profiled output-date physics step split into the full-mode kernel and
     the rest (windsea/swell separation, chunk copies); a window whose
     profiler recorded fewer launches of a kernel than its wrapper counted
     is profiled again, three windows at most;
  5. ECMWF's operational options (``cases.py``'s CY49R1/CY50R1 physics and
     current refraction): the golden configuration with the trajectory
     oracle's currents (irefra 3), 4 steps through the kernels and through
     the plain versions; kernel A with currents against plain on the
     currents grids (a pass, a sub-band pass, and the CFL retry mask,
     which must be equal); one physics step of the shallow grid with the
     cycle-50 options and polar ice, kernel against plain in both modes
     and through kernel C; then, once the default O320 model is freed,
     ``cases.o320_options`` (irefra 2, CY50R1, polar ice, currents): 4
     steps and an output date through the kernels with their launch
     counts, kernel A and kernel B against plain as in phase 3 (and
     kernel B on the slice again under storm winds of 5–55 m/s, where
     LLCAPCHNK and RNFAC act), and the timing and profile of phase 4;
  6. the rest of the physics (``cases.LEGACY_CASES``: iphys=0 alone and
     with CY49R1 on the golden grid; ISNONLIN 0 and 2, SDICE1, SDICE2,
     LSTRN and LBIWBK/LICERUN/LMASKICE off on the shallow grid): one
     physics step each, kernel against plain in both modes and through
     kernel C; then, once the options' O320 model is freed,
     ``cases.o320_legacy`` (iphys=0, ISNONLIN=2, SDICE1, LSTRN, polar ice,
     a 20–980 m bottom): 4 steps and an output date through the kernels
     with their launch counts, kernel B against plain on the slice in both
     modes, and the timing and profile of phase 4;
  7. kernel D, the op-class micro-benchmark (``tools/opclass.py``): each of
     the nine classes at K=8 over 16,384 lanes against its plain version,
     then timed at the reference's size (K=64 over 131,072 lanes);
  8. the command line's run loop (``cli.main.run_model``, what ``python -m
     ecwam_tpu_torch run --config C --rundir R`` runs), in-process so that
     the launch counters can be read around it (``cli.checks``): the 12°
     YAML of tests/test_config_cli.py, 3 h, with every output field that
     outcontrol knows and the catalog computes but the swell trains (61),
     hourly from 1 h, GRIB output, the second-order correction and a 2 h
     restart, through the kernels and through the plain versions on the
     card (statistics.log within CLI_STATS_TOL), and resumed from its 2 h
     restart (the 3 h restart equal bit for bit); then O320 36×36/29,
     idelpro 450 s, idelt 900 s, 6 h of the reference's synthetic winds
     hourly from a forcing file, the 61 fields hourly in GRIB, restarts at
     3 h and 6 h: the launches must equal what the date loop implies
     (``checks.expected_launches``), the output date's split (full-mode
     physics, products, second order, copies to the host, the
     statistics/GRIB write) and the peak allocation are logged, the second
     order is timed alone on 65,536 points, the products of 32,768 points
     are held against float64 on the CPU, and the run resumed from its 3 h
     restart must end bit for bit equal;
  9. the dense ``WaveModel`` (``model/stepper.py``: cached and on-the-fly
     CTU weights, or kernel A in ``fused``; physics through kernel C in
     full mode on every physics step): on the golden grid in the
     trajectory oracle's two configurations (``cases.WAVEMODEL_CASES``:
     fast waves with irefra 1, currents with irefra 3), each weight mode
     (``otf`` in blocks of 4) 4 steps through the kernels and through the
     plain versions on the card (fl1 and stress within the golden
     trajectory's limits; kernel C launched once a physics step, kernel A
     ``nsub`` passes a step in ``fused`` and none otherwise, the plain
     runs none); u* forcing (tests/test_forcing_fidelity.py's ICODE 1 case
     and ICODE 2: the stress takes the forcing's u*, U10 from the log
     profile in (6, 25) m/s), 2 steps through kernel C's UST instantiation
     and one physics step of it against plain; then O320 36×36/29 as in
     phase 3 (JONSWAP cold start), each weight mode in turn, freed before
     the next: the weight build, 4 steps (2 physics) with their launches,
     the mean advection and physics step and the peak allocation, the
     three end states within the golden trajectory's limits of each
     other; kernel C against plain on a 32,768-point slice of the state in
     full mode, its time on every point with its bound, and the UST
     instantiation on the same slice under u* from seed 0; last the 12°
     CLI run with ``weights_mode: cached`` and the swell-train fields
     ``p042``-``p050`` beside phase 8's, through the kernels and the plain
     versions (statistics within CLI_STATS_TOL, the trains within
     TRAIN_STATS_TOL, launches as ``checks.expected_launches``);
 10. boundary nesting, coupling, assimilation and ``phys_srl_chunked``
     (``chip_smoke.boundary_phase``): through the command line, an O160
     coarse run (aqua, 36×36/29, idelpro 450 s, idelt 900 s, 2 h, swh
     hourly, ``nesting: coarse: rect: [20, 70, 280, 350]``) writes its
     boundary file, ``bouint`` takes it to 30 minutes, and an O320 fine run
     with the same widths reads it (``nesting: fine: file:``), its rim
     written in place in the SRL rows and tail after every step; launches
     as ``checks.expected_launches``; one more step's rim against the
     compact ``apply_boundary`` through the round trip (RIM_TOL), finite
     and nonzero; the rim write, INTSPEC alone and the round trip timed
     (host clock and the profiler's busy time), and 4 steps without and
     with the rim profiled for their idle time; coupling: 18°, 12×25,
     irefra 2 (tests/test_coupling.py's two cases) through the kernels and
     the plain versions, each block field within the golden trajectory's
     limits (TRAJ_TOL for SWH and the mean period, TRAJ_STRESS_TOL for the
     rest, vector components over their vector's magnitude), then O320
     fused with irefra 2: one period of the O320 winds, 8 steps, currents
     (the options' jet and eddies) and ice beyond 60° through
     ``push_ocean``, 8 more steps, each call timed, kernels A and C
     counted, the DEFVALs at the iced points and the reference test's
     ranges at the ice-free ones (ntauoc's lower bound only); assimilation:
     ``FastWaveModel`` at O320 after 4 steps, 2,000 observations on sea
     points from ``default_rng(0)`` (SWH the first guess × U(0.8, 1.2)),
     ``wamassi``; the card's analysis against float64 on the CPU at 4,096
     points with the card's weights (OI_CHECK_TOL), the SWH after the
     in-place update against the analysis (WAMASSI_SWH_RTOL), the
     analysis, the update and the peak allocation; ``phys_srl_chunked`` on
     that state in 65,536-point chunks against ``phys_srl`` on all rows
     (bit for bit, else within RIM_TOL) and both timed;
 11. the shapes beyond kernel B/C's default build
     (``chip_smoke.shapes_phase``, rehearsed by
     tests/test_torch_smoke_shapes.py at O24): O320 36×36/29 with each of
     LCFLX, LSTOKES and LWVFLX_SNL off in turn, an output date through
     kernel B's EXT instantiation with its launches and the full-mode
     slice against plain (the rows a switch turns off zero); O320
     72×36/29 (the wide build, four directions a lane): 4 steps and an
     output date through kernels A and B with their launches, the mean
     step and Gbins/s, kernel A's tile, the peak allocation, kernel A
     against plain on the whole domain and kernel B (and C) on the slice
     in both modes with each kernel's time and bound; the dense fused
     ``WaveModel`` at O320 under u* (the drag law of the O320 winds) with
     the cycle-50r1 options: 4 steps with their launches, the mean
     physics step and the peak allocation, kernel C's UST×OPTS
     instantiation against plain on a 32,768-point slice of its state,
     and again under storm winds (5–55 m/s) and their u*; the shallow 12°
     grid at 66 frequencies (the wide build's shared windsea mask): one
     physics step in each mode against plain and 2 output-date steps
     through the kernel;
 12. one JSON line with each kernel's launches, errors, times and bound;
     the card's name and power limit; the final ``{"ok": true, ...}`` line.

Tolerances on the card, each relative to the field's maximum (PERF.md
gives the sound readings and those of deliberately broken kernels):
  advection, kernel vs plain      max|k−p| ≤ ADVECT_TOL (FMA contraction)
  physics spectrum                max|k−p| ≤ PHYS_TOL (both modes)
  physics stress rows             ≤ STRESS_TOL
  full-mode diagnostic rows       ≤ FULL_ROW_TOL each (the four rows that
                                  integrate the windsea mask are held out
                                  at the points where mask bins differ,
                                  all of them on the mask's edge)
  full-mode windsea mask          a bin may differ only on the mask's
                                  edge: within MASK_WIDTH of it in the
                                  plain chain run in float64 (its
                                  ``xllws_margin``); such bins ≤
                                  XLLWS_SHARE of all
  4-step golden trajectory        fl1 ≤ TRAJ_TOL; each stress field
                                  ≤ TRAJ_STRESS_TOL (z0m and chrnck come
                                  through TAUT_Z0's 1/√(1−τw/τ))
  golden statistics.log           average, minimum, maximum within
                                  GOLDEN_RTOL of the committed values
  kernel A's CFL retry mask       equal to the plain version's, and the
                                  CHECKCFL violation count equal
  kernel D                        equal for the layout classes, 1e-6 of
                                  max for the others
  WaveModel, kernels vs plain     fl1 ≤ TRAJ_TOL, stress ≤ TRAJ_STRESS_TOL
  (4 steps, each weight mode),    (the golden trajectory's limits)
  and its three O320 end states
  kernel C's UST instantiation,   spectrum ≤ PHYS_TOL, stress and the U10
  and kernel C on WaveModel's     row ≤ STRESS_TOL, the other rows ≤
  state (phase 9)                 FULL_ROW_TOL, ties and mask edges held
                                  out as for kernel B; tauwdir on the
                                  circle over 2π, each vector component
                                  over its vector's largest magnitude;
                                  under u*, points within Z0_WIDTH of
                                  Z0WAVE's gap held, ≤ Z0_SHARE
  CLI swell-train statistics,     each within TRAIN_STATS_TOL of the
  kernels vs plain (12°)          entry's largest magnitude
  CLI statistics.log, kernels     each average/minimum/maximum within
  vs plain (12°)                  CLI_STATS_TOL of the entry's largest
                                  magnitude
  resumed CLI runs                restarts equal bit for bit
  nesting rim in place vs the     ≤ RIM_TOL of the field's max (the same
  compact apply_boundary          values written: 0 expected)
  coupling blocks (18°), kernels  the golden trajectory's limits, as above
  vs plain
  OI analysis, card vs float64    ≤ OI_CHECK_TOL relative at each point
  on the CPU (same weights)
  SWH after wamassi vs analysis   ≤ WAMASSI_SWH_RTOL relative (the
                                  reference test's)
  phys_srl_chunked vs phys_srl    bit for bit (else ≤ RIM_TOL, reported)
  products on the card vs float64 each field within PRODUCT_TOL of its
  on the CPU (O320, 32,768 pts)   largest magnitude (directions on the
                                  circle); points over it held out only
                                  within EDGE_WIDTH of a float32 decision
                                  edge in float64 (``checks.
                                  products_vs_f64``), at most EDGE_SHARE
                                  of the points a field
Physics rows whose FRCUTINDEX argument lies within TIE_WIDTH of a
rounding tie (x.5, in float64) are held out of the physics tolerances:
the cut index, and with it the stress, may round the other way in either
float32 version.  At most TIE_SHARE of the sea rows may be such ties, and
every other row must meet the tolerances.  Likewise, under the
gravity-capillary closure, rows whose decision margin (``gc_margin`` of
the plain chain in float64: a TAUT_Z0_GC convergence test, its x1 ≥ pmax
test, or an NS_GC index step, see ``airsea.taut_z0_gc``) lies within
GC_WIDTH of its edge are held out, at most GC_SHARE of the sea rows (on a
small grid, at most one row), and under ISNONLIN=2 the rows whose PEAK_ANG
peak lies within PEAK_WIDTH (relative, float64, ``peak_margin``) of the
next direction maximum, at most PEAK_SHARE of them: the peak, and with it
the enhancement, may move in either float32 version.
"""

import json
import math
import os
import re
import subprocess
import sys
import time

ADVECT_TOL = 1e-5
PHYS_TOL = 2e-5
STRESS_TOL = 1e-5
FULL_ROW_TOL = 1e-4
XLLWS_SHARE = 1e-6
MASK_WIDTH = 1e-4
TRAJ_TOL = 2.5e-4
TRAJ_STRESS_TOL = 5e-3
GOLDEN_RTOL = 2e-5
TIE_WIDTH = 1e-5
TIE_SHARE = 1e-3
GC_WIDTH = 1e-4
GC_SHARE = 1e-3
PEAK_WIDTH = 1e-5
PEAK_SHARE = 1e-3
Z0_WIDTH = 1e-2
Z0_SHARE = 1e-2
PHYS_ROWS = 32768
CLI_STATS_TOL = 1e-5
PRODUCT_TOL = 2e-5
EDGE_WIDTH = 1e-4
EDGE_SHARE = 1e-3
PRODUCT_ROWS = 32768
TRAIN_STATS_TOL = 1e-3
ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
FP32_OPS_PER_S = 67e12             # H100 SXM, float32 outside tensor cores
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                      "golden", "statistics_golden.json")


def log(*a):
    print(*a, flush=True)


def register_lines(text: str) -> list:
    """Each kernel's registers and spills from ``nvcc -Xptxas=-v``, named
    by its template (``implsch_kernel<FULL,COMPACT,OPTS,EXT,JAN,UST>``)."""
    out, name = [], "?"
    for ln in text.splitlines():
        m = re.search(r"entry function '(\w+)'", ln)
        if m:
            t = re.search(r"\d([a-z][a-z_]*)I((?:L[bi]\d+E)+)E",
                          m.group(1))
            name = (f"{t.group(1)}<"
                    + ",".join(re.findall(r"L[bi](\d+)E", t.group(2)))
                    + ">" if t else m.group(1))
        elif "registers" in ln:
            out.append(f"{name}: " + ln.split(":", 1)[-1].strip())
        elif "spill" in ln and not re.search(r"\b0 bytes spill stores, "
                                             r"0 bytes spill loads", ln):
            out.append(f"{name}: " + ln.split(":", 1)[-1].strip())
    return out


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def rel_max(a, b):
    """max|a−b| / max|b| and max|a−b|."""
    d = float((a - b).abs().max())
    return d / float(b.abs().max()), d


def cuda_ms(fn, reps, setup=None):
    """Mean device time (ms) of ``fn`` over ``reps`` runs after one
    warm-up; ``setup`` (untimed) makes each run's input.  None without a
    card (a rehearsal on the CPU times nothing)."""
    import torch
    if not torch.cuda.is_available():
        return None
    total = 0.0
    for i in range(reps + 1):
        arg = setup() if setup else None
        torch.cuda.synchronize()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        fn(arg)
        e1.record()
        torch.cuda.synchronize()
        if i:
            total += e0.elapsed_time(e1)
    return total / reps


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def bound(byte_count, ops):
    """The least time (ms) for the work: the larger of bytes over the
    HBM rate and float32 operations over the card's peak; and which."""
    t_b, t_o = byte_count / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return (max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations")


def implsch_ops(cfg, nang, full, *, above_cut, shallow, windsea, ice,
                gc_terms=0.0):
    """Float32 operations of the IMPLSCH chain on one row, counted by stage
    from csrc/implsch.cu.  Each add, subtract, multiply, min, max or
    compare is one operation (an FMA two, as the peak rate counts it);
    each division, square root and transcendental one.  Work a kernel may
    repeat (the scalar chains on a row's lanes) is counted once, and the
    saturation sum B(k) of SDISSIP over the nonzero band of W only.
    Data-dependent work is counted as this
    run's data needs it: ``above_cut`` is the mean number of frequencies
    above the cut (IMPHFTAIL), ``shallow`` the share of rows shallower than
    BATHYMAX (SBOTTOM), ``windsea`` the share of bins in the windsea mask
    (the second FEMEANWS), ``gc_terms`` the mean number of gc wavenumbers
    from the cut-off up (NWAV − NS, STRESS_GC), ``ice`` the share of rows
    with ice thicker than 0 (the SDICE1 lookup, its group speed and the
    AKI_ICE steps of CIMSSTRN, which the kernel skips on open water); the
    sea-ice branches of the default chain are left out.  The cycle-49/50 options add, per
    configuration flag: HALPHAP, TAUT_Z0_GC's two loops of NITER steps
    (the kernel, like the reference, runs all of them), STRESS_GC's
    wavenumber sum in each first-loop step and the TAU_PHI_HF cut-off
    (LLGCBZ0); the growth normalisation in SINPUT and in the tail
    integrals (LLNORMAGAM); CHNKMIN (LLCAPCHNK); the per-bin SDICE3 and
    LCISCAL terms with the group speed per frequency.  Each SINFLX call
    runs one closure: TAUT_Z0, or TAUT_Z0_GC (with HALPHAP before the
    first call) under LLGCBZ0, or Z0WAVE under u* forcing, which runs
    neither of the others whatever the options.  Full mode's switches
    leave out what the kernel leaves out: LCFLX off the flux source sums,
    the cap term's sums and WNFLUXES; LSTOKES off STOKESTRN and CIMSSTRN;
    LWVFLX_SNL off sums the source before SNONLIN without the implicit
    factor."""
    import numpy as np
    f, dia, jtot, niter = cfg.tables.nfre, cfg.dia, 19, 18
    a, nb, ml = nang, nang * f, int(cfg.dia.mlsthg)
    # SDEPTHLIM and FKMEAN: column sums, moments, the scaled bins
    ops = (3 * nb + 2 * f + 5) + (nb + 6 * f + 11)
    # the direction rows (cos, sin², FLM) and the first call's tail floor
    ops += 12 * a + 2
    p = cfg.params
    ustar = cfg.icode_wnd in (1, 2)
    # each SINFLX call: its closure, FEMEANWS, FRCUTINDEX and STRESSO with
    # its 19-node tail integral
    if ustar:
        # Z0WAVE and the log-profile U10
        closure = 15
    elif p.llgcbz0:
        # TAUT_Z0_GC: first guess, then NITER first-loop steps (STRESS_GC:
        # 25 a wavenumber from the cut-off, 30 scalar; the step, 25) and
        # NITER second-loop steps (40), the fallbacks (30)
        closure = 40 + niter * (25 * gc_terms + 55) + niter * 40 + 30
    else:
        # TAUT_Z0: 18 Newton steps of 33
        closure = 21 + 33 * niter
    ops += 2 * (closure + (4 * f + 7) + 11
                + (10 * f + 5 * a + 45 + 28 * jtot))
    # SINPUT: call 1 with one gust (26 a bin), call 2 with two gusts and
    # the swell damping (33 a bin and gust), 9 a bin for the sums
    ops += (10 + 21 * f + 35 * nb) + (71 + 51 * f + 76 * nb)
    # SDISSIP: B(k) = Σ_j W(k, j)·F(j) once per bin over W's band of
    # 2·NSDSNTH+1 directions (W is 0 outside it), its maximum, the
    # dissipation of each bin
    nsat = cfg.sat_indices.shape[1]
    ops += f * (2 * a * nsat + 12 * a + 9)
    # SNONLIN: TRANSF per extended frequency; per (KH, MC, direction) 32
    # for the transfer terms, 4 for the centre bin inside the ladder and 8
    # for each target bin inside it
    targets = sum(int(((np.asarray(t) >= 1) & (np.asarray(t) <= f)).sum())
                  for t in (dia.ikm, dia.ikm1, dia.ikp, dia.ikp1))
    ops += 54 * ml + 2 * (ml + a * (32 * ml + 4 * min(ml, f) + 8 * targets))
    # SDIWBK (15 Newton steps), SBOTTOM, the update with limiter and cap,
    # IMPHFTAIL above the cut
    ops += (190 + cfg.nfre_red * a * (3 + 9 * shallow) + 2 + 15 * nb
            + 2 + 5 * a * above_cut)
    lcflx, lstokes = full and cfg.lcflx, full and cfg.lstokes
    if full:
        # PHIWA's sums and PHIHF's integral in both calls; the cap term
        # written in the update (3 a bin); the second FKMEAN and FEMEANWS
        ops += 2 * (5 * nb + f + 4 * f + a + 9 + 28 * jtot)
        ops += 3 * nb + (nb + 14 * f + 21)
        ops += windsea * nb + 4 * f + 10
    if lcflx:
        # the flux source sums: after SNONLIN with the implicit factor (9
        # a bin), or before it without (5 a bin) under LWVFLX_SNL off;
        # the cap term's sums (5 a bin, 3 a frequency); WNFLUXES
        ops += (9 if cfg.lwvflx_snl else 5) * nb
        ops += 5 * nb + 3 * f + (14 * f + 40)
    if lstokes:
        # STOKESTRN
        nodd = f - 1 + f % 2
        ops += 12 * nodd + 5 * a * nodd + 4 * a + 10
    if p.llgcbz0:
        # HALPHAP (call 1) under TAUT_Z0_GC: the downwind sums, four
        # moments, the scalars
        if not ustar:
            ops += 7 * nb + 9 * f + 30
        # the TAU_PHI_HF cut-off in each call (NS_GC and the log, 12)
        ops += 2 * 12
    if p.llnormagam:
        # SINPUT: per gust and frequency two direction sums (4 a bin), the
        # factor (8) and its product (1 a bin): call 1 one gust, call 2 two
        ops += 3 * f * (5 * a + 8)
        # the tail integrals: two sums at the cut, 6 a node (both calls,
        # the PHIHF integral in full mode)
        ops += 2 * (4 * a + 6 + 6 * jtot * (2 if full else 1))
    if p.llcapchnk:
        ops += 2 * 10
    if cfg.lciwa3 or cfg.lciscal:
        # the group speed per frequency (15) and 6 a bin
        ops += 15 * f + 6 * nb
    if p.iphys == 0:
        # SINPUT_JAN in place of SINPUT ARD: call 1 one gust (23 a bin),
        # call 2 two gusts and the negative part (45 a bin), the
        # per-frequency scalars; SDISSIP_JAN (8 a bin) in place of SDISSIP
        # ARD; the first FKMEAN's mean wavenumbers (2 sums)
        ops -= (10 + 21 * f + 35 * nb) + (71 + 51 * f + 76 * nb)
        ops += (10 + 15 * f + 23 * nb) + (20 + 30 * f + 45 * nb)
        ops -= f * (2 * a * nsat + 12 * a + 9)
        ops += 8 * nb + 10 + (8 * f + 10)
    if cfg.isnonlin == 0:
        # one factor from depth and akmean for every MC, not TRANSF
        ops += 8 * f + 10 + 15 - 54 * ml
    if cfg.isnonlin == 2:
        # PEAK_ANG: column sums and maxima, three moments, the peak, and
        # the 2·NSH+1 window steps (direction sums, THMEAN, the 2·sin²
        # sum, 13 a direction and 15 a step); TRANSF_SNL (70 a MC) for
        # TRANSF (54)
        nsh = 1 + int(np.log(1.5) / np.log(cfg.tables.fratio))
        ops += 2 * nb + 6 * f + 15 + f + (2 * nsh + 1) * (13 * a + 15)
        ops += 16 * ml
    if cfg.lciwa1:
        # SDICE1: the floe size (30), 4 a bin; on iced rows the lookup and
        # rate per frequency (30) and the group speed (15)
        ops += 30 + 4 * nb + ice * (30 * f + (0 if cfg.lciwa3 else 15 * f))
    if cfg.lciwa2:
        # SDICE2: 9 a bin
        ops += 9 * nb + (0 if cfg.lciwa3 or cfg.lciwa1 else 15 * f)
    if lstokes and cfg.lstrn:
        # CIMSSTRN: a column sum and the strain per frequency (8); on iced
        # rows AKI_ICE's start (15) and 25 Newton steps (22 each)
        ops += nb + 8 * f + ice * f * (15 + 25 * 22)
    if not cfg.lbiwbk:
        ops -= (3 * nb + 2 * f + 5) + 190 + cfg.nfre_red * a * 3
    return ops


def gc_terms(ufric) -> float:
    """The mean number of gravity-capillary wavenumbers STRESS_GC sums
    (from the cut-off NS_GC(u*) up) at these friction velocities."""
    from ecwam_tpu_torch.ops.physics import gc as gc_mod
    g = gc_mod.gc_tables()
    return float((g.nwav - gc_mod.ns_gc(ufric.double(), g)).double().mean())


def o320_model(dev):
    """bench.py's configuration at O320: the setup and a cold-started
    ``FastWaveModel`` under fixed 8–12 m/s winds from seed 0."""
    import numpy as np
    from ecwam_tpu_torch.model import cases, driver
    from ecwam_tpu_torch.model import setup as setup_mod
    ms = setup_mod.build_model(device=dev, **O320_KW)
    wind = o320_wind(ms.n_real)
    return ms, driver.FastWaveModel(ms, lambda date14: wind, cases.START)


# bench.py's configuration at O320
O320_KW = dict(grid_name="O320", nang=36, nfre=36, nfre_red=29,
               idelpro=450.0, idelt=900.0, pad_to=8192)


def o320_wind(n: int) -> dict:
    """Fixed 8–12 m/s winds in random directions from seed 0 on ``n``
    points."""
    import numpy as np
    rng = np.random.default_rng(0)
    return dict(wswave=8.0 + 4.0 * rng.random(n),
                wdwave=rng.random(n) * 2.0 * np.pi,
                aird=np.full(n, 1.225), wstar=np.zeros(n),
                cicover=np.zeros(n))


def ice_slice(ms) -> int:
    """The first SRL row of the PHYS_ROWS-row slice with the most rows in
    the partly iced band 60° < |φ| < 75° (cicover strictly between 0 and
    1 in ``cases.o320_options``/``o320_legacy``)."""
    import numpy as np
    from ecwam_tpu_torch.model import cases
    lat, _ = cases.point_latlon(ms.grid, ms.blk)
    la = np.zeros(ms.n_pad + 1)
    la[:ms.n_real] = np.abs(lat)
    la = la[np.asarray(ms.fused.srl_src)]
    c = np.concatenate([[0], np.cumsum((la > 60.0) & (la < 75.0))])
    n = min(PHYS_ROWS, la.size)
    return int(np.argmax(c[n:] - c[:-n]))


def storm_winds(n: int):
    """``n`` winds of :func:`cases.storm`'s strength, uniform in 5–55 m/s
    from seed 0: LLCAPCHNK's capped Charnock parameter and RNFAC act above
    about 25 m/s."""
    import numpy as np
    return np.random.default_rng(0).uniform(5.0, 55.0, n)


def slice_check(ms, model, dev, full, above_cut, r0=None, storm=False):
    """Kernel B against the plain chain on the sea rows of a
    PHYS_ROWS-row slice of the model's state (from row ``r0``, by default
    the middle row), in minimal or full mode; then, on the same rows as a
    compact (nang, nfre, rows) spectrum, kernel C against its plain
    version and against kernel B.  ``storm``: the slice's U10 replaced by
    :func:`storm_winds`.  Returns the readings, with the operations bound
    counted for ``above_cut`` (see :func:`implsch_ops`) and this step's
    windsea mask."""
    import torch
    from ecwam_tpu_torch.core.dispersion import BATHYMAX
    from ecwam_tpu_torch.model import cases
    from ecwam_tpu_torch.ops.physics import implsch_cuda as ipk
    ft, fp = ms.fused, model.fp
    cfg = ms.phys if full else ipk.minimal_config(ms.phys)
    r0 = ft.nsrl // 2 if r0 is None else r0
    rows = slice(r0, r0 + PHYS_ROWS)
    scal = torch.cat([model._frc6, model._denv, model._stress6])
    args = (model._f_srl[rows], model._env2d[:, rows].contiguous(),
            scal[:, rows].contiguous(), model._tail[rows])
    if storm:
        args[2][ipk.SCAL_IN.index("wswave")] = torch.as_tensor(
            storm_winds(args[2].shape[1]), dtype=args[2].dtype, device=dev)
    kw = dict(nang=fp.nang, nfre_red=fp.nfre_red, full=full)
    tabs = ipk.pack_tables(cfg, dev)

    def run_kernel(a):
        return ipk.implsch_srl(cfg, *a, tables_dev=tabs, **kw)

    def fresh():
        return (args[0].clone(), args[1], args[2], args[3].clone())
    got = run_kernel(fresh())
    want = ipk.implsch_srl_plain(cfg, *fresh(), **kw)
    if not all(bool(torch.isfinite(x).all()) for x in got):
        raise AssertionError("physics kernel produced non-finite values")
    # pad rows carry no sea point: their finite garbage never reaches one
    # (the advection valid-mask), so only finiteness is required there
    sea = torch.as_tensor(ft.srl_src[rows] < ms.n_pad, device=dev)
    # rows whose FRCUTINDEX argument sits on a rounding tie may take the
    # other cut in one of the two float32 versions; they are counted and
    # held out, and every other disagreeing row fails the run
    nst = len(ipk.STRESS_KEYS)
    if full:
        sea_rows = torch.nonzero(sea).flatten()
        margin_at = cases.srl_margin(cfg, *args, nang=fp.nang,
                                     nfre_red=fp.nfre_red)
        fe = cases.full_errors(got[1][:, sea], want[1][:, sea],
                               got[3][..., sea], want[3][..., sea],
                               lambda pts: margin_at(sea_rows[pts]),
                               MASK_WIDTH)
        err = torch.zeros_like(got[1])
        err[:, sea] = fe["err"]
    else:
        err = ((got[1] - want[1]).abs() / want[1][:, sea].abs().amax(
            1, keepdim=True).clamp(min=1e-30))
    s_row = err[:nst].amax(0)
    off_row = (s_row > STRESS_TOL)
    if full:
        off_row |= err[nst:].amax(0) > FULL_ROW_TOL
    off = torch.nonzero(sea & off_row).flatten()
    tie, gc, peak = (torch.zeros_like(sea) for _ in range(3))
    gc_m = pk_m = torch.zeros(0, dtype=torch.float64, device=dev)
    n_sea = int(sea.sum())
    if 0 < off.numel() <= (TIE_SHARE + GC_SHARE + PEAK_SHARE) * n_sea:
        st = cases.srl_state(cfg, *args, nang=fp.nang, nfre_red=fp.nfre_red,
                             rows=off)
        dist = st["frcut_tie"]
        tie[off[dist < TIE_WIDTH]] = True
        if "gc_margin" in st:
            # a TAUT_Z0_GC loop that may leave at another iteration (or a
            # cut-off index step) in either float32 version
            gc_m = st["gc_margin"]
            gc[off[(gc_m < GC_WIDTH) & (dist >= TIE_WIDTH)]] = True
        if "peak_margin" in st:
            # a PEAK_ANG peak that may move to another direction maximum
            pk_m = st["peak_margin"]
            peak[off[(pk_m < PEAK_WIDTH) & (dist >= TIE_WIDTH)
                     & ~gc[off]]] = True
    keep = sea & ~tie & ~gc & ~peak
    spec = [rel_max(got[0][keep], want[0][keep]),
            rel_max(got[2][keep], want[2][keep])]
    held_m = gc_m[gc[off]] if gc.any() else gc_m[:0]
    held_p = pk_m[peak[off]] if peak.any() else pk_m[:0]
    r = dict(n_sea=n_sea, n_tie=int(tie.sum()), n_gc=int(gc.sum()),
             n_peak=int(peak.sum()),
             n_off=(off.numel() - int(tie.sum()) - int(gc.sum())
                    - int(peak.sum())),
             tie_stress=float(s_row[tie].max()) if tie.any() else 0.0,
             gc_stress=float(s_row[gc].max()) if gc.any() else 0.0,
             gc_margin=float(held_m.max()) if held_m.numel() else 0.0,
             peak_err=float(s_row[peak].max()) if peak.any() else 0.0,
             peak_margin=float(held_p.max()) if held_p.numel() else 0.0,
             spec_rel=max(s[0] for s in spec),
             spec_abs=max(s[1] for s in spec),
             stress_rel=float(s_row[keep].max()))
    if cfg.isnonlin == 2:
        # PEAK_WIDTH's reading: how near a tie the peaks of the rows that
        # agree came without moving — their smallest margin (0 where two
        # direction maxima are equal in float64), their smallest nonzero
        # one, and how many lie within PEAK_WIDTH
        pm = cases.srl_state(cfg, *args, nang=fp.nang, nfre_red=fp.nfre_red,
                             rows=torch.nonzero(keep).flatten())[
                                 "peak_margin"]
        r["peak_sound"] = dict(
            min=float(pm.min()),
            min_nonzero=float(pm[pm > 0].min()) if (pm > 0).any() else 0.0,
            zero=int((pm == 0).sum()), within=int((pm < PEAK_WIDTH).sum()))
    if full:
        rk = err[:, keep].amax(1)
        r["rows"] = {k: float(rk[i]) for i, k in enumerate(ipk.SCAL_OUT_FULL)}
        kept = keep[sea]
        r["xllws"] = int(fe["edge"][kept].sum())
        r["xllws_off"] = int(fe["off"][kept].sum())
        r["xllws_bins"] = got[3][..., keep].numel()
        r["margin"] = float(fe["margin"][kept].max())
        r["flip_points"] = int(((fe["edge"] + fe["off"])[kept] > 0).sum())
    r["ms"] = cuda_ms(run_kernel, 10, fresh)
    r["plain_ms"] = cuda_ms(
        lambda a: ipk.implsch_srl_plain(cfg, *a, **kw), 2, fresh)
    r["bytes"] = nbytes(*args, *args[::3], *got[1:2], *(got[3:] if full
                                                         else ()))
    depth = ipk.SCAL_IN.index("depth")
    cithick = ipk.SCAL_IN.index("cithick")
    windsea = float(got[3][..., sea].mean()) if full else 0.0
    data = dict(above_cut=above_cut, windsea=windsea,
                shallow=float((args[2][depth] < BATHYMAX).double().mean()),
                gc_terms=gc_terms(got[1][0][sea]),
                ice=float((args[2][cithick] > 0).double().mean()))
    r["ops"] = args[0].shape[0] * implsch_ops(cfg, fp.nang, full, **data)

    # kernel C on the same rows in the compact layout
    nang, nfre, nred = fp.nang, ms.tb.nfre, fp.nfre_red
    fl = torch.cat([args[0].reshape(-1, nang, nred),
                    args[3].reshape(-1, nang, nfre - nred)], dim=2)
    fl = fl.permute(1, 2, 0).contiguous()
    ck = ipk.implsch_compact(cfg, fl, args[1], args[2], full=full,
                             tables_dev=tabs)
    cp = ipk.implsch_compact_plain(cfg, fl, args[1], args[2], full=full)
    srl_as_compact = torch.cat(
        [got[0].reshape(-1, nang, nred),
         got[2].reshape(-1, nang, nfre - nred)], dim=2).permute(1, 2, 0)
    same = (torch.equal(ck[0], srl_as_compact) and torch.equal(ck[1], got[1])
            and (not full or torch.equal(ck[2], got[3])))
    c_spec = rel_max(ck[0][..., keep], cp[0][..., keep])
    keep_rows = torch.nonzero(keep).flatten()
    c_margin = cases.compact_margin(cfg, fl, args[1], args[2])
    c_fe = (cases.full_errors(ck[1][:, keep], cp[1][:, keep],
                              ck[2][..., keep], cp[2][..., keep],
                              lambda pts: c_margin(keep_rows[pts]),
                              MASK_WIDTH)
            if full else dict(err=cases.row_errors(ck[1][:, keep],
                                                   cp[1][:, keep]),
                              edge=torch.zeros(1), off=torch.zeros(1)))
    r["compact"] = dict(
        same_as_srl=same, spec_rel=c_spec[0], spec_abs=c_spec[1],
        rows_rel=float(c_fe["err"].max()), xllws=int(c_fe["edge"].sum()),
        xllws_off=int(c_fe["off"].sum()),
        ms=cuda_ms(lambda _: ipk.implsch_compact(
            cfg, fl, args[1], args[2], full=full, tables_dev=tabs), 10),
        plain_ms=cuda_ms(lambda _: ipk.implsch_compact_plain(
            cfg, fl, args[1], args[2], full=full), 2),
        bytes=nbytes(fl, args[1], args[2], *ck))
    all_rows = (model._f_srl.clone(), model._env2d, scal,
                 model._tail.clone())
    if not full and not storm:
        r["all_rows_ms"] = cuda_ms(lambda _: run_kernel(all_rows), 3)
    keys = ipk.SCAL_OUT_FULL if full else ipk.SCAL_OUT_MIN
    data["shallow"] = float((scal[depth] < BATHYMAX).double().mean())
    data["ice"] = float((scal[cithick] > 0).double().mean())
    data["gc_terms"] = gc_terms(model._stress6[0])
    r["all_rows_bound"] = bound(
        nbytes(*all_rows, *all_rows[::3]) + 4 * ft.nsrl * (
            len(keys) + (ms.tb.nang * ms.tb.nfre if full else 0)),
        ft.nsrl * implsch_ops(cfg, fp.nang, full, **data))
    return r


def check_slice(r, full, name):
    ok = (r["n_off"] == 0 and r["n_tie"] <= TIE_SHARE * r["n_sea"]
          and r["n_gc"] <= GC_SHARE * r["n_sea"]
          and r["n_peak"] <= PEAK_SHARE * r["n_sea"]
          and r["spec_rel"] <= PHYS_TOL and r["stress_rel"] <= STRESS_TOL)
    if full:
        ok = ok and (max(v for k, v in r["rows"].items()) <= FULL_ROW_TOL
                     and r["xllws_off"] == 0
                     and r["xllws"] <= XLLWS_SHARE * r["xllws_bins"])
    c = r["compact"]
    ok = ok and (c["same_as_srl"] and c["spec_rel"] <= PHYS_TOL
                 and c["rows_rel"] <= (FULL_ROW_TOL if full else STRESS_TOL)
                 and c["xllws_off"] == 0)
    if not ok:
        raise AssertionError(f"{name}: physics kernel disagrees with plain")


def launch_counters():
    """The wrappers' launch counts, by the kernel names of PROFILE_NAMES."""
    from ecwam_tpu_torch.ops import propagation_cuda as pcu
    from ecwam_tpu_torch.ops.physics import implsch_cuda as ipk
    return dict(advect=pcu.advect.launches,
                implsch=ipk.implsch_srl.launches,
                implsch_full=ipk.implsch_srl.full_launches)


PROFILE_NAMES = dict(advect=lambda s: "advect_kernel" in s,
                     implsch=lambda s: "implsch_kernel<false" in s,
                     implsch_full=lambda s: "implsch_kernel<true" in s)
PROFILE_TRIES = 3


def profile(fn, names=PROFILE_NAMES):
    """Device time of each kernel name and the busy share of ``fn()``
    under ``torch.profiler``: (wall ms, {name: (ms, calls)}, busy ms,
    tries).  The profiler has dropped launches (PERF.md §7): where it
    records fewer launches of a kernel than its wrapper counted in the
    window, ``fn`` is profiled again, PROFILE_TRIES times in all, and the
    last window is returned with a warning if it still falls short."""
    import torch
    from torch.profiler import ProfilerActivity, profile as prof_ctx
    for tries in range(1, PROFILE_TRIES + 1):
        torch.cuda.synchronize()
        n0 = launch_counters()
        with prof_ctx(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            # one small launch first, so that the tracer is running before
            # the measured work starts
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        counted = {k: v - n0[k] for k, v in launch_counters().items()}
        kern = [e for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        split = {}
        for label, match in names.items():
            ev = [e for e in kern if match(e.name)]
            split[label] = (sum(e.device_time for e in ev) / 1e3, len(ev))
        short = {k: (split[k][1], counted[k]) for k in split
                 if split[k][1] < counted.get(k, 0)}
        if not short:
            break
        log(f"profiler window {tries}: recorded (profiled, counted) "
            f"launches {short}; " + ("profiling again" if tries
                                     < PROFILE_TRIES else "kept short"))
    return wall, split, sum(e.device_time for e in kern) / 1e3, tries


def advect_bytes(fp, f_in, out, irefra):
    """Bytes one kernel-A pass must move: the spectrum read once and
    written once; cg and the per-row tables; the rebased taps at 6·ew2
    floats a row (the kernel's fourth, zero slot of each column is not
    counted); pf (one field, three with currents), the gradients and the
    current where the pass reads them; the segment tables and the lane
    constants; the obstruction table only where a factor is not 1 (the
    kernel's OBS route)."""
    t = fp.tabs
    nsrl, nft = t["cg_srl"].shape
    b = nbytes(f_in, out, t["cg_srl"], t["cg_land"], t["sea_own"],
               t["cgland"], t["geom"], t["valid"], t["dn_base"],
               t["up_base"], t["kseg"], fp.lc["rows"])
    b += nsrl * 6 * t["ktaps"].shape[2] * 4
    if irefra:
        b += nsrl * nft * 4 * (3 if irefra in (2, 3) else 1)
        b += nbytes(t["grads"])
    if irefra in (2, 3):
        b += nbytes(t["uv"])
    if not t["obs_ones"]:
        b += nbytes(t["obs"])
    return b


def advect_check(model, ft, irefra):
    """Kernel A against its plain version, one all-band pass over the
    whole domain of ``model``'s state: (relative error, absolute error,
    kernel ms, plain ms, bytes a pass)."""
    import torch
    from ecwam_tpu_torch.ops import propagation_cuda as pcu
    from ecwam_tpu_torch.ops import propagation_fused as pfz
    fp = model.fp
    f0 = pfz.refresh_wraps(model._f_srl.clone(), fp.tabs)
    kw = dict(nang=fp.nang, nf=fp.nfre_red, S=ft.S, EW=ft.EW, irefra=irefra)
    got = pcu.advect(f0, fp.tabs, fp.lc, **kw)
    want = pcu.advect_plain(f0, fp.tabs, fp.lc, **kw)
    a_rel, a_abs = rel_max(got, want)
    a_ms = cuda_ms(lambda _: pcu.advect(f0, fp.tabs, fp.lc, **kw), 10)
    a_plain = cuda_ms(lambda _: pcu.advect_plain(f0, fp.tabs, fp.lc, **kw),
                      2)
    a_bytes = advect_bytes(fp, f0, got, irefra)
    del got, want, f0
    torch.cuda.empty_cache()
    return a_rel, a_abs, a_ms, a_plain, a_bytes


def advect_small(name, kw, dev, obs):
    """Kernel A against plain on a small grid (see
    ``cases.advect_kernel_vs_plain``); ``obs``: whether the grid has
    obstructions, so that the pass must take the kernel's OBS route.
    Raises on a disagreement."""
    from ecwam_tpu_torch.model import cases
    a = cases.advect_kernel_vs_plain(kw, dev)
    log(f"advect {name}, kernel vs plain: pass {a['main']:.3e}, sub-band "
        f"pass {a['sub']} (tol {ADVECT_TOL}); obstruction table read "
        f"(OBS) {a['obs']}; CFL retry masks {a['cfl_masked']} rows, "
        f"{a['cfl_differ']} differ from plain; CHECKCFL kernel {a['diag']}, "
        f"plain {a['diag_plain']}")
    if a["obs"] != obs:
        raise AssertionError(f"advect {name}: OBS is {a['obs']}")
    if not (a["main"] <= ADVECT_TOL and (a["sub"] or 0.0) <= ADVECT_TOL
            and a["cfl_differ"] == 0
            and a["diag"]["n_violations"]
            == a["diag_plain"]["n_violations"]):
        raise AssertionError(f"advect {name}: kernel disagrees")


def options_phase(dev) -> dict:
    """Phase 5 (see the module docstring); returns the readings of the
    kernels line's option entries."""
    import numpy as np
    import torch
    from ecwam_tpu_torch.model import cases
    from ecwam_tpu_torch.model.fusedstep import FusedPropagation
    from ecwam_tpu_torch.ops import propagation_cuda as pcu
    from ecwam_tpu_torch.ops.physics import implsch_cuda as ipk

    # the golden configuration with the oracle's currents
    err, launched = cases.golden_kernel_vs_plain(
        dev, kw=cases.golden_kw(irefra=3, currents=True))
    log(f"golden currents (irefra 3) 4 steps, kernels vs plain (tolerance "
        f"fl1 {TRAJ_TOL}, stress {TRAJ_STRESS_TOL}): "
        + ", ".join(f"{k} {v:.3e}" for k, v in err.items())
        + f"; launches {launched}")
    if launched != dict(kernels=(8, 2), plain=(0, 0)):
        raise AssertionError(f"golden currents launches {launched}")
    if not (err.pop("fl1") <= TRAJ_TOL
            and max(err.values()) <= TRAJ_STRESS_TOL):
        raise AssertionError("golden currents: kernels disagree with plain")

    # kernel A with currents, and the CFL retry mask
    for name, kw, obs in (("currents irefra 3, CFL retry",
                           cases.currents_kw(3, cfl=True), False),
                          ("currents irefra 2, sub-band passes",
                           cases.currents_kw(2, fast=True), False),
                          ("golden currents",
                           cases.golden_kw(3, currents=True), True)):
        advect_small(name, kw, dev, obs)

    # kernel B and C with the options on the small grids
    small_case("shallow cy50r1", cases.shallow_kw(True), dev,
               forcing=cases.shallow_ice)
    small_case("golden cy49r1", dict(cases.golden_kw(), **cases.CY49R1),
               dev, forcing=cases.storm)

    # O320 with the options: the main path through the kernels
    t0 = time.perf_counter()
    ms, model = cases.o320_options(dev)
    ft, fp = ms.fused, model.fp
    cur = ms.env["ucur"][:ms.n_real] ** 2 + ms.env["vcur"][:ms.n_real] ** 2
    log(f"O320 options build {time.perf_counter() - t0:.1f} s: irefra "
        f"{ms.irefra}, peak current {float(cur.max().sqrt()):.3f} m/s, "
        f"CFL retry masks {int(fp.cfl_bad.sum())} of {ft.nsrl} rows; "
        f"CHECKCFL {fp.cfl_diagnostics()}")
    plain = FusedPropagation(ms, plain=True)
    differ = int((plain.cfl_bad != fp.cfl_bad).sum())
    log(f"O320 options CFL retry mask, kernel vs plain: {differ} rows "
        "differ")
    if differ:
        raise AssertionError("O320 options: CFL retry masks differ")
    del plain
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    pcu.advect.launches = 0
    ipk.implsch_srl.launches = 0
    steps = []
    for _ in range(4):
        t_p, t_f = model.timers.propag, model.timers.phys
        model.advance(1)
        steps.append((model.timers.propag - t_p, model.timers.phys - t_f))
    model.advance(1)
    ipk.implsch_srl.full_launches = 0
    t_f = model.timers.phys
    model.advance(1, full_phys=True)
    t_full = model.timers.phys - t_f
    launches = dict(advect=pcu.advect.launches,
                    implsch=ipk.implsch_srl.launches,
                    implsch_full=ipk.implsch_srl.full_launches)
    n = ms.n_real
    norms = {k: (float(v[:n].mean()), float(v[:n].min()), float(v[:n].max()))
             for k, v in (("swh", torch.as_tensor(model.swh())),
                          ("esea", model.state["sep"]["esea"]),
                          ("ufric", model.state["ufric"]))}
    log("O320 options steps (t_propag s, t_phys s): "
        + ", ".join(f"({a:.4f}, {b:.4f})" for a, b in steps)
        + f"; output date t_phys {t_full:.4f} s; launches {launches}; "
        f"peak allocation {torch.cuda.max_memory_allocated() / 1e9:.2f} GB;"
        f" norms (avg, min, max) "
        + ", ".join(f"{k} {v}" for k, v in norms.items()))
    if min(launches.values()) <= 0:
        raise AssertionError(f"O320 options bypassed a kernel: {launches}")
    if not all(np.isfinite(v).all() and v[1] > 0 for k, v in norms.items()
               if k != "esea"):
        raise AssertionError("O320 options norms not finite and positive")
    above_cut = ms.tb.nfre - 1 - float(model.state["mij"][:n].double().mean())

    a = advect_check(model, ft, ms.irefra)
    log(f"advect currents (O320, irefra {ms.irefra}): kernel {a[2]:.3f} ms,"
        f" plain {a[3]:.3f} ms, max|k-p| {a[1]:.3e} = {a[0]:.3e} of max "
        f"(tol {ADVECT_TOL}); {a[4] / 1e9:.3f} GB a pass")
    if not a[0] <= ADVECT_TOL:
        raise AssertionError("O320 options: advection kernel disagrees")
    sl = {}
    for full in (False, True):
        mode = "full" if full else "minimal"
        r = sl[mode] = slice_check(ms, model, dev, full, above_cut)
        log(f"implsch {mode} options ({PHYS_ROWS} rows): kernel "
            f"{r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms; spectrum "
            f"{r['spec_rel']:.3e} of max, stress {r['stress_rel']:.3e}"
            + (f", worst row {max(r['rows'].values()):.3e}" if full else "")
            + f"; {r['n_tie']} FRCUTINDEX ties, {r['n_gc']} of "
            f"{r['n_sea']} rows on a gc edge (stress off by up to "
            f"{r['gc_stress']:.3e}, largest margin {r['gc_margin']:.3e}), "
            f"{r['n_off']} other rows off"
            + (f"; kernel on all rows {r['all_rows_ms']:.3f} ms"
               if not full else "")
            + f"; bound on all rows {r['all_rows_bound'][0]:.3f} ms "
            f"({r['all_rows_bound'][1]}); compact: spectrum "
            f"{r['compact']['spec_rel']:.3e}, same as SRL "
            f"{r['compact']['same_as_srl']}")
        check_slice(r, full, f"implsch {mode} options")
    # the same slice under storm winds, where LLCAPCHNK's capped Charnock
    # parameter and RNFAC act (above about 25 m/s), with the same limits
    n_storm = int((storm_winds(PHYS_ROWS) > 25.0).sum())
    for full in (False, True):
        mode = "full" if full else "minimal"
        r = sl[f"storm_{mode}"] = slice_check(ms, model, dev, full,
                                              above_cut, storm=True)
        log(f"implsch {mode} options, storm winds 5–55 m/s ({n_storm} of "
            f"{PHYS_ROWS} rows above 25 m/s): kernel {r['ms']:.3f} ms; "
            f"spectrum {r['spec_rel']:.3e} of max, stress "
            f"{r['stress_rel']:.3e}"
            + (f", worst row {max(r['rows'].values()):.3e}" if full else "")
            + f"; {r['n_tie']} FRCUTINDEX ties, {r['n_gc']} of "
            f"{r['n_sea']} rows on a gc edge (largest margin "
            f"{r['gc_margin']:.3e}), {r['n_off']} other rows off; compact: "
            f"spectrum {r['compact']['spec_rel']:.3e}, same as SRL "
            f"{r['compact']['same_as_srl']}")
        check_slice(r, full, f"implsch {mode} options, storm winds")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.advance(8)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / 8
    a0 = pcu.advect.launches
    wall, split, busy, tries = profile(lambda: model.advance(4))
    log(f"O320 options steady state: mean step {step_s * 1e3:.3f} ms over 8 "
        f"steps; profiled 4 steps ({pcu.advect.launches - a0} advection "
        f"launches by the wrapper's count, {tries} window(s)): wall "
        f"{wall:.3f} ms, device busy "
        f"{busy:.3f} ms ({100 * busy / wall:.1f} %); "
        + ", ".join(f"{k} {t:.3f} ms in {n_} launches"
                    for k, (t, n_) in split.items()))
    model.advance(1)
    a0 = pcu.advect.launches
    wall, split, busy, tries = profile(
        lambda: model.advance(1, full_phys=True))
    log(f"O320 options profiled output date ({pcu.advect.launches - a0} "
        f"advection launches by the wrapper's count, {tries} window(s)): "
        f"wall {wall:.3f} ms, "
        f"device busy {busy:.3f} ms; "
        + ", ".join(f"{k} {t:.3f} ms in {n_} launches"
                    for k, (t, n_) in split.items()))
    return dict(launches=launches, advect=a, minimal=sl["minimal"],
                full=sl["full"])


def small_case(name, kw, dev, *, forcing=None, phys=None):
    """One physics step of a small grid, kernel B (both modes) and kernel
    C (both modes) against plain, with the gravity-capillary and
    peak-tie hold-outs; raises on a disagreement."""
    from ecwam_tpu_torch.model import cases
    hold = dict(gc_width=GC_WIDTH, peak_width=PEAK_WIDTH, off_tol=STRESS_TOL,
                forcing=forcing, phys=phys)
    spec, stress, held = cases.physics_kernel_vs_plain(kw, dev, **hold)
    f = cases.full_kernel_vs_plain(kw, dev, width=MASK_WIDTH, **hold)
    cap = max(1.0, max(GC_SHARE, PEAK_SHARE) * f["n"])
    worst = max(f["rows"], key=f["rows"].get)
    log(f"{name} physics step, kernel vs plain: minimal spectrum "
        f"{spec:.3e}, stress {stress:.3e}; full spectrum {f['spec']:.3e}, "
        f"worst row {worst} {f['rows'][worst]:.3e}, strnms "
        f"{f['rows']['strnms']:.3e}; xllws {f['xllws']} bins on the edge, "
        f"{f['off_edge']} off it; rows held on a gc edge or peak tie "
        f"{held} / {f['held']} of {f['n']}")
    ok = (spec <= PHYS_TOL and stress <= STRESS_TOL
          and f["spec"] <= PHYS_TOL and f["rows"][worst] <= FULL_ROW_TOL
          and f["off_edge"] == 0 and f["xllws"] <= XLLWS_SHARE * f["bins"]
          and max(held, f["held"]) <= cap)
    for full in (False, True):
        c = cases.compact_kernel_vs_plain(kw, dev, full=full,
                                          width=MASK_WIDTH, **hold)
        log(f"{name} compact entry {'full' if full else 'minimal'}: "
            f"spectrum {c['spec']:.3e}, rows {c['rows']:.3e}, xllws off "
            f"the edge {c['off_edge']}, held {c['held']}")
        ok = ok and (c["spec"] <= PHYS_TOL and c["off_edge"] == 0
                     and c["rows"] <= (FULL_ROW_TOL if full else STRESS_TOL)
                     and c["held"] <= cap)
    if not ok:
        raise AssertionError(f"{name}: physics kernel disagrees")


def legacy_phase(dev) -> dict:
    """Phase 6 (see the module docstring); returns the readings of the
    kernels line's legacy entries."""
    import numpy as np
    import torch
    from ecwam_tpu_torch.model import cases
    from ecwam_tpu_torch.ops import propagation_cuda as pcu
    from ecwam_tpu_torch.ops.physics import implsch_cuda as ipk

    for name in cases.LEGACY_CASES:
        c = cases.legacy_case(name)
        small_case(name, c["kw"], dev, forcing=c["forcing"], phys=c["phys"])

    t0 = time.perf_counter()
    ms, model = cases.o320_legacy(dev)
    ft = ms.fused
    depth = ms.env["depth"][:ms.n_real]
    log(f"O320 legacy build {time.perf_counter() - t0:.1f} s: iphys "
        f"{ms.phys.params.iphys}, isnonlin {ms.phys.isnonlin}, lciwa1 "
        f"{ms.phys.lciwa1}, lstrn {ms.phys.lstrn}; depth "
        f"{float(depth.min()):.1f}–{float(depth.max()):.1f} m")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pcu.advect.launches = 0
    ipk.implsch_srl.launches = 0
    ipk.implsch_srl.full_launches = 0
    steps = []
    for _ in range(4):
        t_p, t_f = model.timers.propag, model.timers.phys
        model.advance(1)
        steps.append((model.timers.propag - t_p, model.timers.phys - t_f))
    model.advance(1)
    t_f = model.timers.phys
    model.advance(1, full_phys=True)
    t_full = model.timers.phys - t_f
    launches = dict(advect=pcu.advect.launches,
                    implsch=ipk.implsch_srl.launches,
                    implsch_full=ipk.implsch_srl.full_launches)
    n = ms.n_real
    st = model.state
    norms = {k: (float(v[:n].mean()), float(v[:n].min()), float(v[:n].max()))
             for k, v in (("swh", torch.as_tensor(model.swh())),
                          ("esea", st["sep"]["esea"]),
                          ("ufric", st["ufric"]), ("strnms", st["strnms"]))}
    log("O320 legacy steps (t_propag s, t_phys s): "
        + ", ".join(f"({a:.4f}, {b:.4f})" for a, b in steps)
        + f"; output date t_phys {t_full:.4f} s; launches {launches}; "
        f"peak allocation {torch.cuda.max_memory_allocated() / 1e9:.2f} GB;"
        f" norms (avg, min, max) "
        + ", ".join(f"{k} {v}" for k, v in norms.items()))
    if min(launches.values()) <= 0:
        raise AssertionError(f"O320 legacy bypassed a kernel: {launches}")
    if not all(np.isfinite(v).all() for v in norms.values()):
        raise AssertionError("O320 legacy norms not finite")
    if not (norms["swh"][1] > 0 and norms["ufric"][1] > 0
            and norms["strnms"][2] > 0):
        raise AssertionError("O320 legacy: no wave height, u* or ice strain")
    above_cut = ms.tb.nfre - 1 - float(st["mij"][:n].double().mean())

    # the slice with the most partly iced rows, where SDICE1 and the
    # strain act
    r0 = ice_slice(ms)
    ci = model._frc6[ipk.SCAL_IN.index("cicover")][r0:r0 + PHYS_ROWS]
    log(f"O320 legacy slice from SRL row {r0}: {int((ci > 0).sum())} of "
        f"{PHYS_ROWS} rows iced, {int(((ci > 0) & (ci < 1)).sum())} partly")
    sl = {}
    for full in (False, True):
        mode = "full" if full else "minimal"
        r = sl[mode] = slice_check(ms, model, dev, full, above_cut, r0)
        log(f"implsch {mode} legacy ({PHYS_ROWS} rows): kernel "
            f"{r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms; spectrum "
            f"{r['spec_abs']:.3e} = {r['spec_rel']:.3e} of max, stress "
            f"{r['stress_rel']:.3e}"
            + (f", rows " + ", ".join(f"{k} {v:.2e}"
                                      for k, v in r["rows"].items())
               + f"; xllws {r['xllws']} of {r['xllws_bins']} bins on the "
               f"edge, {r['xllws_off']} off it (largest |margin| "
               f"{r['margin']:.3e})" if full else "")
            + f"; {r['n_tie']} FRCUTINDEX ties, {r['n_peak']} of "
            f"{r['n_sea']} rows on a peak tie (off by up to "
            f"{r['peak_err']:.3e}, largest margin {r['peak_margin']:.3e}, "
            f"width {PEAK_WIDTH}; rows that agree: smallest margin "
            f"{r['peak_sound']['min']:.3e}, smallest nonzero "
            f"{r['peak_sound']['min_nonzero']:.3e}, "
            f"{r['peak_sound']['zero']} at 0, "
            f"{r['peak_sound']['within']} within the width), "
            f"{r['n_off']} other rows off"
            + (f"; kernel on all rows {r['all_rows_ms']:.3f} ms"
               if not full else "")
            + f"; bound on all rows {r['all_rows_bound'][0]:.3f} ms "
            f"({r['all_rows_bound'][1]}); compact: spectrum "
            f"{r['compact']['spec_rel']:.3e}, same as SRL "
            f"{r['compact']['same_as_srl']}")
        check_slice(r, full, f"implsch {mode} legacy")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.advance(8)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / 8
    bins = ms.n_real * ms.tb.nang * ms.tb.nfre
    a0 = pcu.advect.launches
    wall, split, busy, tries = profile(lambda: model.advance(4))
    log(f"O320 legacy steady state: mean step {step_s * 1e3:.3f} ms over 8 "
        f"steps = {bins / step_s / 1e9:.3f} Gbins/s; profiled 4 steps "
        f"({pcu.advect.launches - a0} advection launches by the wrapper's "
        f"count, {tries} window(s)): wall {wall:.3f} ms, device busy "
        f"{busy:.3f} ms "
        f"({100 * busy / wall:.1f} %); "
        + ", ".join(f"{k} {t:.3f} ms in {n_} launches"
                    for k, (t, n_) in split.items()))
    model.advance(1)
    wall, split, busy, tries = profile(
        lambda: model.advance(1, full_phys=True))
    log(f"O320 legacy profiled output date ({tries} window(s)): wall "
        f"{wall:.3f} ms, device busy "
        f"{busy:.3f} ms; "
        + ", ".join(f"{k} {t:.3f} ms in {n_} launches"
                    for k, (t, n_) in split.items())
        + f"; the rest {busy - sum(t for t, _ in split.values()):.3f} ms")
    return dict(launches=launches, minimal=sl["minimal"], full=sl["full"])


def opclass_phase(dev) -> list:
    """Phase 7: kernel D, each op class at K=8 over 16,384 lanes against
    its plain version, then at the reference's size (K=64 over 131,072
    lanes) one call against plain and one timed run of 8 chained calls;
    returns the readings."""
    import torch
    from ecwam_tpu_torch.tools import opclass as oc
    x = oc.start(128 * 1024, dev)
    small = x[..., :16384].contiguous()
    checks = {name: oc.check(name, small, 8) for name in oc.CLASSES}
    del small
    out = []
    oc.opclass.launches = 0
    for name in oc.CLASSES:
        big = oc.check(name, x, 64)
        n0 = oc.opclass.launches
        r = oc.measure(name, x, 64, 8)
        r.update(launches=oc.opclass.launches - n0, **checks[name])
        r["max_abs_err"] = max(r["max_abs_err"], big["max_abs_err"])
        r["max_rel_err"] = max(r["max_rel_err"], big["max_rel_err"])
        r["ok"] = r["ok"] and big["ok"]
        out.append(r)
        tol = "exact" if name in oc.LAYOUT else "tol 1e-6"
        log(f"opclass {name}: K=8 check max|k-p| "
            f"{checks[name]['max_abs_err']:.3e} = "
            f"{checks[name]['max_rel_err']:.3e} of max, K=64 check "
            f"{big['max_abs_err']:.3e} = {big['max_rel_err']:.3e} of max "
            f"({tol}); K=64 over {r['lanes']} lanes: kernel "
            f"{r['ms']:.3f} ms = {r['ns_per_app_tile']:.3f} ns/app/tile, "
            f"plain {r['plain_ms']:.3f} ms, library {r['library_ms']}; bound "
            f"{r['bound_ms']:.3f} ms ({r['bound_by']}: hbm {r['hbm_ms']:.3f},"
            f" ops {r['ops_ms']:.3f}, smem {r['smem_ms']:.3f}) = "
            f"{100 * r['share']:.1f} %; the first design's smem bound "
            f"{r['smem_first_ms']:.3f}; {r['launches']} launches")
        if not r["ok"]:
            raise AssertionError(f"opclass {name}: kernel disagrees")
    del x
    torch.cuda.empty_cache()
    return out


def cli_run(cfg_text, rundir, dev, *, plain=False, quiet=True):
    """``python -m ecwam_tpu_torch run``'s loop in-process: (model, log
    entries, output timers, the kernels' launches in the run, wall s)."""
    import torch
    from ecwam_tpu_torch.cli import main as cli
    from ecwam_tpu_torch.config.schema import RunConfig
    from ecwam_tpu_torch.device import synchronize
    from ecwam_tpu_torch.ops import propagation_cuda as pcu
    from ecwam_tpu_torch.ops.physics import implsch_cuda as ipk
    synchronize(dev)
    pcu.advect.launches = 0
    ipk.implsch_srl.launches = ipk.implsch_srl.full_launches = 0
    ipk.implsch_compact.launches = 0
    timers = cli.OutputTimers()
    t0 = time.perf_counter()
    model, slog = cli.run_model(RunConfig.from_yaml(cfg_text), rundir,
                                device=dev, plain=plain, quiet=quiet,
                                timers=timers)
    synchronize(dev)
    wall = time.perf_counter() - t0
    n = dict(launch_counters(), implsch_compact=ipk.implsch_compact.launches)
    return model, slog.entries, timers, n, wall


def _check_launches(what, got, model, cfg_text, plain):
    from ecwam_tpu_torch.cli import checks
    from ecwam_tpu_torch.config.schema import RunConfig
    want = (dict(advect=0, implsch=0, implsch_full=0, implsch_compact=0)
            if plain else checks.expected_launches(
                RunConfig.from_yaml(cfg_text), model.setup,
                model.fp.nsub if hasattr(model, "fp") else 1))
    log(f"{what}: launches {got} (the date loop implies {want})")
    if got != want:
        raise AssertionError(f"{what}: launches {got} != {want}")


def cli_phase(dev, *, small=None, full=None, rows=PRODUCT_ROWS,
              launches=True) -> dict:
    """Phase 8: the command line's run loop (``cli.main.run_model``, what
    ``python -m ecwam_tpu_torch run --config C --rundir R`` runs) on a
    small configuration and at full width; returns the readings.
    ``small``/``full`` override the configurations' keywords (a rehearsal
    on the CPU passes small grids and ``launches=False``)."""
    import shutil
    import numpy as np
    import torch
    from ecwam_tpu_torch.cli import checks
    from ecwam_tpu_torch.ops import secondorder as so_mod
    from ecwam_tpu_torch.ops.physics import means
    from ecwam_tpu_torch.device import synchronize
    cuda = dev.type == "cuda"
    work = os.path.join(ROOT, "build", "chip_smoke_cli")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    frc = checks.write_forcing(os.path.join(work, "forcing.npz"), 6)
    out = {}
    try:
        # -- 8a. 12°, kernels and plain versions, and a resumed run
        kw = dict(dict(grid="12.0", directions=12, frequencies=15, adv=900,
                       phys=900, hours=3, forcing=frc, restarts=(2, 3)),
                  **(small or {}))
        text = checks.run_yaml(**kw)
        runs = {}
        for name, plain in (("kernels", False), ("plain", True)):
            rd = os.path.join(work, f"small_{name}")
            model, entries, tm, n, wall = cli_run(text, rd, dev, plain=plain)
            if launches:
                _check_launches(f"CLI 12° {name}", n, model, text, plain)
            runs[name] = entries
            del model
        err, where = checks.stats_error(runs["kernels"], runs["plain"])
        log(f"CLI 12° ({kw['directions']}x{kw['frequencies']}, "
            f"{len(checks.FIELDS)} fields hourly from 1 h, second order "
            f"on, {kw['hours']} h): statistics.log kernels vs plain on the "
            f"card {err:.3e} of the entry's magnitude at {where} (limit "
            f"{CLI_STATS_TOL}); {len(runs['kernels'])} entries")
        out["small_stats"] = err
        rst = "restart_20230101020000.npz"
        leg = os.path.join(work, "small_resumed")
        os.makedirs(leg)
        shutil.copy(os.path.join(work, "small_kernels", rst), leg)
        _, resumed, _, _, _ = cli_run(checks.run_yaml(**dict(kw, begin=2)),
                                      leg, dev)
        same = checks.restarts_equal(
            os.path.join(work, "small_kernels", "restart_20230101030000.npz"),
            os.path.join(leg, "restart_20230101030000.npz"))
        late = [e for e in runs["kernels"] if e["time"] > "20230101020000"]
        r_err, _ = checks.stats_error(resumed, late)
        log(f"CLI 12° resumed from the 2 h restart: 3 h restart bit for bit "
            f"equal to the uninterrupted run's {same}; statistics "
            f"{r_err:.1e} off")
        if not (err <= CLI_STATS_TOL and same and r_err == 0.0):
            raise AssertionError("CLI 12°: kernels disagree with plain or "
                                 "the resumed run differs")

        # -- 8b. full width: O320 36x36/29, 6 h, every field hourly
        kw = dict(dict(grid="O320", directions=36, frequencies=29,
                       physics_frequencies=36, adv=450, phys=900, hours=6,
                       forcing=frc, restarts=(3, 6)), **(full or {}))
        text = checks.run_yaml(**kw)
        rd = os.path.join(work, "full")
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        model, entries, tm, n, wall = cli_run(text, rd, dev)
        if launches:
            _check_launches(f"CLI {kw['grid']}", n, model, text, False)
        ms = model.setup
        st = model.timers
        peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else None
        out_s = tm.products + tm.secondorder + tm.d2h + tm.write
        log(f"CLI {kw['grid']} ({ms.n_real} sea points, {kw['directions']}x"
            f"{kw['physics_frequencies']}/{kw['frequencies']}, "
            f"{kw['hours']} h, {len(checks.FIELDS)} fields hourly in GRIB, "
            f"second order on): wall {wall:.3f} s for {st.steps} steps and "
            f"{tm.dates} output dates; propag {st.propag:.3f} s, phys "
            f"{st.phys:.3f} s (of which full mode on output dates "
            f"{st.phys_full:.3f} s); per output date: full-mode physics "
            f"{st.phys_full / tm.dates:.4f} s, products "
            f"{tm.products / tm.dates:.4f} s, second order "
            f"{tm.secondorder / tm.dates:.4f} s, device-to-host copies "
            f"{tm.d2h / tm.dates:.4f} s, statistics/GRIB write "
            f"{tm.write / tm.dates:.4f} s (output {out_s / tm.dates:.4f} s); "
            f"{tm.restarts} restarts written in {tm.restart:.3f} s; "
            f"peak allocation {peak} GB; memory_report "
            f"{model.memory_report()}")
        bad = [e for e in entries if not all(
            np.isfinite(e[q]) for q in ("average", "minimum", "maximum"))]
        if len(entries) != tm.dates * len(checks.FIELDS) or bad:
            raise AssertionError(f"CLI {kw['grid']}: {len(entries)} "
                                 f"statistics entries, {len(bad)} not finite")
        out.update(wall=wall, timers=tm, steps=st, peak=peak,
                   launches=n)

        # second order alone on one output chunk of 65,536 points
        so = so_mod.build_second_order_tables(ms.tb)
        tabs = so_mod.device_tables(so, ms.env["depth"])
        cnt = min(65536, ms.n_pad)
        fl = model.fl1_chunk(0, cnt)
        wavnum = ms.env["wavnum"][:, :cnt]
        depth = ms.env["depth"][:cnt]
        ak = means.fkmean(fl, wavnum, ms.tb)[3]
        pf1 = fl[so.k_half][:, so.m_half]

        def host_ms(fn, reps=3):
            fn()
            synchronize(dev)
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            synchronize(dev)
            return (time.perf_counter() - t0) / reps * 1e3
        if cuda:
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        t_sec = host_ms(lambda: so_mod.secspom(pf1, depth, ak, so,
                                               tabs=tabs))
        sec_peak = ((torch.cuda.max_memory_allocated() - base) / 1e9
                    if cuda else None)
        t_cal = host_ms(lambda: so_mod.cal_second_order_spec(
            fl, wavnum, depth, ms.tb, so, tabs=tabs))
        flop = 2.0 * cnt * (5 * so.nang_h**2 * so.nfre_h**2
                            + so.nang_h * so.nang_h * so.nfre_h**2)
        log(f"second order on {cnt} points ({so.nang_h}x{so.nfre_h} "
            f"thinned, sub-chunks of {so_mod.SECSPOM_CHUNK}): secspom "
            f"{t_sec:.3f} ms ({flop / 1e9:.1f} GFLOP of its two "
            f"contractions, {flop / t_sec / 1e9:.2f} TFLOP/s; "
            f"{flop / FP32_OPS_PER_S * 1e3:.3f} ms at the float32 peak), "
            f"peak allocation {sec_peak} GB above the resident state; "
            f"cal_second_order_spec {t_cal:.3f} ms")
        out.update(secspom_ms=t_sec, cal_ms=t_cal, secspom_peak=sec_peak,
                   secspom_points=cnt)
        del fl, wavnum, depth, ak, pf1

        # products of one chunk on the card against float64 on the CPU
        start = min(ms.n_real // 2, ms.n_pad - rows)
        t0 = time.perf_counter()
        pr = checks.products_vs_f64(model, start, rows, tol=PRODUCT_TOL,
                                    width=EDGE_WIDTH, so=so)
        fields = pr["fields"]
        worst = max(fields, key=lambda k: fields[k][0])
        held = sum(v[1] for v in fields.values())
        off = sum(v[2] for v in fields.values())
        log(f"products on points [{start}, {start + rows}) after the "
            f"second order, card (float32) vs CPU (float64), "
            f"{time.perf_counter() - t0:.1f} s: worst {worst} "
            f"{fields[worst][0]:.3e} of its largest magnitude (limit "
            f"{PRODUCT_TOL}); {held} field-points over the limit held out "
            f"on a decision edge (width {EDGE_WIDTH}; at most "
            f"{EDGE_SHARE} of {rows} a field), {off} off every edge; "
            f"points within the width of each edge {pr['edge']}; by field "
            f"(max error, held, off): " + ", ".join(
                f"{k} {v[0]:.2e}" + (f"/{v[1]}/{v[2]}" if v[1] or v[2]
                                     else "")
                for k, v in fields.items()))
        out["products"] = pr
        if off or max(v[1] for v in fields.values()) > EDGE_SHARE * rows:
            raise AssertionError("products on the card disagree with "
                                 "float64")
        del model
        if cuda:
            torch.cuda.empty_cache()

        # resumed from the 3 h restart to 6 h
        leg = os.path.join(work, "full_resumed")
        os.makedirs(leg)
        shutil.copy(os.path.join(rd, "restart_20230101030000.npz"), leg)
        _, resumed, _, _, wall2 = cli_run(
            checks.run_yaml(**dict(kw, begin=3)), leg, dev)
        same = checks.restarts_equal(
            os.path.join(rd, "restart_20230101060000.npz"),
            os.path.join(leg, "restart_20230101060000.npz"))
        late = [e for e in entries if e["time"] > "20230101030000"]
        r_err, _ = checks.stats_error(resumed, late)
        log(f"CLI {kw['grid']} resumed from the 3 h restart ({wall2:.1f} s):"
            f" 6 h restart bit for bit equal to the uninterrupted run's "
            f"{same}; statistics {r_err:.1e} off")
        if not (same and r_err == 0.0):
            raise AssertionError("the resumed run differs")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out



# the full-mode rows that are components of one vector
VECTOR_ROWS = (("tauxd", "tauyd"), ("tauocxd", "tauocyd"),
               ("ustokes", "vstokes"))


def compact_check(cfg, fl, env2d, scal, *, reps=10) -> dict:
    """Kernel C against its plain version on compact points (``fl``
    (nang, nfre, n) with its env and SCAL_IN rows), in full mode, as
    :func:`slice_check` holds kernel B: points whose FRCUTINDEX argument
    lies within TIE_WIDTH of a rounding tie (float64) are held out, at
    most TIE_SHARE of them; under u* forcing, points off the limits whose
    Z0WAVE gap (u*² − τw)/u*² lies within Z0_WIDTH (float64, state
    ``z0_margin``) too, at most Z0_SHARE of them; windsea-mask bins may
    differ only on the mask's edge (``cases.full_errors``).  The wave-stress direction is
    compared on the circle (over 2π) and the components of a vector
    (VECTOR_ROWS) over the vector's largest magnitude.  Returns the
    readings, the times of both versions, and the bytes and operations of
    the bound (counted for this step's cut and windsea mask)."""
    import torch
    from ecwam_tpu_torch.core.dispersion import BATHYMAX
    from ecwam_tpu_torch.model import cases
    from ecwam_tpu_torch.ops.physics import implsch as impl
    from ecwam_tpu_torch.ops.physics import implsch_cuda as ipk
    tabs = ipk.pack_tables(cfg, fl.device)

    def run(_=None):
        return ipk.implsch_compact(cfg, fl, env2d, scal, full=True,
                                   tables_dev=tabs)

    def plain(_=None):
        return ipk.implsch_compact_plain(cfg, fl, env2d, scal, full=True)
    got, want = run(), plain()
    if not all(bool(torch.isfinite(x).all()) for x in got):
        raise AssertionError("kernel C produced non-finite values")
    n, nst = fl.shape[-1], len(ipk.STRESS_KEYS)
    fe = cases.full_errors(got[1], want[1], got[2], want[2],
                           cases.compact_margin(cfg, fl, env2d, scal),
                           MASK_WIDTH)
    err = fe["err"]
    keys = ipk.out_keys(cfg, True)
    # a direction on the circle over 2π, and each component of a vector
    # over the vector's largest magnitude: under a uniform wind one
    # component and the wave-stress direction are round-off around 0
    # (both versions, and float64 alike), which no relative limit holds
    d = (got[1] - want[1]).abs()
    i = keys.index("tauwdir")
    err[i] = torch.minimum(d[i], 2.0 * math.pi - d[i]) / (2.0 * math.pi)
    for x, y in VECTOR_ROWS:
        ix, iy = keys.index(x), keys.index(y)
        mag = torch.hypot(want[1][ix], want[1][iy]).max().clamp(min=1e-30)
        err[ix], err[iy] = d[ix] / mag, d[iy] / mag
    s_row = err[:nst].amax(0)
    off = torch.nonzero((s_row > STRESS_TOL)
                        | (err[nst:].amax(0) > FULL_ROW_TOL)).flatten()
    tie = torch.zeros(n, dtype=torch.bool, device=fl.device)
    z0 = torch.zeros_like(tie)
    z0_m = torch.zeros(0, dtype=torch.float64, device=fl.device)
    if 0 < off.numel() <= (TIE_SHARE + Z0_SHARE) * n:
        env, frc, stress = ipk._unpack_inputs(cfg, env2d[:, off].double(),
                                              scal[:, off].double())
        st = impl.implsch(cfg, fl[..., off].double(), env, frc, *stress)[1]
        dist = st["frcut_tie"]
        tie[off[dist < TIE_WIDTH]] = True
        if "z0_margin" in st:
            # u* forcing: Z0WAVE's root of u*² − τw, ill-conditioned where
            # the gap is small (its float64 margin)
            z0_m = st["z0_margin"]
            z0[off[(z0_m < Z0_WIDTH) & (dist >= TIE_WIDTH)]] = True
            z0_m = z0_m[z0[off]]
    keep = ~tie & ~z0
    spec = rel_max(got[0][..., keep], want[0][..., keep])
    rk = err[:, keep].amax(1)
    mij = got[1][keys.index("mij")]
    depth, cithick = (ipk.SCAL_IN.index(k) for k in ("depth", "cithick"))
    data = dict(above_cut=cfg.tables.nfre - 1 - float(mij.double().mean()),
                windsea=float(got[2].mean()),
                shallow=float((scal[depth] < BATHYMAX).double().mean()),
                gc_terms=gc_terms(got[1][keys.index("ufric")]),
                ice=float((scal[cithick] > 0).double().mean()))
    return dict(
        n=n, n_tie=int(tie.sum()), n_z0=int(z0.sum()),
        z0_margin=float(z0_m.max()) if z0_m.numel() else 0.0,
        n_off=off.numel() - int(tie.sum()) - int(z0.sum()),
        spec_rel=spec[0], spec_abs=spec[1],
        stress_rel=float(s_row[keep].max()),
        rows={k: float(rk[i]) for i, k in enumerate(keys)},
        xllws=int(fe["edge"][keep].sum()),
        xllws_off=int(fe["off"][keep].sum()),
        xllws_bins=got[2][..., keep].numel(),
        ms=cuda_ms(run, reps) if fl.is_cuda else None,
        plain_ms=cuda_ms(plain, 2) if fl.is_cuda else None,
        bytes=nbytes(fl, env2d, scal, *got),
        ops=n * implsch_ops(cfg, cfg.tables.nang, True, **data))


def check_compact(r, name):
    """Fail unless :func:`compact_check`'s readings meet the limits (the
    U10 row of u* forcing at STRESS_TOL)."""
    rows = dict(r["rows"])
    u10 = rows.pop("wswave", 0.0)
    ok = (r["n_off"] == 0 and r["n_tie"] <= TIE_SHARE * r["n"]
          and r["n_z0"] <= Z0_SHARE * r["n"]
          and r["spec_rel"] <= PHYS_TOL and r["stress_rel"] <= STRESS_TOL
          and max(rows.values()) <= FULL_ROW_TOL and u10 <= STRESS_TOL
          and r["xllws_off"] == 0
          and r["xllws"] <= XLLWS_SHARE * r["xllws_bins"])
    log(f"{name}: spectrum {r['spec_rel']:.3e} of max (tol {PHYS_TOL}), "
        f"stress {r['stress_rel']:.3e} (tol {STRESS_TOL})"
        + (f", U10 row {u10:.3e} (tol {STRESS_TOL})" if "wswave" in r["rows"]
           else "")
        + f"; rows worst {max(rows, key=rows.get)} {max(rows.values()):.2e} "
        f"(tol {FULL_ROW_TOL}); {r['n_tie']} of {r['n']} points on an "
        f"FRCUTINDEX tie, {r['n_z0']} within Z0_WIDTH {Z0_WIDTH} of Z0WAVE's "
        f"gap (largest margin held {r['z0_margin']:.3e}), {r['n_off']} "
        f"others off; xllws {r['xllws']} of "
        f"{r['xllws_bins']} bins differ on the mask's edge and "
        f"{r['xllws_off']} off it"
        + (f"; kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms"
           if r["ms"] is not None else ""))
    if not ok:
        raise AssertionError(f"{name}: kernel C disagrees with plain")


def o320_wavemodel(dev, mode, **over):
    """The dense ``WaveModel`` at O320 (:data:`O320_KW`, with ``over``'s
    keywords) in weight ``mode`` (``otf`` in blocks of cases.OTF_BLOCK),
    under :func:`o320_wind`, from the JONSWAP cold start."""
    from ecwam_tpu_torch.model import cases, driver
    from ecwam_tpu_torch.model import setup as setup_mod
    ms = setup_mod.build_model(device=dev, weights_mode=mode,
                               otf_block=cases.OTF_BLOCK,
                               **dict(O320_KW, **over))
    wind = o320_wind(ms.n_real)
    return ms, driver.WaveModel(ms, lambda date14: wind, cases.START)


def wavemodel_phase(dev, *, o320=None, cli=None, launches=True,
                    rows=PHYS_ROWS) -> dict:
    """Phase 9: the dense ``WaveModel`` on the card (see the module
    docstring); returns the readings.  ``o320``/``cli`` override the full
    width's and the CLI run's keywords (a rehearsal on the CPU passes small
    grids and ``launches=False``)."""
    import dataclasses
    import shutil
    import numpy as np
    import torch
    from ecwam_tpu_torch.cli import checks
    from ecwam_tpu_torch.device import synchronize
    from ecwam_tpu_torch.model import cases, stepper
    from ecwam_tpu_torch.ops import propagation as prop
    from ecwam_tpu_torch.ops import propagation_cuda as pcu
    from ecwam_tpu_torch.ops.physics import implsch_cuda as ipk
    cuda = dev.type == "cuda"
    out = {}

    # -- 9a. the golden grid: each configuration and weight mode
    for config in cases.WAVEMODEL_CASES:
        for mode in cases.WEIGHT_MODES:
            err, launched, want = cases.wavemodel_kernel_vs_plain(
                dev, config, mode)
            log(f"WaveModel {config} {mode}, 4 steps, kernels vs plain "
                f"(tolerance fl1 {TRAJ_TOL}, stress {TRAJ_STRESS_TOL}): "
                + ", ".join(f"{k} {v:.3e}" for k, v in err.items())
                + f"; (kernel A passes, kernel C launches) {launched}, the "
                f"step loop implies {want}")
            if launches and launched != dict(kernels=want, plain=(0, 0)):
                raise AssertionError(f"WaveModel {config} {mode}: launches")
            if not (err.pop("fl1") <= TRAJ_TOL
                    and max(err.values()) <= TRAJ_STRESS_TOL):
                raise AssertionError(f"WaveModel {config} {mode}: kernels "
                                     "disagree with plain")

    # -- 9b. u* forcing through kernel C's UST instantiation
    out["ustar_launches"] = 0
    for icode in (1, 2):
        c0 = ipk.implsch_compact.launches
        ms, m = cases.ustar_model(dev, icode)
        n = ms.n_real
        us = float((m.stress["ufric"][:n] - 0.5).abs().max())
        m.advance(2)
        n_c = ipk.implsch_compact.launches - c0
        out["ustar_launches"] += n_c
        u10 = m.state["wswave"][:n]
        swh = m.swh()
        log(f"u* forcing ICODE {icode} (12°, u* 0.5 m/s): stress u* off the "
            f"forcing's by {us:.1e}; after 2 steps U10 {float(u10.min()):.3f}"
            f"..{float(u10.max()):.3f} m/s, SWH max {swh.max():.3f} m; "
            f"kernel C launches {n_c}")
        if not (us < 1e-7 and float(u10.min()) > 6.0
                and float(u10.max()) < 25.0 and np.isfinite(swh).all()
                and swh.max() < 20.0 and (n_c == 2 or not launches)):
            raise AssertionError(f"u* forcing ICODE {icode}")
        check_compact(compact_check(ms.phys, *cases.wavemodel_inputs(m)),
                      f"kernel C UST (ICODE {icode}) vs plain, one physics "
                      "step")
        del m

    # -- 9c. full width: each weight mode in turn, the last one's state
    # for kernel C's checks
    ends, per = {}, {}
    model = ms = None
    for mode in cases.WEIGHT_MODES:
        del model, ms
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        ms, model = o320_wavemodel(dev, mode, **(o320 or {}))
        synchronize(dev)
        t_build = time.perf_counter() - t0
        a0, c0 = pcu.advect.launches, ipk.implsch_compact.launches
        steps = []
        for _ in range(4):
            t_p, t_f = model.timers.propag, model.timers.phys
            model.advance(1)
            steps.append((model.timers.propag - t_p,
                          model.timers.phys - t_f))
        n_a = pcu.advect.launches - a0
        n_c = ipk.implsch_compact.launches - c0
        tm = model.timers
        peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else None
        if mode == "cached":
            # the weights alone, built again (the old set freed first)
            synchronize(dev)
            t0 = time.perf_counter()
            model.steps.refresh_currents(*(
                ms.env[k][: ms.n_pad] for k in ("ucur", "vcur")))
            synchronize(dev)
            t_weights = time.perf_counter() - t0
        nw = (prop.n_slots(ms.irefra) * ms.tb.nang * ms.tb.nfre_red
              * ms.n_pad * 4 / 1e9 if mode == "cached" else 0.0)
        r = dict(build_s=t_build, adv_ms=tm.propag / 4 * 1e3,
                 phys_ms=tm.phys / 2 * 1e3, peak_gb=peak, weights_gb=nw,
                 launches=(n_a, n_c), steps=steps)
        if mode == "cached":
            r["weights_s"] = t_weights
        if mode == "otf" and cuda:
            st = stepper.stencil_device_arrays(ms)
            cg = ms.env["cgroup_ext"][: ms.tb.nfre_red]
            r["otf_block_ms"] = cuda_ms(lambda _: prop.ctuw_weights(
                ms.idelpro, st, ms.tb, cg, mstart=0,
                mend=cases.OTF_BLOCK), 3)
            del st
        per[mode] = r
        norms = model.norms()
        log(f"WaveModel {ms.grid.name} {mode}: "
            f"{ms.n_real} sea points; setup and model {t_build:.2f} s "
            f"(weight planes {nw:.2f} GB"
            + (f", built alone in {r['weights_s']:.3f} s"
               if "weights_s" in r else "")
            + "); 4 steps (2 physics), (t_propag s, t_phys s): "
            + ", ".join(f"({a:.4f}, {b:.4f})" for a, b in steps)
            + f"; mean advection step "
            f"{r['adv_ms']:.3f} ms, mean physics step {r['phys_ms']:.3f} ms "
            + (f", OTF weights of one {cases.OTF_BLOCK}-frequency block "
               f"{r['otf_block_ms']:.3f} ms" if "otf_block_ms" in r else "")
            + f"; (kernel A passes, kernel C launches) {(n_a, n_c)}; peak "
            f"allocation {peak} GB; SWH {norms}")
        want = (4 if mode == "fused" else 0, 2)
        if launches and (n_a, n_c) != want:
            raise AssertionError(f"WaveModel O320 {mode}: launches "
                                 f"{(n_a, n_c)} != {want}")
        if not (np.isfinite([norms["average"], norms["maximum"]]).all()
                and norms["minimum"] > 0):
            raise AssertionError(f"WaveModel O320 {mode}: SWH")
        # at the sea points: the padded points are isolated in the dense
        # modes and copies of point 0 in the fused one (both as in the
        # reference)
        n = ms.n_real
        ends[mode] = (model.fl1[..., :n].cpu(),
                      {k: v[:n].cpu() for k, v in model.stress.items()})
    ref_f, ref_s = ends[cases.WEIGHT_MODES[0]]
    for mode in cases.WEIGHT_MODES[1:]:
        f, st = ends[mode]
        e = {"fl1": rel_max(f, ref_f)[0]}
        e.update((k, rel_max(st[k], ref_s[k])[0]) for k in ipk.STRESS_KEYS)
        log(f"WaveModel {ms.grid.name} end state, {mode} vs "
            f"{cases.WEIGHT_MODES[0]}: "
            + ", ".join(f"{k} {v:.3e}" for k, v in e.items()))
        if not (e.pop("fl1") <= TRAJ_TOL
                and max(e.values()) <= TRAJ_STRESS_TOL):
            raise AssertionError(f"WaveModel O320: {mode} disagrees")
    del ends
    out["o320"] = per
    out["o320_launches"] = sum(r["launches"][1] for r in per.values())

    # kernel C against plain on a slice of the state, on every point, and
    # the UST instantiation on the slice under u* from seed 0
    fl1, env2d, scal = cases.wavemodel_inputs(model)
    n = min(rows, ms.n_pad)
    s0 = (ms.n_pad - n) // 2
    sl = tuple(a[..., s0:s0 + n].contiguous() for a in (fl1, env2d, scal))
    r = compact_check(ms.phys, *sl)
    check_compact(r, f"kernel C on WaveModel's state ({n} points)")
    out["slice"] = r
    if cuda:
        tabs = ipk.pack_tables(ms.phys, dev)
        r["all_ms"] = cuda_ms(lambda _: ipk.implsch_compact(
            ms.phys, fl1, env2d, scal, full=True, tables_dev=tabs), 3)
        r["all_bound"] = bound(r["bytes"] * ms.n_pad / n,
                               r["ops"] * ms.n_pad / n)
        log(f"kernel C on all {ms.n_pad} points, full mode: "
            f"{r['all_ms']:.3f} ms; bound {r['all_bound'][0]:.3f} ms "
            f"({r['all_bound'][1]})")
    # u* from seed 0 swapped in as NEWWIND does
    cfg_u = dataclasses.replace(ms.phys, icode_wnd=1)
    scal_u = newwind_stress(ms, sl[2],
                            0.2 + 0.5 * np.random.default_rng(0).random(n),
                            model.USTMIN_RESET_TAUW)
    r = compact_check(cfg_u, sl[0], sl[1], scal_u)
    check_compact(r, f"kernel C UST on WaveModel's state ({n} points, u* "
                  "0.2–0.7 m/s from seed 0)")
    out["slice_ustar"] = r
    del model, fl1, env2d, scal, sl, scal_u
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    # -- 9d. the CLI with cached weights and the swell trains
    work = os.path.join(ROOT, "build", "chip_smoke_wavemodel")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        frc = checks.write_forcing(os.path.join(work, "forcing.npz"), 3)
        kw = dict(dict(grid="12.0", directions=12, frequencies=15, adv=900,
                       phys=900, hours=3, forcing=frc,
                       fields=checks.FIELDS + checks.TRAINS,
                       weights_mode="cached"), **(cli or {}))
        text = checks.run_yaml(**kw)
        runs = {}
        for name, plain in (("kernels", False), ("plain", True)):
            model, entries, _, n_l, _ = cli_run(
                text, os.path.join(work, name), dev, plain=plain)
            if launches:
                _check_launches(f"CLI 12° cached {name}", n_l, model, text,
                                plain)
            runs[name] = entries
            del model
        trains = set(checks.TRAINS)

        def part(entries, train):
            return [e for e in entries if (e["name"] in trains) == train]
        err, where = checks.stats_error(part(runs["kernels"], False),
                                        part(runs["plain"], False))
        t_err, t_where = checks.stats_error(part(runs["kernels"], True),
                                            part(runs["plain"], True))
        log(f"CLI 12° weights_mode cached ({len(kw['fields'])} fields, the "
            f"swell trains among them): statistics.log kernels vs plain on "
            f"the card {err:.3e} at {where} (limit {CLI_STATS_TOL}); swell "
            f"trains {t_err:.3e} at {t_where} (limit {TRAIN_STATS_TOL}); "
            f"{len(runs['kernels'])} entries")
        if not (err <= CLI_STATS_TOL and t_err <= TRAIN_STATS_TOL):
            raise AssertionError("CLI cached: kernels disagree with plain")
        out.update(cli_stats=err, cli_trains=t_err)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


# -- phase 10: nesting, coupling, assimilation, phys_srl_chunked ----------

NEST_RECT = (20.0, 70.0, 280.0, 350.0)
RIM_TOL = 1e-6
OI_CHECK_TOL = 1e-10
WAMASSI_SWH_RTOL = 2e-2
# Wave2Atmosphere/Wave2Ocean fields that are vector components, by the
# vector they belong to (held over the vector's largest magnitude)
BLOCK_VECTORS = (("ustokes", "vstokes"), ("tauocx", "tauocy"),
                 ("nustokes", "nvstokes"))


def timed(fn, dev, reps: int = 5) -> dict:
    """Host ms a call of ``fn`` (synchronised after each call), and on the
    card the device's busy ms a call and the idle share of the window
    from ``torch.profiler`` over ``reps`` more calls."""
    from ecwam_tpu_torch.device import synchronize
    fn()
    synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        synchronize(dev)
    out = dict(host_ms=(time.perf_counter() - t0) / reps * 1e3)
    if dev.type == "cuda":
        def window():
            for _ in range(reps):
                fn()
        wall, _, busy, _ = profile(window, names={})
        out.update(device_ms=busy / reps, idle=1.0 - busy / wall)
    return out


def fmt_t(t: dict) -> str:
    return (f"host {t['host_ms']:.3f} ms" + (
        f", device busy {t['device_ms']:.3f} ms, idle {100 * t['idle']:.1f}"
        " %" if "device_ms" in t else ""))


def block_errors(got, want) -> dict:
    """Each array of a coupling block: max|got − want| over the largest
    magnitude of ``want``'s field (of its vector for the components)."""
    import dataclasses
    import numpy as np
    scale = {}
    for pair in BLOCK_VECTORS:
        if hasattr(want, pair[0]):
            m = max(np.abs(getattr(want, k)).max() for k in pair)
            scale.update((k, m) for k in pair)
    out = {}
    for f in dataclasses.fields(want):
        w, g = getattr(want, f.name), getattr(got, f.name)
        if w is None:
            if g is not None:
                raise AssertionError(f"coupling block {f.name}")
            continue
        out[f.name] = float(np.abs(g - w).max()) / max(
            scale.get(f.name, float(np.abs(w).max())), 1e-30)
    return out


def block_sanity(a2w, w2o, tb, open_pts, wind_dir) -> dict:
    """tests/test_coupling.py's sanity ranges at the open-water points
    ``open_pts`` (ntauoc's lower bound only), and the shares of them whose
    momentum flux lies within 0.3 rad of the wind and whose Stokes drift
    is downwind."""
    import numpy as np
    o = open_pts
    st = np.hypot(a2w.ustokes[o], a2w.vstokes[o])
    dtau = np.angle(np.exp(1j * (np.arctan2(a2w.tauocx[o], a2w.tauocy[o])
                                 - wind_dir[o])))
    dsto = np.angle(np.exp(1j * (np.arctan2(a2w.ustokes[o], a2w.vstokes[o])
                                 - wind_dir[o])))
    ranges = {k: (float(v[o].min()), float(v[o].max())) for k, v in (
        ("charnock", a2w.charnock), ("stokes", np.hypot(a2w.ustokes,
                                                        a2w.vstokes)),
        ("phiocd", a2w.phiocd), ("wsemean", a2w.wsemean),
        ("wsfmean", a2w.wsfmean), ("nswh", w2o.nswh), ("nmwp", w2o.nmwp),
        ("ntauoc", w2o.ntauoc), ("nphieps", w2o.nphieps))}
    log("coupling blocks at the open-water points (min, max): " + ", ".join(
        f"{k} ({a:.4g}, {b:.4g})" for k, (a, b) in ranges.items()))
    return dict(
        charnock=bool(np.all((a2w.charnock[o] > 0.003)
                             & (a2w.charnock[o] < 0.3))),
        stokes=bool(np.all((st > 0.005) & (st < 1.0))),
        phiocd=bool(np.all(a2w.phiocd[o] < 0.0)),
        wsemean=bool(np.all(a2w.wsemean[o] > 0.0)),
        wsfmean=bool(np.all((a2w.wsfmean[o] > tb.fr[0])
                            & (a2w.wsfmean[o] <= tb.fr[-1]))),
        nswh=bool(np.all((w2o.nswh[o] > 0.3) & (w2o.nswh[o] < 15.0))),
        nmwp=bool(np.all(w2o.nmwp[o] > 1.0)),
        # the reference's ntauoc <= 1 holds under its uniform wind; under
        # winds in random directions a point also takes momentum from
        # waves that grew under its neighbours' winds (≈ 1.03 at O24)
        ntauoc=bool(np.all(w2o.ntauoc[o] > 0.5)),
        nphieps=bool(np.all(w2o.nphieps[o] <= 0.0)),
        tau_share=float(np.mean(np.abs(dtau) < 0.3)),
        stokes_share=float(np.mean(np.abs(dsto) < 0.5 * np.pi)))


def coupled_cases(mod, ms, *, plain: bool):
    """tests/test_coupling.py's two cases through ``CoupledWaveModel``:
    the blocks of each."""
    import numpy as np
    n = ms.n_real
    out = {}
    cm = mod.CoupledWaveModel(ms, "20230101000000", plain=plain)
    cm.push_atmosphere("20230101000000", wswave=np.full(n, 14.0),
                       wdwave=np.full(n, 0.5))
    cm.advance_coupling_period(4)
    out["roundtrip"] = (cm.wave_to_atmosphere(), cm.wave_to_ocean())
    cm = mod.CoupledWaveModel(ms, "20230101000000", plain=plain)
    cm.push_atmosphere("20230101000000", wswave=np.full(n, 12.0),
                       wdwave=np.zeros(n))
    cm.advance_coupling_period(2)
    ice = np.zeros(n)
    ice[: n // 2] = 0.95
    cm.push_ocean(mod.Ocean2Wave(cicover=ice, cithick=np.full(n, 1.0),
                                 ucur=np.full(n, 0.4), vcur=np.zeros(n)))
    if cm.model.currents is None:
        raise AssertionError("coupling: the currents did not reach the "
                             "propagation")
    cm.advance_coupling_period(2)
    out["ocean"] = (cm.wave_to_atmosphere(), cm.wave_to_ocean())
    return out


def boundary_phase(dev, *, coarse=None, fine=None, o320=None, nobs=2000,
                   check_points=4096, chunk=65536,
                   launches=True) -> dict:
    """Phase 10: boundary nesting through the CLI, coupling, assimilation
    and ``phys_srl_chunked`` (see the module docstring); returns the
    readings.  ``coarse``/``fine`` override the nested runs' keywords and
    ``o320`` the full width's ``build_model`` keywords (a rehearsal on the
    CPU passes small grids and ``launches=False``)."""
    import shutil
    import numpy as np
    import torch
    from ecwam_tpu_torch import coupling
    from ecwam_tpu_torch.cli import checks
    from ecwam_tpu_torch.cli import main as cli
    from ecwam_tpu_torch.device import synchronize
    from ecwam_tpu_torch.model import assimilation as da
    from ecwam_tpu_torch.model import cases, driver, nesting
    from ecwam_tpu_torch.model import setup as setup_mod
    from ecwam_tpu_torch.ops import propagation_cuda as pcu
    from ecwam_tpu_torch.ops.physics import implsch_cuda as ipk
    cuda = dev.type == "cuda"
    out = {}
    work = os.path.join(ROOT, "build", "chip_smoke_nest")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        # -- 10a. nesting through the CLI: coarse → bouint → fine
        frc = checks.write_forcing(os.path.join(work, "forcing.npz"), 2)
        base = dict(directions=36, frequencies=29, physics_frequencies=36,
                    adv=450, phys=900, hours=2, forcing=frc,
                    fields=("swh",), lsecondorder=False)
        ckw = dict(dict(base, grid="O160"), **(coarse or {}))
        rect = ", ".join(f"{x:.1f}" for x in NEST_RECT)
        ctext = (checks.run_yaml(**ckw)
                 + f"nesting:\n    coarse:\n        rect: [{rect}]\n")
        rd_c = os.path.join(work, "coarse")
        model, _, tm, n_l, wall = cli_run(ctext, rd_c, dev)
        if launches:
            _check_launches(f"CLI {ckw['grid']} coarse nest", n_l, model,
                            ctext, False)
        cb = nesting.coarse_boundary(model.setup.grid, model.setup.blk,
                                     *NEST_RECT)
        wr = nesting.BoundaryWriter(cb, model.setup.tb)
        t_wr = timed(lambda: wr.add(driver.format_date(model.date),
                                    model.take_points(cb.idx)), dev)
        log(f"nesting, coarse run {ckw['grid']} ({model.setup.n_real} sea "
            f"points, {ckw['hours']} h, swh hourly): {cb.idx.size} boundary "
            f"points; wall {wall:.3f} s; the boundary records "
            f"{tm.boundary / max(tm.dates, 1) * 1e3:.3f} ms an output date "
            f"in the run ({tm.dates} dates, only the boundary points "
            f"gathered), {fmt_t(t_wr)} a record once warm")
        del model, wr
        bc = os.path.join(rd_c, "wam_boundary.npz")
        rd_f = os.path.join(work, "fine")
        os.makedirs(rd_f)
        b30 = os.path.join(rd_f, "boundary_30min.npz")
        t0 = time.perf_counter()
        cli.main(["bouint", "--input", bc, "--output", b30, "--timestep",
                  "1800", "--device", dev.type])
        t_bouint = time.perf_counter() - t0
        z = np.load(b30)
        if not (z["dates"].size == 2 * np.load(bc)["dates"].size - 1
                and np.isfinite(z["spec"]).all()):
            raise AssertionError("bouint's records")
        fkw = dict(dict(base, grid="O320"), **(fine or {}))
        ftext = (checks.run_yaml(**fkw) + "nesting:\n    fine:\n"
                 "        file: boundary_30min.npz\n")
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        model, entries, tm, n_l, wall = cli_run(ftext, rd_f, dev)
        ms = model.setup
        if launches:
            _check_launches(f"CLI {fkw['grid']} fine nest", n_l, model,
                            ftext, False)
        st = model.timers
        bf = nesting.BoundaryFile(b30, ms.tb, device=dev)
        fb = nesting.fine_boundary(ms.grid, ms.blk, bf.coarse_boundary())
        log(f"nesting, bouint to 30 min: {z['dates'].size} records in "
            f"{t_bouint:.3f} s; fine run {fkw['grid']} ({ms.n_real} sea "
            f"points, {fb.idx.size} rim points, {fkw['hours']} h): wall "
            f"{wall:.3f} s for {st.steps} steps, mean step "
            f"{(st.propag + st.phys) / st.steps * 1e3:.3f} ms (propag "
            f"{st.propag:.3f} s, phys {st.phys:.3f} s), rim writes "
            f"{tm.rim / max(tm.rims, 1) * 1e3:.3f} ms each ({tm.rims}, "
            f"synchronised host clock); launches {n_l}; peak allocation "
            f"{torch.cuda.max_memory_allocated() / 1e9 if cuda else None} "
            "GB")
        if not (tm.rims == st.steps and len(entries) == tm.dates):
            raise AssertionError("the fine run's rim writes")
        out["nest"] = dict(rim_points=fb.idx.size, coarse_points=cb.idx.size,
                           launches=n_l, rim_ms=tm.rim / tm.rims * 1e3,
                           step_ms=(st.propag + st.phys) / st.steps * 1e3)

        # one more step: the rim in place against the compact round trip
        model.advance(1)
        d14 = driver.format_date(model.date)
        want = nesting.apply_boundary(model.fl1, bf, fb, d14)

        def rim_write():
            model.put_points(fb.idx, nesting.boundary_spectra(bf, fb, d14))
        rim_write()
        got = model.fl1
        err, _ = rel_max(got, want)
        rim = model.take_points(fb.idx)
        del got, want
        log(f"nesting rim at {d14}: in place vs the compact apply_boundary "
            f"through the round trip {err:.3e} of max (tol {RIM_TOL}); rim "
            f"max {float(rim.max()):.3e}, finite "
            f"{bool(torch.isfinite(rim).all())}")
        if not (err <= RIM_TOL and bool(torch.isfinite(rim).all())
                and float(rim.max()) > 0.0):
            raise AssertionError("nesting: the rim written in place differs "
                                 "from the compact apply_boundary")

        def round_trip():
            model.fl1 = nesting.apply_boundary(model.fl1, bf, fb, d14)
        t = dict(rim=timed(rim_write, dev),
                 intspec=timed(lambda: nesting.boundary_spectra(bf, fb, d14),
                               dev),
                 round_trip=timed(round_trip, dev))
        if cuda:
            t["intspec_events_ms"] = cuda_ms(
                lambda _: nesting.boundary_spectra(bf, fb, d14), 5)
            t["rim_events_ms"] = cuda_ms(lambda _: rim_write(), 5)

            def steps(nest):
                for _ in range(4):
                    model.advance(1)
                    if nest:
                        model.put_points(fb.idx, nesting.boundary_spectra(
                            bf, fb, driver.format_date(model.date)))
            for nest in (False, True):
                wall, split, busy, _ = profile(lambda: steps(nest))
                t["steps_nest" if nest else "steps_plain"] = dict(
                    wall_ms=wall / 4, busy_ms=busy / 4,
                    idle_ms=(wall - busy) / 4)
        log("nesting times at O320 (a call): rim write in place "
            f"{fmt_t(t['rim'])}; INTSPEC alone {fmt_t(t['intspec'])}; the "
            f"compact round trip {fmt_t(t['round_trip'])}"
            + (f"; CUDA events: INTSPEC {t['intspec_events_ms']:.3f} ms, rim "
               f"write {t['rim_events_ms']:.3f} ms; a step without and with "
               "the rim (wall, busy, idle ms): "
               + ", ".join(f"{k} ({v['wall_ms']:.3f}, {v['busy_ms']:.3f}, "
                           f"{v['idle_ms']:.3f})" for k, v in t.items()
                           if k.startswith("steps")) if cuda else ""))
        out["nest"]["times"] = t
        del model, bf
        if cuda:
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # -- 10b. coupling: 18° through the kernels and plain, then O320
    kw = dict(grid_name="18.0", nang=12, nfre=25, idelpro=900.0,
              idelt=900.0, pad_to=64, irefra=2)
    ms = setup_mod.build_model(device=dev, **kw)
    a0, c0 = pcu.advect.launches, ipk.implsch_compact.launches
    runs = {p: coupled_cases(coupling, ms, plain=p) for p in (False, True)}
    n_c = (pcu.advect.launches - a0, ipk.implsch_compact.launches - c0)
    for case in ("roundtrip", "ocean"):
        e = {}
        for got, want in zip(runs[False][case], runs[True][case]):
            e.update(block_errors(got, want))
        tol = {k: TRAJ_TOL if k in ("nswh", "nmwp") else TRAJ_STRESS_TOL
               for k in e}
        worst = max(e, key=lambda k: e[k] / tol[k])
        log(f"coupling 18° {case} (12x25, irefra 2, fused), kernels vs "
            f"plain: worst {worst} {e[worst]:.3e} (tol {tol[worst]}); "
            + ", ".join(f"{k} {v:.1e}" for k, v in e.items()))
        if e[worst] > tol[worst]:
            raise AssertionError(f"coupling 18° {case}: kernels disagree")
    log(f"coupling 18°: (kernel A, kernel C) launches {n_c} in the four "
        "runs (none in the plain ones)")
    if launches and not (n_c[0] > 0 and n_c[1] > 0):
        raise AssertionError("coupling 18° bypassed a kernel")
    del runs, ms

    okw = dict(dict(O320_KW, irefra=2), **(o320 or {}))
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ms = setup_mod.build_model(device=dev, **okw)
    n = ms.n_real
    wind = o320_wind(n)
    lat, lon = cases.point_latlon(ms.grid, ms.blk)
    phi, lam = np.radians(lat), np.radians(lon)
    ucur = 0.9 * np.exp(-(lat / 8.0) ** 2) \
        - 0.3 * np.cos(3 * lam) * np.sin(2 * phi)
    vcur = 0.3 * np.sin(3 * lam) * np.cos(phi)
    ice = np.clip((np.abs(lat) - 60.0) / 15.0, 0.0, 1.0)
    cm = coupling.CoupledWaveModel(ms, cases.START)
    a0, c0 = pcu.advect.launches, ipk.implsch_compact.launches
    ct = {}

    def clock(name, fn):
        synchronize(dev)
        t1 = time.perf_counter()
        r = fn()
        synchronize(dev)
        ct[name] = ct.get(name, 0.0) + time.perf_counter() - t1
        return r
    clock("push_atmosphere", lambda: cm.push_atmosphere(
        cases.START, wswave=wind["wswave"], wdwave=wind["wdwave"]))
    t_build = time.perf_counter() - t0
    clock("advance_8", lambda: cm.advance_coupling_period(8))
    clock("push_ocean", lambda: cm.push_ocean(coupling.Ocean2Wave(
        cicover=ice, cithick=2.0 * ice, ucur=ucur, vcur=vcur)))
    clock("advance_8b", lambda: cm.advance_coupling_period(8))
    a2w = clock("wave_to_atmosphere", cm.wave_to_atmosphere)
    w2o = clock("wave_to_ocean", cm.wave_to_ocean)
    n_o = (pcu.advect.launches - a0, ipk.implsch_compact.launches - c0)
    iced = ice > coupling.CITHRSH
    sane = block_sanity(a2w, w2o, ms.tb, ice == 0.0, wind["wdwave"])
    defval = bool(np.all(a2w.charnock[iced] == coupling.PRCHAR)
                  and np.all(a2w.ustokes[iced] == 0.0)
                  and np.all(a2w.wsfmean[iced] == float(ms.tb.fr[-1])))
    peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else None
    log(f"coupling {ms.grid.name} ({n} sea points, {ms.tb.nang}x"
        f"{ms.tb.nfre}/{ms.tb.nfre_red}, fused, irefra 2): setup, model "
        f"and first push {t_build:.2f} s; host clock, synchronised: "
        + ", ".join(f"{k} {v * 1e3:.3f} ms" for k, v in ct.items())
        + f"; (kernel A, kernel C) launches {n_o}; {int(iced.sum())} iced "
        f"points carry the DEFVALs {defval}; at the {int((ice == 0).sum())} "
        f"ice-free points {sane}; peak allocation {peak} GB")
    if launches and not (n_o[0] > 0 and n_o[1] == 8):
        raise AssertionError(f"coupling O320 launches {n_o}")
    if not (defval and all(v for k, v in sane.items()
                           if not k.endswith("share"))
            and sane["tau_share"] >= 0.95 and sane["stokes_share"] >= 0.95):
        raise AssertionError("coupling O320: blocks out of range")
    out["coupling"] = dict(times=ct, launches=n_o, sanity=sane)
    del cm, ms, a2w, w2o
    if cuda:
        torch.cuda.empty_cache()

    # -- 10c. assimilation on FastWaveModel at O320 after 4 steps
    ms = setup_mod.build_model(device=dev, **dict(O320_KW, **(o320 or {})))
    n = ms.n_real
    model = driver.FastWaveModel(ms, lambda date14: o320_wind(n),
                                 cases.START)
    model.advance(4)
    rng = np.random.default_rng(0)
    pick = rng.choice(n, nobs, replace=False)
    lat, lon = cases.point_latlon(ms.grid, ms.blk)
    hs_fg = da.first_guess_swh(model)[:n]
    obs = dict(lat=lat[pick], lon=lon[pick],
               swh=hs_fg[torch.as_tensor(pick, device=dev)].double().cpu()
               .numpy() * rng.uniform(0.8, 1.2, nobs))
    sel = np.sort(rng.choice(n, min(check_points, n), replace=False))
    if cuda:
        torch.cuda.synchronize()
        base_mem = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    at = {}
    synchronize(dev)
    t0 = time.perf_counter()
    hs_an = da.wamassi(model, obs)
    synchronize(dev)
    at["wamassi_ms"] = (time.perf_counter() - t0) * 1e3
    peak = ((torch.cuda.max_memory_allocated() - base_mem) / 1e9
            if cuda else None)
    hs1 = da.first_guess_swh(model)[:n].double()
    swh_err = float(((hs1 - hs_an).abs() / hs_an.abs().clamp(min=1e-12))
                    .max())
    at["analysis"] = timed(lambda: da.oi_swh_analysis(
        hs_fg, lat, lon, obs["lat"], obs["lon"], obs["swh"]), dev, reps=2)
    at["update"] = timed(lambda: da.scale_spectra(
        model, torch.ones(ms.n_pad, dtype=torch.float64, device=dev)), dev)
    at["first_guess"] = timed(lambda: da.first_guess_swh(model), dev)
    w, _ = da.oi_weights(hs_fg, lat, lon, obs["lat"], obs["lon"],
                         obs["swh"])
    cpu_an = da.oi_gain(hs_fg[torch.as_tensor(sel, device=dev)].cpu(),
                        lat[sel], lon[sel], obs["lat"], obs["lon"], w.cpu(),
                        device="cpu")
    an_sel = hs_an[torch.as_tensor(sel, device=dev)].cpu()
    oi_err = float(((cpu_an - an_sel).abs() / an_sel.abs()).max())
    log(f"assimilation {ms.grid.name} after 4 steps, {nobs} observations "
        f"from seed 0 (first guess x U(0.8, 1.2)): wamassi "
        f"{at['wamassi_ms']:.3f} ms; the analysis {fmt_t(at['analysis'])}; "
        f"the in-place update {fmt_t(at['update'])}; the first guess "
        f"{fmt_t(at['first_guess'])}; peak allocation above the state "
        f"{peak} GB; card vs CPU float64 at {sel.size} points with the "
        f"card's w: {oi_err:.3e} relative (tol {OI_CHECK_TOL}); SWH after "
        f"the update vs the analysis {swh_err:.3e} (tol "
        f"{WAMASSI_SWH_RTOL}); analysis range "
        f"{float(hs_an.min()):.3f}..{float(hs_an.max()):.3f} m")
    if not (oi_err <= OI_CHECK_TOL and swh_err <= WAMASSI_SWH_RTOL
            and bool(torch.isfinite(model._f_srl).all())):
        raise AssertionError("assimilation disagrees")
    out["assimilation"] = dict(at, peak_gb=peak, oi_err=oi_err,
                               swh_err=swh_err)
    del w, hs_an, hs1, hs_fg

    # -- 10d. phys_srl_chunked against phys_srl on all rows
    fp = model.fp

    def clone(*ts):
        return tuple(None if t is None else t.clone() for t in ts)
    args = (model._f_srl, model._stress6, model._frc6, model._denv,
            model._env2d, model._tail)
    f_all, s_all, t_all = fp.phys_srl(*clone(*args))
    f_c, t_c = clone(model._f_srl, model._tail)
    m1 = ipk.implsch_srl.launches
    acc = fp.phys_srl_chunked(f_c, model.frc, model.stress, ms.env,
                              chunk=chunk, tail=t_c)[-1]
    n_ch = ipk.implsch_srl.launches - m1
    rows = fp.from_srl_pad[:n]
    pairs = [(f_c[rows], f_all[rows])] + [
        (acc[k][:n], s_all[i][rows]) for i, k in enumerate(ipk.STRESS_KEYS)]
    if t_c is not None:
        pairs.append((t_c[rows], t_all[rows]))
    same = all(torch.equal(a, b) for a, b in pairs)
    e = max(rel_max(a, b)[0] for a, b in pairs)
    del f_all, s_all, t_all, f_c, t_c, acc, pairs
    pt = {}
    if cuda:
        pt["all_ms"] = cuda_ms(lambda a: fp.phys_srl(*a), 3,
                               setup=lambda: clone(*args))
        pt["chunked_ms"] = cuda_ms(
            lambda a: fp.phys_srl_chunked(a[0], model.frc, model.stress,
                                          ms.env, chunk=chunk, tail=a[1]),
            3, setup=lambda: clone(model._f_srl, model._tail))
    log(f"phys_srl_chunked ({chunk}-point chunks, {n_ch} kernel B "
        f"launches) vs phys_srl on all {model._f_srl.shape[0]} rows (one "
        f"launch): canonical rows, tail and the six stress fields bit for "
        f"bit equal {same} (largest difference {e:.3e} of max); "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in pt.items()))
    if not (same or e <= RIM_TOL):
        raise AssertionError("phys_srl_chunked disagrees with phys_srl")
    if launches and n_ch != -(-n // chunk):
        raise AssertionError(f"phys_srl_chunked launched kernel B {n_ch} "
                             "times")
    out["chunked"] = dict(pt, same=same, err=e, launches=n_ch)
    del model, args, fp
    if cuda:
        torch.cuda.empty_cache()
    return out


# -- phase 11: the shapes kernel B/C takes beyond the default build ------

FLUX_SWITCHES = ("lcflx", "lstokes", "lwvflx_snl")


def fmt_ms(x) -> str:
    return "not timed" if x is None else f"{x:.3f} ms"


def drag_ustar(u10):
    """u* = U10·√min(ACD + BCD·U10, CDMAX), the drag law TAUT_Z0 starts
    from (taut_z0.F90), for a u*-forced model from U10 winds."""
    import numpy as np
    from ecwam_tpu_torch.core import constants as c
    return u10 * np.sqrt(np.minimum(c.ACD + c.BCD * u10, c.CDMAX))


def newwind_stress(ms, scal, us, usmin):
    """``scal`` (SCAL_IN rows) with the friction velocity ``us`` swapped
    in as NEWWIND does under u* (driver.WaveModel.newwind): TAUW =
    u*²·(1 − (α/CHARNOCK)²), zeroed below ``usmin``."""
    import torch
    from ecwam_tpu_torch.ops.physics import implsch_cuda as ipk
    out = scal.clone()
    row = {k: ipk.SCAL_IN.index(k) for k in ("ufric", "tauw", "chrnck")}
    us = torch.as_tensor(us, dtype=out.dtype, device=out.device)
    tauw = us**2 * (1.0 - (ms.phys.params.alpha / out[row["chrnck"]])**2)
    out[row["ufric"]] = us
    out[row["tauw"]] = torch.where(us < usmin, torch.zeros_like(tauw), tauw)
    return out


def shapes_phase(dev, *, over=None, nang=72, rows=PHYS_ROWS,
                 launches=True) -> dict:
    """Phase 11: kernel B/C beyond the default build's shapes, at full
    width (:data:`O320_KW` with ``over``'s keywords: a rehearsal on the
    CPU passes a small grid and ``launches=False``); returns the readings
    of the kernels line."""
    import numpy as np
    import torch
    from ecwam_tpu_torch.device import synchronize
    from ecwam_tpu_torch.model import cases, driver
    from ecwam_tpu_torch.model import setup as setup_mod
    from ecwam_tpu_torch.ops import propagation_cuda as pcu
    from ecwam_tpu_torch.ops.physics import implsch_cuda as ipk
    cuda = dev.type == "cuda"
    kw0 = dict(O320_KW, **(over or {}))
    out = {}

    def fresh():
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()

    def peak():
        return torch.cuda.max_memory_allocated() / 1e9 if cuda else None

    # -- 11a. full mode with each flux/Stokes switch off: the default
    # build's EXT instantiation through output dates, then the slice
    fresh()
    ms = setup_mod.build_model(device=dev, **kw0)
    wind = o320_wind(ms.n_real)
    out["switches"] = {}
    for sw in FLUX_SWITCHES:
        ms_s = cases.with_phys(ms, **{sw: False})
        model = driver.FastWaveModel(ms_s, lambda d: wind, cases.START)
        model.advance(1)
        f0 = ipk.implsch_srl.full_launches
        model.advance(1, full_phys=True)
        n_f = ipk.implsch_srl.full_launches - f0
        n = ms.n_real
        above_cut = ms.tb.nfre - 1 - float(
            model.state["mij"][:n].double().mean())
        r = slice_check(ms_s, model, dev, True, above_cut)
        r["launches"] = n_f
        zero = [k for k in ipk.SCAL_OUT_FULL
                if k in model.state and not bool(model.state[k].any())]
        log(f"implsch full, {sw} off ({ms.grid.name}, {rows} rows): "
            f"{n_f} full-mode launches in the output date; kernel "
            f"{fmt_ms(r['ms'])}, plain {fmt_ms(r['plain_ms'])}; spectrum "
            f"{r['spec_rel']:.3e} of max, stress {r['stress_rel']:.3e}, "
            f"worst row {max(r['rows'].values()):.3e}; rows zero in the "
            f"state: {zero}; {r['n_tie']} ties, {r['n_off']} rows off; "
            f"compact same as SRL {r['compact']['same_as_srl']}")
        check_slice(r, True, f"implsch full, {sw} off")
        if launches and n_f <= 0:
            raise AssertionError(f"{sw} off: the output date bypassed "
                                 "kernel B")
        out["switches"][sw] = r
        del model
    del ms

    # -- 11b. the fast path at ``nang`` directions: kernels A and B (the
    # wide build), 4 steps and an output date
    fresh()
    t0 = time.perf_counter()
    ms = setup_mod.build_model(device=dev, **dict(kw0, nang=nang))
    wind = o320_wind(ms.n_real)
    model = driver.FastWaveModel(ms, lambda d: wind, cases.START)
    synchronize(dev)
    t_build = time.perf_counter() - t0
    ft = ms.fused
    tile = None
    if cuda:
        tabs = model.fp.tabs
        tile = pcu.tile_rows(
            pcu._lib(), tabs["cg_srl"].shape[1], model.fp.nfre_red,
            tabs["ktaps"].shape[2], ft.S, False, False,
            torch.cuda.get_device_properties(dev)
            .shared_memory_per_block_optin)
    pcu.advect.launches = 0
    ipk.implsch_srl.launches = ipk.implsch_srl.full_launches = 0
    steps = []
    for _ in range(4):
        t_p, t_f = model.timers.propag, model.timers.phys
        model.advance(1)
        steps.append((model.timers.propag - t_p, model.timers.phys - t_f))
    step_s = sum(a + b for a, b in steps) / 4
    model.advance(1)
    t_f = model.timers.phys
    model.advance(1, full_phys=True)
    t_full = model.timers.phys - t_f
    n_l = dict(advect=pcu.advect.launches, implsch=ipk.implsch_srl.launches,
               implsch_full=ipk.implsch_srl.full_launches)
    pk = peak()
    n = ms.n_real
    norms = model.norms()
    bins = n * ms.tb.nang * ms.tb.nfre
    log(f"{ms.grid.name} {ms.tb.nang}×{ms.tb.nfre}/"
        f"{ms.tb.nfre_red} fast path "
        f"(build {t_build:.1f} s, {n} sea points, {ft.nsrl} SRL rows; "
        f"kernel A's tile {tile} rows, EW {ft.EW}): steps (t_propag s, "
        f"t_phys s) " + ", ".join(f"({a:.4f}, {b:.4f})" for a, b in steps)
        + f"; mean step {step_s * 1e3:.3f} ms = "
        f"{bins / step_s / 1e9:.3f} Gbins/s; output date t_phys "
        f"{t_full:.4f} s; launches {n_l}; peak allocation {pk} GB; SWH "
        f"{norms}")
    if launches and min(n_l.values()) <= 0:
        raise AssertionError(f"{nang} directions bypassed a kernel: {n_l}")
    if not (np.isfinite([norms["average"], norms["maximum"]]).all()
            and norms["minimum"] > 0):
        raise AssertionError(f"{nang} directions: SWH not finite")
    above_cut = ms.tb.nfre - 1 - float(model.state["mij"][:n].double().mean())
    a = advect_check(model, ft, ms.irefra)
    a_bound = bound(a[4], 0)
    log(f"advect at {nang} directions: kernel {fmt_ms(a[2])}, plain "
        f"{fmt_ms(a[3])}, max|k-p| {a[1]:.3e} = {a[0]:.3e} of max (tol "
        f"{ADVECT_TOL}); bound {a_bound[0]:.3f} ms ({a_bound[1]}: "
        f"{a[4] / 1e9:.3f} GB a pass)")
    if not a[0] <= ADVECT_TOL:
        raise AssertionError(f"advection at {nang} directions disagrees")
    sl = {}
    for full in (False, True):
        mode = "full" if full else "minimal"
        r = sl[mode] = slice_check(ms, model, dev, full, above_cut)
        log(f"implsch {mode} at {nang} directions ({rows} rows, "
            f"{ipk.library(ms.phys, full)}): kernel {fmt_ms(r['ms'])}, "
            f"plain {fmt_ms(r['plain_ms'])}; spectrum {r['spec_rel']:.3e} "
            f"of max, stress {r['stress_rel']:.3e}"
            + (f", worst row {max(r['rows'].values()):.3e}, xllws "
               f"{r['xllws']} of {r['xllws_bins']} on the edge, "
               f"{r['xllws_off']} off" if full else "")
            + f"; {r['n_tie']} ties, {r['n_off']} rows off"
            + (f"; kernel on all rows {fmt_ms(r['all_rows_ms'])}"
               if not full else "")
            + f"; bound on all rows {r['all_rows_bound'][0]:.3f} ms "
            f"({r['all_rows_bound'][1]}); compact: kernel "
            f"{fmt_ms(r['compact']['ms'])}, spectrum "
            f"{r['compact']['spec_rel']:.3e}, same as SRL "
            f"{r['compact']['same_as_srl']}")
        check_slice(r, full, f"implsch {mode} at {nang} directions")
    out.update(wide=dict(launches=n_l, advect=a, step_ms=step_s * 1e3,
                         peak_gb=pk, tile=tile, **sl))
    del model, ms, ft

    # -- 11c. the dense WaveModel under u* with the cycle-50r1 options:
    # kernel C's UST×OPTS instantiation
    fresh()
    ms = setup_mod.build_model(device=dev, weights_mode="fused",
                               icode_wnd=1, **dict(kw0, **cases.CY50R1))
    n = ms.n_real
    wind = o320_wind(n)
    wind["ufric"] = drag_ustar(wind["wswave"])
    model = driver.WaveModel(ms, lambda d: wind, cases.START)
    model = model.newwind(model.date)
    a0, c0 = pcu.advect.launches, ipk.implsch_compact.launches
    for _ in range(4):
        model.advance(1)
    n_a = pcu.advect.launches - a0
    n_c = ipk.implsch_compact.launches - c0
    tm = model.timers
    pk = peak()
    u10 = model.state["wswave"][:n]
    log(f"WaveModel {ms.grid.name} fused, u* (drag law of the 8–12 m/s "
        f"winds) with cy50r1: 4 steps, mean advection step "
        f"{tm.propag / 4 * 1e3:.3f} ms, mean physics step "
        f"{tm.phys / 2 * 1e3:.3f} ms; (kernel A passes, kernel C launches)"
        f" {(n_a, n_c)}; U10 {float(u10.min()):.3f}..{float(u10.max()):.3f}"
        f" m/s; peak allocation {pk} GB; SWH {model.norms()}")
    if launches and (n_a, n_c) != (4, 2):
        raise AssertionError(f"u* cy50r1 WaveModel launches {(n_a, n_c)}")
    fl1, env2d, scal = cases.wavemodel_inputs(model)
    m_ = min(rows, ms.n_pad)
    s0 = (ms.n_pad - m_) // 2
    sl_ = tuple(x[..., s0:s0 + m_].contiguous() for x in (fl1, env2d, scal))
    del fl1, env2d, scal
    r = compact_check(ms.phys, *sl_)
    r["launches"] = n_c
    check_compact(r, f"kernel C UST×OPTS on the WaveModel's state ({m_} "
                  "points)")
    # the same points under storm winds and their drag-law u*
    u = storm_winds(m_)
    scal_s = newwind_stress(ms, sl_[2], drag_ustar(u),
                            model.USTMIN_RESET_TAUW)
    scal_s[ipk.SCAL_IN.index("wswave")] = torch.as_tensor(
        u, dtype=scal_s.dtype, device=dev)
    rs = compact_check(ms.phys, sl_[0], sl_[1], scal_s)
    check_compact(rs, f"kernel C UST×OPTS under storm winds 5–55 m/s and "
                  f"their u* ({int((u > 25.0).sum())} of {m_} points above "
                  "25 m/s)")
    out.update(ustar_options=r, ustar_options_storm=rs,
               ustar_options_model=dict(phys_ms=tm.phys / 2 * 1e3,
                                        peak_gb=pk))
    del model, ms, sl_, scal_s

    # -- 11d. 66 frequencies (the wide build's shared mask) on the shallow
    # grid: one physics step in each mode, and a run through an output date
    fresh()
    kw66 = dict(cases.shallow_kw(), nfre=66)
    spec, stress, _ = cases.physics_kernel_vs_plain(kw66, dev)
    f = cases.full_kernel_vs_plain(kw66, dev, width=MASK_WIDTH)
    ms = cases.build(kw66, dev)
    model = driver.FastWaveModel(ms, cases.provider(
        cases.golden_forcing(ms.n_real), ms.idelpro), cases.START)
    f0 = ipk.implsch_srl.full_launches
    model.advance(2, full_phys=True)
    n_f = ipk.implsch_srl.full_launches - f0
    worst = max(f["rows"], key=f["rows"].get)
    log(f"shallow 12° at 66 frequencies: minimal spectrum {spec:.3e}, "
        f"stress {stress:.3e}; full spectrum {f['spec']:.3e}, worst row "
        f"{worst} {f['rows'][worst]:.3e}, xllws {f['xllws']} of "
        f"{f['bins']} on the edge and {f['off_edge']} off; {n_f} full-mode "
        f"launches in 2 output-date steps; SWH {model.norms()}")
    if not (spec <= PHYS_TOL and stress <= STRESS_TOL
            and f["spec"] <= PHYS_TOL and f["rows"][worst] <= FULL_ROW_TOL
            and f["off_edge"] == 0
            and f["xllws"] <= XLLWS_SHARE * f["bins"]
            and (n_f > 0 or not launches)):
        raise AssertionError("66 frequencies: kernel disagrees")
    out["nfre66"] = dict(spec=spec, stress=stress, full=f, launches=n_f)
    del model, ms
    fresh()
    return out


def main():
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    from ecwam_tpu_torch import _build
    from ecwam_tpu_torch.model import cases
    from ecwam_tpu_torch.ops import propagation_cuda as pcu
    from ecwam_tpu_torch.ops import propagation_fused as pfz
    from ecwam_tpu_torch.ops.physics import implsch_cuda as ipk
    banned = [m for m in sys.modules if m in ("jax", "ecwam_tpu")
              or m.startswith(("jax.", "ecwam_tpu."))]
    if banned:
        raise RuntimeError(f"the port imported {banned[:5]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # ---- 1. machine + kernel build ---------------------------------------
    card = card_line()
    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[-1]
    log(f"card: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; {nvcc}")
    t0 = time.perf_counter()
    logs = _build.build()
    log(f"kernel build: {time.perf_counter() - t0:.1f} s")
    for name, (sec, text) in logs.items():
        log(f"  {name}: {sec:.1f} s; " + " | ".join(register_lines(text)))

    # ---- 2. small configurations -----------------------------------------
    err, launched = cases.golden_kernel_vs_plain(dev)
    log(f"golden 4 steps, kernels vs plain (tolerance fl1 {TRAJ_TOL}, "
        f"stress {TRAJ_STRESS_TOL}): "
        + ", ".join(f"{k} {v:.3e}" for k, v in err.items())
        + f"; launches {launched}")
    # 4 steps: an all-band and a sub-band pass each, physics every 2nd
    if launched != dict(kernels=(8, 2), plain=(0, 0)):
        raise AssertionError(f"golden launches {launched}")
    if not (err.pop("fl1") <= TRAJ_TOL
            and max(err.values()) <= TRAJ_STRESS_TOL):
        raise AssertionError("golden trajectory: kernels disagree with plain")
    for name, kw, obs in (("golden", cases.golden_kw(), True),
                          ("shallow", cases.shallow_kw(), False)):
        advect_small(name, kw, dev, obs)
    for name, kw in (("golden", cases.golden_kw()),
                     ("shallow", cases.shallow_kw())):
        spec, stress, _ = cases.physics_kernel_vs_plain(kw, dev)
        log(f"{name} physics step, kernel vs plain: spectrum {spec:.3e} "
            f"(tol {PHYS_TOL}), stress {stress:.3e} (tol {STRESS_TOL})")
        if not (spec <= PHYS_TOL and stress <= STRESS_TOL):
            raise AssertionError(f"{name}: physics kernel disagrees")
        f = cases.full_kernel_vs_plain(kw, dev, width=MASK_WIDTH)
        worst = max(f["rows"], key=f["rows"].get)
        log(f"{name} full-mode physics step, kernel vs plain: spectrum "
            f"{f['spec']:.3e} (tol {PHYS_TOL}); rows "
            + ", ".join(f"{k} {v:.2e}" for k, v in f["rows"].items())
            + f" (worst {worst}, tol {FULL_ROW_TOL}); xllws {f['xllws']} of "
            f"{f['bins']} bins differ on the mask's edge and "
            f"{f['off_edge']} off it, on {f['flip_points']} points (largest "
            f"|margin| {f['margin']:.3e}, width {MASK_WIDTH})")
        if not (f["spec"] <= PHYS_TOL and f["rows"][worst] <= FULL_ROW_TOL
                and f["off_edge"] == 0
                and f["xllws"] <= XLLWS_SHARE * f["bins"]):
            raise AssertionError(f"{name}: full-mode kernel disagrees")
    n0 = ipk.implsch_srl.full_launches
    gold = cases.golden_statistics_error(cases.golden_statistics(dev),
                                         GOLDEN)
    worst = max(gold, key=gold.get)
    log(f"golden statistics.log, {cases.GOLDEN_STEPS} output-date steps "
        f"through the kernels ({ipk.implsch_srl.full_launches - n0} "
        f"full-mode launches) vs statistics_golden.json: worst {worst} "
        f"{gold[worst]:.3e} (tol {GOLDEN_RTOL}); "
        + ", ".join(f"{k} {v:.1e}" for k, v in gold.items()))
    if not gold[worst] <= GOLDEN_RTOL:
        raise AssertionError("golden statistics disagree with the reference")

    # ---- 3. full width: the main path through the kernels ----------------
    t0 = time.perf_counter()
    ms, model = o320_model(dev)
    ft = ms.fused
    tabs = model.fp.tabs
    ext = tabs["kseg"][:, 2:].amax(1).cpu()
    log(f"O320 build {time.perf_counter() - t0:.1f} s: n_real={ms.n_real} "
        f"nsrl={ft.nsrl} S={ft.S} EW={ft.EW}, rebased ew2="
        f"{tabs['ktaps'].shape[2]} (segments by largest extent: "
        f"{dict(enumerate(torch.bincount(ext.long()).tolist()))}); "
        f"obstruction table read (OBS) {not tabs['obs_ones']}")
    if not tabs["obs_ones"]:
        raise AssertionError("O320 is open water: OBS must be false")
    torch.cuda.synchronize()
    pcu.advect.launches = 0
    ipk.implsch_srl.launches = 0
    steps = []
    for _ in range(4):
        t_p, t_f = model.timers.propag, model.timers.phys
        model.advance(1)
        steps.append((model.timers.propag - t_p, model.timers.phys - t_f))
    launches = dict(advect=pcu.advect.launches,
                    implsch=ipk.implsch_srl.launches)
    log("O320 steps (t_propag s, t_phys s): "
        + ", ".join(f"({a:.4f}, {b:.4f})" for a, b in steps)
        + f"; launches {launches}")
    if not (launches["advect"] > 0 and launches["implsch"] > 0):
        raise AssertionError(f"main path bypassed a kernel: {launches}")
    norms = model.norms()
    log(f"O320 SWH norms after 4 steps: {norms}; peak allocation "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    if not (np.isfinite([norms["average"], norms["minimum"],
                         norms["maximum"]]).all() and norms["minimum"] > 0):
        raise AssertionError("O320 SWH not finite and positive")
    if not bool(torch.isfinite(model._f_srl).all()):
        raise AssertionError("O320 spectrum not finite")
    t_phys_min = max(b for _, b in steps)

    # the output date: one physics step in chunked full mode
    model.advance(1)                            # no physics on this step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ipk.implsch_srl.full_launches = 0
    t_f = model.timers.phys
    model.advance(1, full_phys=True)
    launches["implsch_full"] = ipk.implsch_srl.full_launches
    t_phys_full = model.timers.phys - t_f
    peak_full = torch.cuda.max_memory_allocated() / 1e9
    n = ms.n_real
    out_norms = {k: (float(v[:n].mean()), float(v[:n].min()),
                     float(v[:n].max())) for k, v in (
        ("swh", torch.as_tensor(model.swh())),
        ("esea", model.state["sep"]["esea"]),
        ("eswell", model.state["sep"]["eswell"]))}
    log(f"O320 output-date step: t_phys full {t_phys_full:.4f} s against "
        f"minimal {t_phys_min:.4f} s; {launches['implsch_full']} full-mode "
        f"launches; peak allocation {peak_full:.2f} GB; norms (avg, min, "
        f"max) " + ", ".join(f"{k} {v}" for k, v in out_norms.items()))
    if launches["implsch_full"] <= 0:
        raise AssertionError("the output date bypassed the full-mode kernel")
    if not all(np.isfinite(v).all() and v[1] > 0
               for v in out_norms.values()):
        raise AssertionError("O320 output-date norms not finite and positive")
    if (set(model.state) != set(ipk.SCAL_OUT_FULL) | {"sep"}
            or len(model.state["sep"]) != 12):
        raise AssertionError("O320 output-date state keys")
    # frequencies above the cut, for kernel B's operations bound
    above_cut = ms.tb.nfre - 1 - float(model.state["mij"][:n].double().mean())

    # kernel A vs plain, one all-band pass over the whole domain
    a_rel, a_abs, a_ms, a_plain, a_bytes = advect_check(model, ft,
                                                        ms.irefra)
    log(f"advect: kernel {a_ms:.3f} ms, plain {a_plain:.3f} ms, "
        f"max|k-p| {a_abs:.3e} = {a_rel:.3e} of max (tol {ADVECT_TOL}); "
        f"{a_bytes / 1e9:.3f} GB a pass")
    if not a_rel <= ADVECT_TOL:
        raise AssertionError("advection kernel disagrees with plain")

    # kernels B and C vs plain on a 32,768-row slice of the same state
    sl = {}
    for full in (False, True):
        mode = "full" if full else "minimal"
        r = sl[mode] = slice_check(ms, model, dev, full, above_cut)
        c = r["compact"]
        log(f"implsch {mode} ({PHYS_ROWS} rows): {r['n_tie']} of "
            f"{r['n_sea']} sea rows on an FRCUTINDEX rounding tie (stress "
            f"off by up to {r['tie_stress']:.3e}); {r['n_off']} other rows "
            "off the tolerances")
        log(f"implsch {mode} ({PHYS_ROWS} rows): kernel {r['ms']:.3f} ms, "
            f"plain {r['plain_ms']:.3f} ms; spectrum max|k-p| "
            f"{r['spec_abs']:.3e} = {r['spec_rel']:.3e} of max (tol "
            f"{PHYS_TOL}), stress {r['stress_rel']:.3e} (tol {STRESS_TOL})"
            + (f"; kernel on all {ft.nsrl} rows {r['all_rows_ms']:.3f} ms"
               if not full else "")
            + f"; bound on all rows {r['all_rows_bound'][0]:.3f} ms "
            f"({r['all_rows_bound'][1]})")
        if full:
            worst = max(r["rows"], key=r["rows"].get)
            log(f"implsch full rows: " + ", ".join(
                f"{k} {v:.2e}" for k, v in r["rows"].items())
                + f" (worst {worst}, tol {FULL_ROW_TOL}); xllws "
                f"{r['xllws']} of {r['xllws_bins']} bins differ on the "
                f"mask's edge and {r['xllws_off']} off it, on "
                f"{r['flip_points']} points (largest |margin| "
                f"{r['margin']:.3e}, width {MASK_WIDTH}; "
                + ", ".join(cases.MASK_FIELDS) + " held out at edge points)")
        log(f"implsch_compact {mode}: kernel {c['ms']:.3f} ms, plain "
            f"{c['plain_ms']:.3f} ms; spectrum {c['spec_rel']:.3e} of max, "
            f"rows {c['rows_rel']:.3e}, xllws {c['xllws']} bins differ on "
            f"the edge and {c['xllws_off']} off it; "
            f"bit-identical to the SRL entry: {c['same_as_srl']}")
        check_slice(r, full, f"implsch {mode}")

    # kernel C's own path: the compact entry on every point, both modes
    fl1, env2d, scal = cases.compact_inputs(model)
    cfgs = {full: ms.phys if full else ipk.minimal_config(ms.phys)
            for full in (False, True)}
    ipk.implsch_compact.launches = 0
    for full, cfg in cfgs.items():
        out = ipk.implsch_compact(cfg, fl1, env2d, scal, full=full)
        if not all(bool(torch.isfinite(x).all()) for x in out):
            raise AssertionError("compact entry produced non-finite values")
        del out
    launches["implsch_compact"] = ipk.implsch_compact.launches
    c_all = {full: cuda_ms(lambda _, c=cfg, f=full: ipk.implsch_compact(
        c, fl1, env2d, scal, full=f), 3) for full, cfg in cfgs.items()}
    log(f"implsch_compact on all {fl1.shape[-1]} points: minimal "
        f"{c_all[False]:.3f} ms, full {c_all[True]:.3f} ms; launches "
        f"{launches['implsch_compact']}")
    if launches["implsch_compact"] <= 0:
        raise AssertionError("the compact entry bypassed its kernel")
    del fl1, env2d, scal

    # ---- 4. where the time goes --------------------------------------------
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.advance(8)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / 8
    bins = ms.n_real * ms.tb.nang * ms.tb.nfre
    log(f"O320 steady state: mean step {step_s * 1e3:.3f} ms over 8 steps "
        f"(4 with physics) = {bins / step_s / 1e9:.3f} Gbins/s")
    wall, split, busy, tries = profile(lambda: model.advance(4))
    log(f"O320 profiled 4 steps ({tries} window(s)): wall {wall:.3f} ms, "
        f"device busy "
        f"{busy:.3f} ms ({100 * busy / wall:.1f} %); "
        + ", ".join(f"{k} {t:.3f} ms in {n} launches "
                    f"({100 * t / busy:.1f} % of device time)"
                    for k, (t, n) in split.items()))
    model.advance(1)
    wall, split, busy, tries = profile(
        lambda: model.advance(1, full_phys=True))
    rest = busy - sum(t for t, _ in split.values())
    log(f"O320 profiled output-date step (advection + chunked full "
        f"physics, {tries} window(s)): wall {wall:.3f} ms, device busy "
        f"{busy:.3f} ms; "
        + ", ".join(f"{k} {t:.3f} ms in {n} launches"
                    for k, (t, n) in split.items())
        + f"; outside the kernels (windsea/swell split, chunk copies) "
        f"{rest:.3f} ms")

    # ---- 5. the operational options (the default O320 model freed first)
    del model, ms, ft
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    op = options_phase(dev)

    # ---- 6. the rest of the physics (the options' O320 model freed first)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    lg = legacy_phase(dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # ---- 7. kernel D, the op-class micro-benchmark
    od = opclass_phase(dev)

    # ---- 8. the command line's run loop, 12° and O320
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    cli_phase(dev)

    # ---- 9. the dense WaveModel: golden grid, u*, O320, the CLI
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    wm = wavemodel_phase(dev)

    # ---- 10. nesting, coupling, assimilation, phys_srl_chunked
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    boundary_phase(dev)

    # ---- 11. the shapes beyond the default build
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    sh = shapes_phase(dev)

    # ---- 12. report --------------------------------------------------------
    def entry(name, source, replaces, n_launch, abs_err, ms_k, ms_p,
              byte_count, ops):
        b_ms, b_by = bound(byte_count, ops)
        return dict(name=name, route="cuda", source=source,
                    replaces=replaces, launches=n_launch,
                    max_abs_err=abs_err, ms=ms_k, plain_ms=ms_p,
                    bound_ms=b_ms, bound_by=b_by, library_ms=None)
    mn, fu = sl["minimal"], sl["full"]
    isrc = "ecwam_tpu_torch/csrc/implsch.cu"
    kernels = [
        entry("advect", "ecwam_tpu_torch/csrc/advect.cu",
              "ecwam_tpu/ops/propagation_pallas.py:564", launches["advect"],
              a_abs, a_ms, a_plain, a_bytes, 0),
        entry("implsch_minimal", isrc,
              "ecwam_tpu/ops/physics/implsch_pallas.py:381",
              launches["implsch"], mn["spec_abs"], mn["ms"], mn["plain_ms"],
              mn["bytes"], mn["ops"]),
        entry("implsch_full", isrc,
              "ecwam_tpu/ops/physics/implsch_pallas.py:381",
              launches["implsch_full"], fu["spec_abs"], fu["ms"],
              fu["plain_ms"], fu["bytes"], fu["ops"]),
        entry("implsch_compact", isrc,
              "ecwam_tpu/ops/physics/implsch_pallas.py:250",
              wm["o320_launches"], wm["slice"]["spec_abs"], wm["slice"]["ms"],
              wm["slice"]["plain_ms"], wm["slice"]["bytes"],
              wm["slice"]["ops"]),
        entry("implsch_compact_ustar", isrc,
              "ecwam_tpu/ops/physics/implsch_pallas.py:250",
              wm["ustar_launches"], wm["slice_ustar"]["spec_abs"],
              wm["slice_ustar"]["ms"], wm["slice_ustar"]["plain_ms"],
              wm["slice_ustar"]["bytes"], wm["slice_ustar"]["ops"])]
    oa, omn, ofu = op["advect"], op["minimal"], op["full"]
    kernels += [
        entry("advect_currents", "ecwam_tpu_torch/csrc/advect.cu",
              "ecwam_tpu/ops/propagation_pallas.py:564",
              op["launches"]["advect"], oa[1], oa[2], oa[3], oa[4], 0),
        entry("implsch_minimal_options", isrc,
              "ecwam_tpu/ops/physics/implsch_pallas.py:381",
              op["launches"]["implsch"], omn["spec_abs"], omn["ms"],
              omn["plain_ms"], omn["bytes"], omn["ops"]),
        entry("implsch_full_options", isrc,
              "ecwam_tpu/ops/physics/implsch_pallas.py:381",
              op["launches"]["implsch_full"], ofu["spec_abs"], ofu["ms"],
              ofu["plain_ms"], ofu["bytes"], ofu["ops"])]
    lmn, lfu = lg["minimal"], lg["full"]
    kernels += [
        entry("implsch_minimal_legacy", isrc,
              "ecwam_tpu/ops/physics/implsch_pallas.py:381",
              lg["launches"]["implsch"], lmn["spec_abs"], lmn["ms"],
              lmn["plain_ms"], lmn["bytes"], lmn["ops"]),
        entry("implsch_full_legacy", isrc,
              "ecwam_tpu/ops/physics/implsch_pallas.py:381",
              lg["launches"]["implsch_full"], lfu["spec_abs"], lfu["ms"],
              lfu["plain_ms"], lfu["bytes"], lfu["ops"])]
    kernels[0]["max_rel_err"] = a_rel
    kernels[5]["max_rel_err"] = oa[0]
    for e, r in zip(kernels[1:5] + kernels[6:],
                    (mn, fu, wm["slice"], wm["slice_ustar"], omn, ofu, lmn,
                     lfu)):
        e["max_rel_err"] = r["spec_rel"]
    kernels[3]["all_points_ms"] = wm["slice"]["all_ms"]
    kernels[3]["all_points_bound_ms"] = wm["slice"]["all_bound"][0]
    w, us = sh["wide"], sh["ustar_options"]
    new = [
        (entry("advect_72", "ecwam_tpu_torch/csrc/advect.cu",
               "ecwam_tpu/ops/propagation_pallas.py:564",
               w["launches"]["advect"], w["advect"][1], w["advect"][2],
               w["advect"][3], w["advect"][4], 0), w["advect"][0])]
    for mode in ("minimal", "full"):
        r = w[mode]
        new.append((entry(
            f"implsch_{mode}_72", isrc,
            "ecwam_tpu/ops/physics/implsch_pallas.py:381",
            w["launches"]["implsch" if mode == "minimal" else "implsch_full"],
            r["spec_abs"], r["ms"], r["plain_ms"], r["bytes"], r["ops"]),
            r["spec_rel"]))
    new.append((entry(
        "implsch_compact_ustar_options", isrc,
        "ecwam_tpu/ops/physics/implsch_pallas.py:250", us["launches"],
        us["spec_abs"], us["ms"], us["plain_ms"], us["bytes"], us["ops"]),
        us["spec_rel"]))
    for sw, r in sh["switches"].items():
        new.append((entry(
            f"implsch_full_no_{sw}", isrc,
            "ecwam_tpu/ops/physics/implsch_pallas.py:381", r["launches"],
            r["spec_abs"], r["ms"], r["plain_ms"], r["bytes"], r["ops"]),
            r["spec_rel"]))
    for e, rel in new:
        e["max_rel_err"] = rel
        kernels.append(e)
    kernels[-len(new) + 1]["all_rows_ms"] = w["minimal"]["all_rows_ms"]
    for r in od:
        kernels.append(dict(
            name=f"opclass_{r['name']}", route="cuda",
            source="ecwam_tpu_torch/csrc/opclass.cu",
            replaces="scripts/mosaic_opclass.py:63", launches=r["launches"],
            max_abs_err=r["max_abs_err"], max_rel_err=r["max_rel_err"],
            ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"],
            bound_by="operations" if r["bound_by"] == "ops" else "bytes",
            bound_of=r["bound_by"], library_ms=r["library_ms"],
            hbm_bound_ms=r["hbm_ms"],
            ns_per_app_tile=r["ns_per_app_tile"]))
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
