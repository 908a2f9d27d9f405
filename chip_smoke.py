"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases (any failure raises and the script exits non-zero):
  1. machine: card name and power limit, CUDA/torch/nvcc versions; build
     both kernel sources (csrc/advect.cu, csrc/implsch.cu) with nvcc for
     sm_90a, in parallel;
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
     counts, kernel A and kernel B against plain as in phase 3, and the
     timing and profile of phase 4;
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
  8. one JSON line with each kernel's launches, errors, times and bound;
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
PHYS_ROWS = 32768
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
FP32_OPS_PER_S = 67e12             # H100 SXM, float32 outside tensor cores
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                      "golden", "statistics_golden.json")


def log(*a):
    print(*a, flush=True)


def register_lines(text: str) -> list:
    """Each kernel's registers and spills from ``nvcc -Xptxas=-v``, named
    by its template (``implsch_kernel<FULL,COMPACT,OPTS,EXT,JAN>``)."""
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
    warm-up; ``setup`` (untimed) makes each run's input."""
    import torch
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
    LCISCAL terms with the group speed per frequency."""
    import numpy as np
    f, dia, jtot, niter = cfg.tables.nfre, cfg.dia, 19, 18
    a, nb, ml = nang, nang * f, int(cfg.dia.mlsthg)
    # SDEPTHLIM and FKMEAN: column sums, moments, the scaled bins
    ops = (3 * nb + 2 * f + 5) + (nb + 6 * f + 11)
    # the direction rows (cos, sin², FLM) and the first call's tail floor
    ops += 12 * a + 2
    # each SINFLX call: TAUT_Z0 (18 Newton steps of 33), FEMEANWS,
    # FRCUTINDEX and STRESSO with its 19-node tail integral
    ops += 2 * ((21 + 33 * niter) + (4 * f + 7) + 11
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
    if full:
        nodd = f - 1 + f % 2
        # PHIWA's sums and PHIHF's integral in both calls; the flux source
        # sums and the cap term; WNFLUXES; the second FKMEAN and
        # FEMEANWS; STOKESTRN
        ops += 2 * (5 * nb + f + 4 * f + a + 9 + 28 * jtot)
        ops += 17 * nb + 3 * f + (14 * f + 40) + (nb + 14 * f + 21)
        ops += windsea * nb + 4 * f + 10
        ops += 12 * nodd + 5 * a * nodd + 4 * a + 10
    p = cfg.params
    if p.llgcbz0:
        # HALPHAP (call 1): the downwind sums, four moments, the scalars
        ops += 7 * nb + 9 * f + 30
        # per call: first guess, then NITER first-loop steps (STRESS_GC:
        # 25 a wavenumber from the cut-off, 30 scalar; the step, 25) and
        # NITER second-loop steps (40), the fallbacks (30); the TAU_PHI_HF
        # cut-off (NS_GC and the log, 12)
        ops += 2 * (40 + niter * (25 * gc_terms + 55) + niter * 40 + 30
                    + 12)
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
    if full and cfg.lstrn:
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
    ms = setup_mod.build_model(grid_name="O320", nang=36, nfre=36,
                               nfre_red=29, idelpro=450.0, idelt=900.0,
                               pad_to=8192, device=dev)
    rng = np.random.default_rng(0)
    n = ms.n_real
    wind = dict(wswave=8.0 + 4.0 * rng.random(n),
                wdwave=rng.random(n) * 2.0 * np.pi,
                aird=np.full(n, 1.225), wstar=np.zeros(n),
                cicover=np.zeros(n))
    return ms, driver.FastWaveModel(ms, lambda date14: wind, cases.START)


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


def slice_check(ms, model, dev, full, above_cut, r0=None):
    """Kernel B against the plain chain on the sea rows of a
    PHYS_ROWS-row slice of the model's state (from row ``r0``, by default
    the middle row), in minimal or full mode; then, on the same rows as a
    compact (nang, nfre, rows) spectrum, kernel C against its plain
    version and against kernel B.  Returns the readings, with the
    operations bound counted for ``above_cut`` (see :func:`implsch_ops`)
    and this step's windsea mask."""
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
    r["ops"] = PHYS_ROWS * implsch_ops(cfg, fp.nang, full, **data)

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
    if not full:
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
            f"{100 * r['share']:.1f} %; {r['launches']} launches")
        if not r["ok"]:
            raise AssertionError(f"opclass {name}: kernel disagrees")
    del x
    torch.cuda.empty_cache()
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

    # ---- 8. report ---------------------------------------------------------
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
              launches["implsch_compact"],
              fu["compact"]["spec_abs"], fu["compact"]["ms"],
              fu["compact"]["plain_ms"], fu["compact"]["bytes"], fu["ops"])]
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
    kernels[4]["max_rel_err"] = oa[0]
    for e, r in zip(kernels[1:4] + kernels[5:],
                    (mn, fu, fu["compact"], omn, ofu, lmn, lfu)):
        e["max_rel_err"] = r["spec_rel"]
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
