"""The work a step needs, counted from the configuration, the shapes and
the step's data, never from the kernel that ran: a later change that
fuses or replaces a kernel is read against the same work.

* :func:`advect_bytes`: the bytes one CTU pass over the SRL rows must
  move: each advected bin read once and each written bin written once,
  the group speed of each row and advected frequency, and with
  refraction the per-row frequency rows and gradients (and the current)
  it reads.  Tables a kernel could rebuild from the grid are not
  counted.
* :func:`implsch_ops`: the float32 operations of the IMPLSCH chain on one
  row (frozen from ``chip_smoke.implsch_ops``; the physics configuration
  comes from the reference's own tables).
* :func:`physics_bytes`: a physics step's bytes (spectrum in and out, its
  per-row inputs and outputs).
* :func:`output_bytes`: the least an output date's second order and
  products move: the compact spectrum read once and the fields written
  once.
* :func:`bound_s`: the least time of a piece of work on the card, the
  larger of its operations over the float32 peak and its bytes over the
  HBM rate (H100 SXM data sheet).
"""

from __future__ import annotations

import numpy as np
import torch

# NVIDIA H100 SXM data sheet: float32 outside the tensor cores, HBM3
FP32_OPS_PER_S = 67.0e12
HBM_BYTES_PER_S = 3.35e12
F32 = 4


def bound_s(ops: float = 0.0, nbytes: float = 0.0) -> float:
    """The least seconds for ``ops`` float32 operations and ``nbytes``
    bytes of device memory traffic."""
    return max(ops / FP32_OPS_PER_S, nbytes / HBM_BYTES_PER_S)


def advect_bytes(nrows: int, nang: int, nf: int, nw: int,
                 irefra: int) -> int:
    """Bytes of one CTU pass on ``nrows`` SRL rows that computes ``nf``
    frequencies of each of ``nang`` directions and writes ``nw`` of them:
    the spectrum's computed bins read and written bins written, cg per
    (row, frequency), and for irefra ≥ 1 the frequency rows (one per
    frequency, three with currents) and the 8 gradients, with currents
    (irefra 2/3) the (u, v) of each row."""
    b = nrows * (nang * (nf + nw) + nf) * F32
    if irefra:
        b += nrows * (nf * (3 if irefra in (2, 3) else 1) + 8) * F32
    if irefra in (2, 3):
        b += nrows * 2 * F32
    return b


def physics_bytes(nrows: int, nang: int, nfre: int, full: bool) -> int:
    """Bytes of one physics step on ``nrows`` rows: the spectrum read and
    written, the dispersion rows (3 per frequency) and 14 scalar inputs
    read, the 6 stress rows (30 full-mode rows and the windsea mask in
    full mode) written."""
    b = nrows * (2 * nang * nfre + 3 * nfre + 14 + 6) * F32
    if full:
        b += nrows * (24 + nang * nfre) * F32
    return b


def output_bytes(npts: int, nang: int, nfre: int, nfields: int) -> int:
    """Bytes an output date's second order and products must move at the
    least: the compact spectrum of ``npts`` points read once, the
    ``nfields`` fields written once and copied to the host."""
    return npts * (nang * nfre + 2 * nfields) * F32


def gc_terms(ufric, gc_mod) -> float:
    """The mean number of gravity-capillary wavenumbers STRESS_GC sums
    (from the cut-off NS_GC(u*) up) at these friction velocities;
    ``gc_mod`` is the reference's :mod:`.ops.physics.gc`."""
    g = gc_mod.gc_tables()
    u = torch.as_tensor(ufric, dtype=torch.float64)
    return float((g.nwav - gc_mod.ns_gc(u, g)).double().mean())


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


def window_work(ctx: dict) -> dict:
    """The counted work of a window, by piece: ``advect`` (bytes of every
    CTU pass: each step's passes and, with currents, each forcing
    period's CFL retry pass), ``implsch`` (operations and bytes of the
    minimal physics steps), ``output`` (the output dates' full-mode
    physics, and the bytes of their second order and products).  Each is
    a list of (operations, bytes, count)."""
    win, bk, n = ctx["window"], ctx["config"], ctx["n_real"]
    nang = bk["nang"]
    nfre = bk["nfre"]
    nfre_red = bk.get("nfre_red") or nfre
    irefra = bk.get("irefra", 0)
    d = ctx["data"]
    shares = dict(above_cut=d["above_cut"], shallow=d["shallow"],
                  windsea=d["windsea"], ice=d["ice"],
                  gc_terms=d["gc_terms"])
    adv = [(0.0, advect_bytes(n, nang, nf, nw, irefra), win["steps"])
           for nf, nw in ctx["passes"]]
    if ctx["currents"]:
        adv.append((0.0, advect_bytes(n, nang, nfre_red, nfre_red, irefra),
                    win["units"]))
    phys = [(n * implsch_ops(ctx["phys"], nang, False, **shares),
             physics_bytes(n, nang, nfre, False), win["phys_min_steps"])]
    out = []
    if ctx["output"]:
        dates = win["units"]
        out = [(n * implsch_ops(ctx["phys"], nang, True, **shares),
                physics_bytes(n, nang, nfre, True), dates),
               (0.0, output_bytes(n, nang, nfre, len(ctx["fields"])), dates)]
    return dict(advect=adv, implsch=phys, output=out)


def bound_total(pieces) -> float:
    """Σ count × the least seconds of each (operations, bytes, count)."""
    return sum(k * bound_s(o, b) for o, b, k in pieces)


def expected_launches(ctx: dict) -> dict:
    """The launches of kernels A and B the window's counted work implies:
    the check of the work model against the port's counters."""
    win = ctx["window"]
    return dict(advect=win["steps"] * len(ctx["passes"])
                + (win["units"] if ctx["currents"] else 0),
                implsch=win["phys_min_steps"],
                implsch_full=win["units"] if ctx["output"] else 0)
