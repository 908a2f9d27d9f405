"""Deliberately broken copies of the CUDA kernels against the card limits.

    python3 ecwam_tpu_torch/tools/mutations.py            # every copy
    python3 ecwam_tpu_torch/tools/mutations.py sound rnfac_one ...

Run from the repository root on a machine with one CUDA card.  For the
sound kernels and for each entry of MUTATIONS (one text change in one
kernel source) it copies the package, chip_smoke.py and the golden
statistics into a temporary directory outside the repository, applies the
change there, builds it (the unchanged sources' libraries are copied from
the sound build; the copies build in parallel) and then, one copy at a
time, reads the checks of chip_smoke.py that cover
the changed code, with their limits: for ``full`` (kernel B's full mode)
the golden and shallow physics steps, the golden statistics.log
trajectory and the O320 slice; for ``options`` (kernel B with the
cycle-49/50 options) the shallow cy50r1 and golden cy49r1 physics steps
in both modes and the full-mode slice of ``cases.o320_options``; for
``currents`` (kernel A with currents) the currents grids' passes and CFL
retry mask, the golden currents trajectory and the O320 options pass; for
``legacy`` (kernel B's EXT and JAN instantiations) the physics steps of
``cases.LEGACY_CASES`` in both modes and the full-mode slice of
``cases.o320_legacy``; for ``advect`` (kernel A without currents: the
rebased taps, the staged windows and the OBS route) the golden grid's
pass (obstructions) and the shallow grid's (open water), the golden
trajectory and the O320 pass; for ``minimal`` (kernel B's default
minimal mode, the main path between output dates) the golden and shallow
physics steps, the 4-step golden trajectory and the O320 minimal slice;
for ``shapes`` (kernel B/C beyond the default build: the full-mode
switches, the wide build at 72 directions, u* with the cycle-50r1
options, 66 frequencies) chip_smoke.py's phase 11.
The sound copy reads them all.  Prints one JSON line per copy: the
readings and the checks it fails.
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC = os.path.join("ecwam_tpu_torch", "csrc")
IMPLSCH, ADVECT = "implsch.cu", "advect.cu"

# the kinds of check a copy is read against (see the module docstring)
KINDS = ("full", "options", "currents", "legacy", "advect", "minimal",
         "shapes")

# name: (checks, source, text, replacement); the sound copy reads every
# kind of check
MUTATIONS = {
    "sound": (KINDS, None, None, None),
    # the FLMAX cap's term left out of the flux source
    "no_cap_flux": (("full",), IMPLSCH,
        "if (FULL) W.fld[b] = P[P_DELTM] * fminf(T.flmax[m] - f, 0.f);",
        "if (FULL) W.fld[b] = 0.f;"),
    # the Stokes drift's f^-5 tail term left out
    "no_stokes_tail": (("full",), IMPLSCH,
        "us = row_sum(us) + P[P_STOKES_C] * row_sum(ut);",
        "us = row_sum(us) + 0.f * row_sum(ut);"),
    # PHIWA without the tail's energy flux PHIHF
    "no_phihf": (("full",), IMPLSCH,
        "phiwa += f1dcos2 * (aird * P[P_ZPI4GM1] * T.fr5[mij]) * sqrtz0og * acc;",
        "phiwa += 0.f * acc;"),
    # the flux source without the implicit factor 1/max(1 − δ·fld, 1)
    "no_implicit_factor": (("full",), IMPLSCH,
        "const float ss = W.sl[b] / fmaxf(1.f - P[P_DELT5] * W.fld[b], 1.f);",
        "const float ss = W.sl[b];"),
    # the windsea mask's test moved by 1e-3 in zlog (the growth term kept)
    "mask_edge_moved": (("full",), IMPLSCH,
        "if (active) xll[q] = 1.f;",
        "if (active && zlog < -1e-3f) xll[q] = 1.f;"),
    # one bin of the written mask dropped: direction 0, frequency nfre/2
    "mask_bit_dropped": (("full",), IMPLSCH,
        "(float)((xbits[q] >> m) & 1ull);",
        "(float)((xbits[q] >> m) & (k == 0 && m == nfre / 2 ? 0ull : 1ull));"),
    # STRESS_GC without its tail sum: only the cut-off wavenumber's term
    "gc_tail_dropped": (("options",), IMPLSCH,
        ": G[G_DELKCC_OMXKM3 * nw + i]);",
        ": 0.f);"),
    # the LLNORMAGAM/LLCAPCHNK growth factor RNFAC forced to 1
    "rnfac_one": (("options",), IMPLSCH,
        "? 1.f + P[P_DTHRN_A] * (1.f + tanhf(wswave - P[P_DTHRN_U])) : 1.f;",
        "? 1.f : 1.f;"),
    # SDICE3's ice attenuation left out
    "no_sdice3": (("options",), IMPLSCH,
        "const bool ciwa3 = icerun && (opts & OPT_LCIWA3);",
        "const bool ciwa3 = false;"),
    # LCISCAL's open-water scaling of the sources left out
    "no_lciscal": (("options",), IMPLSCH,
        "if (icerun && (opts & OPT_LCISCAL)) {",
        "if (false) {"),
    # the σ̇ inflow from frequency m−1 dropped
    "no_sdot_mm1": (("currents",), ADVECT,
        "out = out + w_mm1 * own[j - m + mm1];",
        "out = out + 0.f * own[j - m + mm1];"),
    # one downstream corner weight (x reversed, y upstream) zeroed
    "no_downstream_corner": (("currents",), ADVECT,
        "const float wg2 = dxdw_2 * dyup_1 * aream1;",
        "const float wg2 = 0.f;"),
    # the CFL flag never set
    "no_cfl_flag": (("currents",), ADVECT,
        "bad = adx > z || ady > xdella || sumwn > 1.f || sumwn < 0.f;",
        "bad = false;"),
    # the rebase offset dropped from the dn window's base
    "no_rebase_offset": (("advect",), ADVECT,
        "t.db = (long)g.dn + g.sg.x + (long)tile * a.RT;",
        "t.db = (long)g.dn + (long)tile * a.RT;"),
    # the k−1 halo direction taken without the wrap at k = 0
    "halo_no_wrap": (("advect",), ADVECT,
        "const int kl = (k0 + a.nang - 1) % a.nang;",
        "const int kl = k0 - 1;"),
    # the last dn row of a row tile left unstaged
    "dn_row_unstaged": (("advect",), ADVECT,
        "const int nwd = t.ed > 0 ? RT + t.ed - 1 : 0;",
        "const int nwd = t.ed > 0 ? RT + t.ed - 2 : 0;"),
    # OBS forced false: the obstruction table never read
    "obs_off": (("advect",), ADVECT,
        "const bool use_obs = obs_flag != 0;",
        "const bool use_obs = false;"),
    # SINPUT_JAN's growth term with one zlog²·x factor dropped
    "jan_growth": (("legacy",), IMPLSCH,
        "gam[q] = active ? zlog2x * zlog2x * expf(zlog) * cnsn : 0.f;",
        "gam[q] = active ? zlog2x * expf(zlog) * cnsn : 0.f;"),
    # SDISSIP_JAN without its leading k/k̄ factor
    "sdissip_jan_x": (("legacy",), IMPLSCH,
        "const float t = sds * x * ((1.f - dsd) + dsd * x)",
        "const float t = sds * ((1.f - dsd) + dsd * x)"),
    # PEAK_ANG's peak one frequency too high
    "peak_off_by_one": (("legacy",), IMPLSCH,
        "const int mmax = best > 0.f ? ib : 1;",
        "const int mmax = best > 0.f ? ib + 1 : 1;"),
    # TRANSF_SNL's upper clip at 2 instead of 10
    "transf_snl_clip": (("legacy",), IMPLSCH,
        "(dvg * (t4 * t4)), 0.1f), 10.f);",
        "(dvg * (t4 * t4)), 0.1f), 2.f);"),
    # SDICE1's second period cell one too far
    "sdice1_index": (("legacy",), IMPLSCH,
        "const int it1 = min(it + 1, nict - 1);",
        "const int it1 = min(it + 2, nict - 1);"),
    # SDICE2's wave height halved
    "sdice2_ewh": (("legacy",), IMPLSCH,
        "const float ewh = 4.f * sqrtf(fmaxf(P[P_EPSMIN], f * T.dfim[m]));",
        "const float ewh = 2.f * sqrtf(fmaxf(P[P_EPSMIN], f * T.dfim[m]));"),
    # the strain row from e·E in place of e²·E
    "strain_row": (("legacy",), IMPLSCH,
        "if (sume > P[P_F1LIM]) part += (e * e) * sume * T.dfim[m];",
        "if (sume > P[P_F1LIM]) part += e * sume * T.dfim[m];"),
    # SDISSIP's maximum saturation bth0 replaced by the bin's own
    "sdissip_bth0_own": (("minimal",), IMPLSCH,
        "const float d0 = W.tm[m];",
        "const float d0 = zc2 * P[P_SSDSC6] * (t * t);"),
    # one DIA target (ikp1) dropped
    "dia_ikp1_dropped": (("minimal",), IMPLSCH,
        "const bool cp1 = tp1 >= 0 && tp1 < nfre;",
        "const bool cp1 = false;"),
    # SINPUT's sheltering term tws set to 0
    "no_sheltering": (("minimal",), IMPLSCH,
        "const float tws = fabsf(P[P_TAUWSHELTER]);",
        "const float tws = 0.f;"),
    # TAUT_Z0 one Newton step short
    "taut_z0_short": (("minimal",), IMPLSCH,
        "  for (int it = 0; it < NITER; ++it) {\n"
        "    const float x = fmaxf(tauwact / tauold, xmin);",
        "  for (int it = 0; it < NITER - 1; ++it) {\n"
        "    const float x = fmaxf(tauwact / tauold, xmin);"),
    # TAUT_Z0 stopped after half its Newton steps
    "taut_z0_half": (("minimal",), IMPLSCH,
        "  for (int it = 0; it < NITER; ++it) {\n"
        "    const float x = fmaxf(tauwact / tauold, xmin);",
        "  for (int it = 0; it < NITER / 2; ++it) {\n"
        "    const float x = fmaxf(tauwact / tauold, xmin);"),
    # the last direction (k = nang−1) skipped in the update
    "update_last_direction": (("minimal",), IMPLSCH,
        "    const float temp = usfm * (T.cofrm4[m] * P[P_DELT]);",
        "    if (k == T.nang - 1) return;\n"
        "    const float temp = usfm * (T.cofrm4[m] * P[P_DELT]);"),
    # Z0WAVE under u* without LLCAPCHNK's capped Charnock parameter
    "ust_no_capchnk": (("shapes",), IMPLSCH,
        "const float alphaog = (opts & OPT_LLCAPCHNK) ? chnkmin(P, u10) * P[P_GM1]",
        "const float alphaog = (opts & OPT_LLCAPCHNK) ? P[P_ALPHAOG]"),
    # the wide build's third and fourth directions of a lane (k ≥ 64)
    # left out of SNONLIN's target bins
    "kpl4_snonlin_targets": (("shapes",), IMPLSCH,
        "        const bool put = k < nang;",
        "        const bool put = k < nang && q < 2;"),
    # LWVFLX_SNL off: the flux source before SNONLIN dropped
    "no_pre_snonlin_flux": (("shapes",), IMPLSCH,
        "        const float ss = W.sl[k * nfp + m];",
        "        const float ss = 0.f * W.sl[k * nfp + m];"),
    # the row sums' butterfly started one step too wide: with two rows a
    # warp it adds the other row's lanes, with one row a warp each lane's
    # own value (out of range), so the sums double
    "row_sum_both_rows": (("minimal",), IMPLSCH,
        "  for (int o = RL / 2; o > 0; o >>= 1) v += __shfl_xor_sync(ALL, v, o, RL);",
        "  for (int o = RL; o > 0; o >>= 1) v += __shfl_xor_sync(ALL, v, o);"),
}


def readings(kinds) -> dict:
    """The checks of chip_smoke.py of ``kinds`` on the tree at
    sys.path[0]."""
    import torch
    from ecwam_tpu_torch import _build
    out, fails = {}, []
    dev = torch.device("cuda")
    _build.build()                  # every library at once, in parallel
    for kind in KINDS:
        if kind in kinds:
            CHECKS[kind](dev, out, fails)
    out["fails"] = fails
    return out


def _minimal(dev, out, fails):
    """Kernel B's default minimal mode: the golden and shallow physics
    steps, the 4-step golden trajectory and the O320 minimal slice."""
    import chip_smoke as cs
    from ecwam_tpu_torch.model import cases
    for name, kw in (("golden", cases.golden_kw()),
                     ("shallow", cases.shallow_kw())):
        spec, stress, _ = cases.physics_kernel_vs_plain(kw, dev)
        out[f"{name}_minimal"] = dict(spec=spec, stress=stress)
        if spec > cs.PHYS_TOL:
            fails.append(f"{name} minimal spectrum")
        if stress > cs.STRESS_TOL:
            fails.append(f"{name} minimal stress")
    err, _ = cases.golden_kernel_vs_plain(dev)
    out["golden_trajectory"] = dict(err)
    if (err.pop("fl1") > cs.TRAJ_TOL
            or max(err.values()) > cs.TRAJ_STRESS_TOL):
        fails.append("golden trajectory")
    ms, model = cs.o320_model(dev)
    model.advance(4)
    r = cs.slice_check(ms, model, dev, False, above_cut=0.0)
    out["o320_minimal"] = dict(spec=r["spec_rel"], stress=r["stress_rel"],
                               n_off=r["n_off"], n_tie=r["n_tie"])
    try:
        cs.check_slice(r, False, "o320 minimal")
    except AssertionError:
        fails.append("o320 minimal slice")


def _full(dev, out, fails):
    """Kernel B's full-mode checks."""
    import chip_smoke as cs
    from ecwam_tpu_torch.model import cases
    for name, kw in (("golden", cases.golden_kw()),
                     ("shallow", cases.shallow_kw())):
        f = cases.full_kernel_vs_plain(kw, dev, width=cs.MASK_WIDTH)
        worst = max(f["rows"], key=f["rows"].get)
        out[name] = dict(spec=f["spec"], worst=worst, rows=f["rows"][worst],
                         xllws=f["xllws"], xllws_off=f["off_edge"],
                         margin=f["margin"])
        if f["spec"] > cs.PHYS_TOL:
            fails.append(f"{name} spectrum")
        if f["rows"][worst] > cs.FULL_ROW_TOL:
            fails.append(f"{name} rows")
        if (f["off_edge"] > 0
                or f["xllws"] > cs.XLLWS_SHARE * f["bins"]):
            fails.append(f"{name} xllws")
    gold = cases.golden_statistics_error(cases.golden_statistics(dev),
                                         cs.GOLDEN)
    worst = max(gold, key=gold.get)
    out["statistics"] = dict(worst=worst, rel=gold[worst])
    if gold[worst] > cs.GOLDEN_RTOL:
        fails.append("golden statistics")
    ms, model = cs.o320_model(dev)
    model.advance(4)
    r = cs.slice_check(ms, model, dev, True, above_cut=0.0)
    worst = max(r["rows"], key=r["rows"].get)
    out["o320"] = dict(spec=r["spec_rel"], stress=r["stress_rel"],
                       worst=worst, rows=r["rows"][worst], xllws=r["xllws"],
                       xllws_off=r["xllws_off"], margin=r["margin"],
                       n_off=r["n_off"], n_tie=r["n_tie"])
    try:
        cs.check_slice(r, True, "o320")
    except AssertionError:
        fails.append("o320 slice")


def _options(dev, out, fails):
    """Kernel B's checks with the cycle-49/50 options."""
    import chip_smoke as cs
    from ecwam_tpu_torch.model import cases
    gc = dict(gc_width=cs.GC_WIDTH, off_tol=cs.STRESS_TOL)
    for name, kw, frc in (("shallow_cy50r1", cases.shallow_kw(True),
                           cases.shallow_ice),
                          ("golden_cy49r1", dict(cases.golden_kw(),
                                                 **cases.CY49R1),
                           cases.storm)):
        spec, stress, held = cases.physics_kernel_vs_plain(
            kw, dev, forcing=frc, **gc)
        f = cases.full_kernel_vs_plain(kw, dev, width=cs.MASK_WIDTH,
                                       forcing=frc, **gc)
        worst = max(f["rows"], key=f["rows"].get)
        out[name] = dict(spec=spec, stress=stress, held=held,
                         full_spec=f["spec"], worst=worst,
                         rows=f["rows"][worst], full_held=f["held"],
                         xllws_off=f["off_edge"])
        if spec > cs.PHYS_TOL or f["spec"] > cs.PHYS_TOL:
            fails.append(f"{name} spectrum")
        if stress > cs.STRESS_TOL or f["rows"][worst] > cs.FULL_ROW_TOL:
            fails.append(f"{name} rows")
        if max(held, f["held"]) > 1:
            fails.append(f"{name} rows held")
        if f["off_edge"] > 0:
            fails.append(f"{name} xllws")
    ms, model = cases.o320_options(dev)
    model.advance(2)
    r = cs.slice_check(ms, model, dev, True, above_cut=0.0)
    worst = max(r["rows"], key=r["rows"].get)
    out["o320_options"] = dict(
        spec=r["spec_rel"], stress=r["stress_rel"], worst=worst,
        rows=r["rows"][worst], n_off=r["n_off"], n_gc=r["n_gc"],
        n_tie=r["n_tie"], xllws_off=r["xllws_off"])
    try:
        cs.check_slice(r, True, "o320 options")
    except AssertionError:
        fails.append("o320 options slice")


def _currents(dev, out, fails):
    """Kernel A's checks with currents."""
    import chip_smoke as cs
    from ecwam_tpu_torch.model import cases
    for name, kw in (("cfl", cases.currents_kw(3, cfl=True)),
                     ("fast", cases.currents_kw(2, fast=True)),
                     ("golden", cases.golden_kw(3, currents=True))):
        a = cases.advect_kernel_vs_plain(kw, dev)
        out[f"advect_{name}"] = dict(main=a["main"], sub=a["sub"],
                                     cfl_differ=a["cfl_differ"],
                                     cfl_masked=a["cfl_masked"])
        if max(a["main"], a["sub"] or 0.0) > cs.ADVECT_TOL:
            fails.append(f"advect {name}")
        if a["cfl_differ"]:
            fails.append(f"advect {name} CFL mask")
    err, _ = cases.golden_kernel_vs_plain(
        dev, kw=cases.golden_kw(3, currents=True))
    out["golden_currents"] = err
    if (err.pop("fl1") > cs.TRAJ_TOL
            or max(err.values()) > cs.TRAJ_STRESS_TOL):
        fails.append("golden currents trajectory")
    ms, model = cases.o320_options(dev)
    a = cs.advect_check(model, ms.fused, ms.irefra)
    out["o320_options_advect"] = a[0]
    if a[0] > cs.ADVECT_TOL:
        fails.append("o320 options advect")


def _advect(dev, out, fails):
    """Kernel A's checks without currents: the golden (obstructions) and
    shallow grids' passes, the golden trajectory and the O320 pass."""
    import chip_smoke as cs
    from ecwam_tpu_torch.model import cases
    for name, kw in (("golden", cases.golden_kw()),
                     ("shallow", cases.shallow_kw())):
        a = cases.advect_kernel_vs_plain(kw, dev)
        out[f"advect_{name}"] = dict(main=a["main"], sub=a["sub"],
                                     obs=a["obs"],
                                     violations=a["diag"]["n_violations"])
        if max(a["main"], a["sub"] or 0.0) > cs.ADVECT_TOL:
            fails.append(f"advect {name}")
        if a["obs"] != (name == "golden"):
            fails.append(f"advect {name} OBS route")
        if a["diag"]["n_violations"] != a["diag_plain"]["n_violations"]:
            fails.append(f"advect {name} CHECKCFL")
    err, _ = cases.golden_kernel_vs_plain(dev)
    out["golden_trajectory"] = dict(err)
    if (err.pop("fl1") > cs.TRAJ_TOL
            or max(err.values()) > cs.TRAJ_STRESS_TOL):
        fails.append("golden trajectory")
    ms, model = cs.o320_model(dev)
    a = cs.advect_check(model, ms.fused, ms.irefra)
    out["o320_advect"] = a[0]
    if a[0] > cs.ADVECT_TOL:
        fails.append("o320 advect")


def _legacy(dev, out, fails):
    """Kernel B's checks with the rest of the physics."""
    import chip_smoke as cs
    from ecwam_tpu_torch.model import cases
    for name in cases.LEGACY_CASES:
        c = cases.legacy_case(name)
        hold = dict(forcing=c["forcing"], phys=c["phys"],
                    gc_width=cs.GC_WIDTH, peak_width=cs.PEAK_WIDTH,
                    off_tol=cs.STRESS_TOL)
        spec, stress, held = cases.physics_kernel_vs_plain(c["kw"], dev,
                                                           **hold)
        f = cases.full_kernel_vs_plain(c["kw"], dev, width=cs.MASK_WIDTH,
                                       **hold)
        worst = max(f["rows"], key=f["rows"].get)
        out[name] = dict(spec=spec, stress=stress, held=held,
                         full_spec=f["spec"], worst=worst,
                         rows=f["rows"][worst], full_held=f["held"],
                         xllws_off=f["off_edge"])
        if spec > cs.PHYS_TOL or f["spec"] > cs.PHYS_TOL:
            fails.append(f"{name} spectrum")
        if stress > cs.STRESS_TOL or f["rows"][worst] > cs.FULL_ROW_TOL:
            fails.append(f"{name} rows")
        if max(held, f["held"]) > 1:
            fails.append(f"{name} rows held")
        if f["off_edge"] > 0:
            fails.append(f"{name} xllws")
    ms, model = cases.o320_legacy(dev)
    model.advance(2)
    r = cs.slice_check(ms, model, dev, True, above_cut=0.0,
                       r0=cs.ice_slice(ms))
    worst = max(r["rows"], key=r["rows"].get)
    out["o320_legacy"] = dict(
        spec=r["spec_rel"], stress=r["stress_rel"], worst=worst,
        rows=r["rows"][worst], n_off=r["n_off"], n_peak=r["n_peak"],
        n_tie=r["n_tie"], xllws_off=r["xllws_off"])
    try:
        cs.check_slice(r, True, "o320 legacy")
    except AssertionError:
        fails.append("o320 legacy slice")


def _shapes(dev, out, fails):
    """Kernel B/C beyond the default build: chip_smoke.py's phase 11,
    which raises at its first check off the limits."""
    import chip_smoke as cs
    try:
        r = cs.shapes_phase(dev)
    except AssertionError as e:
        fails.append(f"shapes: {e}")
        return
    w = r["wide"]
    out["shapes"] = dict(
        switches={k: max(v["rows"].values())
                  for k, v in r["switches"].items()},
        wide=dict(minimal=w["minimal"]["spec_rel"],
                  full=w["full"]["spec_rel"]),
        ustar_options=r["ustar_options"]["stress_rel"],
        ustar_options_storm=r["ustar_options_storm"]["stress_rel"],
        nfre66=r["nfre66"]["full"]["spec"])


CHECKS = dict(full=_full, options=_options, currents=_currents,
              legacy=_legacy, advect=_advect, minimal=_minimal,
              shapes=_shapes)


def prepare(name: str, build_dir: str) -> str:
    """A temporary tree for copy ``name``: the package with its text
    change, the sound build's libraries, chip_smoke.py and the golden
    statistics."""
    kinds, source, text, repl = MUTATIONS[name]
    tmp = tempfile.mkdtemp(prefix=f"kernel_{name}_")
    shutil.copytree(os.path.join(HERE, "ecwam_tpu_torch"),
                    os.path.join(tmp, "ecwam_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copytree(build_dir, os.path.join(tmp, "build", "ecwam_tpu_torch"))
    shutil.copy(os.path.join(HERE, "chip_smoke.py"), tmp)
    os.makedirs(os.path.join(tmp, "tests", "golden"))
    shutil.copy(os.path.join(HERE, "tests", "golden",
                             "statistics_golden.json"),
                os.path.join(tmp, "tests", "golden"))
    if source is not None:
        path = os.path.join(tmp, CSRC, source)
        with open(path) as f:
            src = f.read()
        if src.count(text) != 1:
            raise RuntimeError(f"{name}: the text to change is not in the "
                               "kernel exactly once")
        with open(path, "w") as f:
            f.write(src.replace(text, repl))
    return tmp


def main():
    if sys.argv[1:2] == ["--readings"]:
        sys.path.insert(0, os.getcwd())
        print(json.dumps(readings(sys.argv[2].split(","))), flush=True)
        return
    names = sys.argv[1:] or list(MUTATIONS)
    # the sound libraries, built once here: each copy reuses those whose
    # source it leaves unchanged (a library is keyed by its source)
    sys.path.insert(0, HERE)
    from ecwam_tpu_torch import _build
    _build.build()
    trees = {}
    try:
        for name in names:
            trees[name] = prepare(name, _build.BUILD_DIR)
        # every copy's changed library, built in parallel on the host's
        # cores, then the readings one copy at a time on the card
        build = [sys.executable, "-c",
                 "from ecwam_tpu_torch import _build; _build.build()"]
        waiting, running = list(names), []
        while waiting or running:
            while waiting and len(running) < (os.cpu_count() or 4):
                name = waiting.pop(0)
                running.append((name, subprocess.Popen(
                    build, cwd=trees[name], stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT, text=True)))
            name, p = running.pop(0)
            log, _ = p.communicate()
            if p.returncode != 0:
                raise RuntimeError(f"{name}: build failed\n{log[-3000:]}")
        for name in names:
            res = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--readings",
                 ",".join(MUTATIONS[name][0])],
                cwd=trees[name], capture_output=True, text=True,
                timeout=1200)
            if res.returncode != 0:
                raise RuntimeError(f"{name}:\n{res.stderr[-3000:]}")
            line = json.loads(res.stdout.strip().splitlines()[-1])
            print(json.dumps(dict(kernel=name, **line)), flush=True)
    finally:
        for tmp in trees.values():
            shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
