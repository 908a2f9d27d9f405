"""The physics shapes kernel B/C takes beyond the default build, in the
port's plain chain against ``ecwam_tpu`` (its XLA chain) on the CPU.

On the inputs of tests/test_implsch_pallas.py:_problem (numpy, seed 0):
  * u* forcing (ICODE 1 and 2) with the cycle-50r1 options (LLGCBZ0,
    LLNORMAGAM, LLCAPCHNK, LCIWA3, LCISCAL) under 3–40 m/s incoming winds,
    full mode for both codes and minimal mode for ICODE 1: float64, rtol
    1e-10 (the tolerance of test_torch_physics_options.py);
  * 72 directions (128 points), minimal and full mode, through the
    compact and the SRL entries' plain versions: float64 rtol 1e-10, and
    the float32 chain in full mode at test_torch_physics_options.py's
    float32 limits, 1e-5 of each field's maximum against the reference's
    float32 chain and 1e-6 of the spectrum's against its float64 one;
  * full mode with LCFLX, LSTOKES or LWVFLX_SNL off, and at 66
    frequencies: float64, rtol 1e-10; the rows a switch turns off pack as
    zero;
and the dense ``WaveModel`` under u* forcing with iphys=0 and ISNONLIN=2,
2 steps on the 12° aqua grid (12×25) in float64 against the reference's
at 1e-10, as tests/test_torch_wavemodel_forcing.py's u* case.  Each
configuration is one ``kernel_supports`` accepts, on the build of
csrc/implsch.cu that ``implsch_cuda.library`` picks for it; the refusals
left are checked last.
"""

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import test_implsch_pallas as tip
from ecwam_tpu.core import physparams as j_pp
from ecwam_tpu.model import driver as jdrv
from ecwam_tpu.model import setup as jsetup
from ecwam_tpu.ops.physics import implsch as j_impl
from ecwam_tpu_torch.core import physparams as t_pp
from ecwam_tpu_torch.core.spectral import build_spectral_tables as t_tables
from ecwam_tpu_torch.model import cases
from ecwam_tpu_torch.model import driver as tdrv
from ecwam_tpu_torch.model import setup as tsetup
from ecwam_tpu_torch.ops.physics import implsch as t_impl
from ecwam_tpu_torch.ops.physics import implsch_cuda as t_ipk
from test_torch_wavemodel import _assert_same

CY50R1 = (dict(lciwa3=True, lciscal=True), cases.CY49R1)
# name: (nang, nfre, points, PhysicsConfig keywords, parameter flags)
SHAPES = {
    "ustar1_cy50r1": (12, 25, 48, dict(CY50R1[0], icode_wnd=1), CY50R1[1]),
    "ustar2_cy50r1": (12, 25, 48, dict(CY50R1[0], icode_wnd=2), CY50R1[1]),
    "nang72": (72, 25, 128, {}, {}),
    "nang144": (144, 25, 64, {}, {}),
    "no_lcflx": (12, 25, 48, dict(lcflx=False), {}),
    "no_lstokes": (12, 25, 48, dict(lstokes=False), {}),
    "no_lwvflx_snl": (12, 25, 48, dict(lwvflx_snl=False), {}),
    "nfre66": (12, 66, 48, {}, {}),
}


class Problem:
    """One shape's inputs in float64 numpy and both packages' configs."""

    def __init__(self, name):
        nang, nfre, npts, extra, flags = SHAPES[name]
        tb, _, env, fl1, frc, stress = tip._problem(nang=nang, nfre=nfre,
                                                    npts=npts)
        f64 = lambda d: {k: np.asarray(v, np.float64) for k, v in d.items()}
        self.tb_t = t_tables(nang=nang, nfre=nfre)
        self.fl = np.asarray(fl1, np.float64)
        self.env, self.frc, self.stress = f64(env), f64(frc), f64(stress)
        if extra.get("icode_wnd", 3) != 3:
            # the incoming U10 reaches CHNKMIN and RNFAC above ≈ 25 m/s
            self.frc["wswave"] = np.linspace(3.0, 40.0, npts)
        self.cj = j_impl.make_physics_config(
            tb, j_pp.set_phys_params(iphys=1, nang=nang, **flags),
            idelt=900.0, **extra)
        self.ct = t_impl.make_physics_config(
            self.tb_t, t_pp.set_phys_params(iphys=1, nang=nang, **flags),
            idelt=900.0, **extra)


@functools.lru_cache(maxsize=None)
def _problem(name):
    return Problem(name)


@functools.lru_cache(maxsize=None)
def _chain(name, full, dtype):
    """(port fl1, port state, reference fl1, reference state) of one
    IMPLSCH step, the port through the compact entry's plain version."""
    p = _problem(name)
    cj, ct = p.cj, p.ct
    if not full:
        cj = dataclasses.replace(cj, lcflx=False, lstokes=False)
        ct = t_ipk.minimal_config(ct)
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    j = lambda d: {k: jnp.asarray(v, jdt) for k, v in d.items()}
    out_j, st_j = jax.jit(lambda fl, e, fr, s: j_impl.implsch(
        cj, fl, e, fr, **s))(jnp.asarray(p.fl, jdt), j(p.env), j(p.frc),
                             j(p.stress))
    t = lambda a: torch.tensor(np.asarray(a), dtype=dtype)
    out_t, st_t = t_impl.implsch(
        ct, t(p.fl), {k: t(v) for k, v in p.env.items()},
        {k: t(v) for k, v in p.frc.items()},
        *(t(p.stress[k]) for k in t_ipk.STRESS_KEYS))
    return out_t, st_t, np.asarray(out_j), {k: np.asarray(v)
                                            for k, v in st_j.items()}


def _same_f64(name, full):
    out_t, st_t, out_j, st_j = _chain(name, full, torch.float64)
    np.testing.assert_allclose(out_t.numpy(), out_j, rtol=1e-10,
                               atol=1e-10 * np.abs(out_j).max())
    for k, v in st_j.items():
        np.testing.assert_allclose(st_t[k].numpy(), v, rtol=1e-10,
                                   atol=1e-14, err_msg=k)
    return st_t, st_j


def _accepted(name, full):
    cfg = _problem(name).ct
    cfg = cfg if full else t_ipk.minimal_config(cfg)
    t_ipk.kernel_supports(cfg, full, compact=True)
    return cfg


@pytest.mark.parametrize("name,full", [("ustar1_cy50r1", True),
                                       ("ustar1_cy50r1", False),
                                       ("ustar2_cy50r1", True)])
def test_ustar_with_options_matches_reference_f64(name, full):
    cfg = _accepted(name, full)
    bits = t_ipk.option_bits(cfg, full)
    assert bits & t_ipk.UST_BIT and bits & 31 == 31
    assert not bits & t_ipk.EXT_BITS
    st_t, st_j = _same_f64(name, full)
    # U10 from the log profile feeds the chain and leaves as one more row
    assert "wswave" in st_t and "z0_margin" in st_t
    so = t_ipk.pack_scal_out(st_t, full=full)
    assert so.shape[0] == len(t_ipk.out_keys(cfg, full))
    assert torch.equal(so[-1], st_t["wswave"])
    assert t_ipk.unpack_scal_out(so, full=full).keys() == set(
        t_ipk.out_keys(cfg, full))
    with pytest.raises(NotImplementedError, match="icode_wnd"):
        t_ipk.kernel_supports(cfg, full)             # the SRL entry


@pytest.mark.parametrize("full", [False, True])
def test_144_directions_match_reference_f64(full):
    """Past 128 directions (the wide build's further passes): the plain
    chain against the reference's, float64 rtol 1e-10."""
    cfg = _accepted("nang144", full)
    t_ipk.kernel_supports(cfg, full)                 # the SRL entry too
    assert t_ipk.library(cfg, full) == t_ipk.WIDE_LIB
    _same_f64("nang144", full)


@pytest.mark.parametrize("full", [False, True])
def test_72_directions_match_reference_f64(full):
    cfg = _accepted("nang72", full)
    t_ipk.kernel_supports(cfg, full)                 # the SRL entry too
    assert t_ipk.library(cfg, full) == t_ipk.WIDE_LIB
    _same_f64("nang72", full)
    # the SRL entry's plain version: the compact entry's step on rows
    p = _problem("nang72")
    nang, nfre, n = p.fl.shape
    nred = p.ct.nfre_red
    fl1 = torch.tensor(p.fl)
    rows = fl1.permute(2, 0, 1)
    f_srl = rows[:, :, :nred].reshape(n, -1).contiguous()
    tail = rows[:, :, nred:].reshape(n, -1).contiguous()
    env2d = torch.cat([torch.tensor(p.env[k]) for k in t_ipk.ENV_FIELDS])
    scal = torch.stack([torch.tensor({**p.frc, **p.stress, **p.env}[k])
                        for k in t_ipk.SCAL_IN])
    res = t_ipk.implsch_srl_plain(cfg, f_srl, env2d, scal,
                                  tail if nred < nfre else None, nang=nang,
                                  nfre_red=nred, full=full)
    want = t_ipk.implsch_compact_plain(cfg, fl1, env2d, scal, full=full)
    got = torch.cat([res[0].reshape(n, nang, nred)]
                    + ([res[2].reshape(n, nang, nfre - nred)]
                       if nred < nfre else []), dim=2).permute(1, 2, 0)
    assert torch.equal(got, want[0]) and torch.equal(res[1], want[1])
    if full:
        assert torch.equal(res[3], want[2])


def test_72_directions_match_reference_f32():
    """The port's float32 chain in full mode: its fields against the
    reference's float32 chain at 1e-5 of each field's maximum, its
    spectrum against the reference's float64 one at 1e-6 — at 72
    directions the reference's own float32 spectrum reads 1.7e-6 off its
    float64 (the port's 5e-7), past the 1e-6 that two float32 chains keep
    at 12 directions, while the fields that TAUT_Z0 and the flux ratios
    amplify (chrnck 1.3e-4, phiaw, phieps, tauoc 1–2e-5) are as far off
    float64 in either float32 chain."""
    out_t, st_t, _, st_j = _chain("nang72", True, torch.float32)
    _, _, out_j, _ = _chain("nang72", True, torch.float64)
    np.testing.assert_allclose(out_t.numpy(), out_j, rtol=0.0,
                               atol=1e-6 * np.abs(out_j).max())
    for k, v in st_j.items():
        v = np.asarray(v, np.float64)
        np.testing.assert_allclose(
            st_t[k].numpy().astype(np.float64), v, rtol=0.0,
            atol=1e-5 * max(np.abs(v).max(), 1e-30), err_msg=k)


OFF_ROWS = {"no_lcflx": ("tauxd", "tauyd", "tauocxd", "tauocyd", "tauoc",
                         "phiocd", "phieps", "phiaw", "em_oc", "f1_oc"),
            "no_lstokes": ("ustokes", "vstokes", "strnms"),
            "no_lwvflx_snl": ()}


@pytest.mark.parametrize("name", sorted(OFF_ROWS))
def test_full_mode_switches_match_reference_f64(name):
    cfg = _accepted(name, True)
    t_ipk.kernel_supports(cfg, True)
    bit = 1 << t_ipk.OPT_FLAGS.index(name)
    # a full-mode bit of the EXT instantiations; minimal mode ignores it
    assert t_ipk.option_bits(cfg, True) == bit and bit & t_ipk.EXT_BITS
    assert bit & t_ipk.MODE_BITS
    assert t_ipk.option_bits(t_ipk.minimal_config(cfg)) == 0
    st_t, st_j = _same_f64(name, True)
    so = t_ipk.pack_scal_out(st_t, full=True)
    for k in OFF_ROWS[name]:
        assert k not in st_t and k not in st_j
        assert not bool(so[t_ipk.SCAL_OUT_FULL.index(k)].any()), k
    if name == "no_lwvflx_snl":
        assert "phiocd" in st_t                      # the fluxes computed


def test_66_frequencies_full_mode_match_reference_f64():
    cfg = _accepted("nfre66", True)
    assert t_ipk.library(cfg, True) == t_ipk.WIDE_LIB
    assert t_ipk.library(t_ipk.minimal_config(cfg), False) == "implsch"
    _same_f64("nfre66", True)


@pytest.mark.parametrize("icode", [1])
def test_ustar_legacy_wavemodel_matches_reference(icode):
    """u* forcing with iphys=0 (Janssen's input, the cycle-4 dissipation)
    and ISNONLIN=2 through the dense WaveModel."""
    kw = dict(grid_name="12.0", nang=12, nfre=25, idelpro=900.0,
              idelt=900.0, pad_to=64, icode_wnd=icode, weights_mode="cached",
              iphys=0, isnonlin=2)
    ms_j = jsetup.build_model(dtype=jnp.float64, **kw)
    ms_t = tsetup.build_model(dtype=torch.float64, device="cpu", **kw)
    t_ipk.kernel_supports(ms_t.phys, True, compact=True)
    assert t_ipk.option_bits(ms_t.phys, True) & t_ipk.EXT_BITS
    n = ms_t.n_real
    rng = np.random.default_rng(icode)
    us = 0.3 + 0.3 * rng.random(n)

    def prov(date14):
        return dict(wswave=np.zeros(n), wdwave=np.ones(n),
                    aird=np.full(n, 1.225), wstar=np.zeros(n),
                    cicover=np.zeros(n), ufric=us)
    m_j = jdrv.WaveModel(ms_j, prov, cases.START)
    m_t = tdrv.WaveModel(ms_t, prov, cases.START)
    for m in (m_j, m_t):
        m.newwind(m.date)
    m_j.advance(2)
    m_t.advance(2)
    u10 = m_t.state["wswave"][:n].numpy()
    assert ((u10 > 1.0) & (u10 < 30.0)).all()
    _assert_same(m_t, m_j)


def test_remaining_refusals():
    p = _problem("ustar1_cy50r1")
    # u* forcing on the SRL entry (the fast path takes U10, see ROADMAP)
    with pytest.raises(NotImplementedError, match="icode_wnd"):
        t_ipk.kernel_supports(p.ct, True)
    with pytest.raises(ValueError, match="ISNONLIN"):
        t_ipk.kernel_supports(dataclasses.replace(p.ct, isnonlin=3),
                              compact=True)
    # every other configuration of this file, and 128, 136, 144 and 256
    # directions, pass (the wide build walks the directions past 128 in
    # further passes); the row's bytes of shared memory are the limit
    for name in SHAPES:
        if not name.startswith("ustar"):
            t_ipk.kernel_supports(_problem(name).ct, True)

    def cfg_of(nang, nfre=36):
        return t_impl.make_physics_config(
            t_tables(nang=nang, nfre=nfre),
            t_pp.set_phys_params(iphys=1, nang=nang), idelt=900.0)
    for nang in (128, 136, 144, 256):
        cfg = cfg_of(nang)
        for full in (False, True):
            t_ipk.kernel_supports(cfg if full else t_ipk.minimal_config(cfg),
                                  full)
            t_ipk.kernel_supports(cfg, full, compact=True)
            assert t_ipk.library(cfg, full) == t_ipk.WIDE_LIB
    # at 36 frequencies the block's 227 KB hold 461 directions' row and
    # tables in minimal mode and 453 in full mode (the windsea mask and
    # the flux sums); one more is refused by its bytes
    for nang, full in ((461, False), (453, True)):
        cfg = cfg_of(nang)
        cfg = cfg if full else t_ipk.minimal_config(cfg)
        t_ipk.kernel_supports(cfg, full)
        assert t_ipk.shared_bytes(cfg, full) <= t_ipk.SMEM_BLOCK
        big = cfg_of(nang + 1)
        big = big if full else t_ipk.minimal_config(big)
        need = t_ipk.shared_bytes(big, full)
        assert need > t_ipk.SMEM_BLOCK
        with pytest.raises(NotImplementedError,
                           match=f"takes {need} bytes of shared memory"):
            t_ipk.kernel_supports(big, full)


def test_every_build_the_wrapper_picks_is_built():
    """Each configuration and entry goes to one of the libraries that
    ``_build`` compiles (csrc/implsch.cu's four builds)."""
    from ecwam_tpu_torch import _build
    seen = set()
    for name in SHAPES:
        cfg = _problem(name).ct
        for full in (False, True):
            for compact in (False, True):
                lib = t_ipk.library(cfg, full, compact)
                assert lib in _build.SOURCES, lib
                assert lib.endswith("_compact") == compact
                src, flags = _build.source_and_flags(lib)
                assert src.endswith("implsch.cu")
                assert ("-DIMPLSCH_WIDE" in flags) == lib.startswith(
                    t_ipk.WIDE_LIB)
                seen.add(lib)
    assert seen == {n for n in _build.SOURCES if n.startswith("implsch")}


def _o640_physics(**kw):
    """The o640_oper cell's physics: 36 directions × 36 frequencies, the
    default options (the DIA ladder to mlsthg 40)."""
    return t_impl.make_physics_config(
        t_tables(nang=36, nfre=36), t_pp.set_phys_params(iphys=1, nang=36),
        idelt=450.0, **kw)


@pytest.mark.parametrize("nang,nfre", [(36, 36), (12, 25), (72, 25)])
def test_dia_step_records_hold_each_step(nang, nfre):
    """SNONLIN's record of step j holds rnl[:, j], af11[j] and the nine
    index entries of j, in csrc/implsch.cu's order, in whole 16-byte words
    and at a 16-byte boundary of the staged tables; the packed table
    carries them where ``implsch_launch`` reads them."""
    cfg = t_impl.make_physics_config(
        t_tables(nang=nang, nfre=nfre),
        t_pp.set_phys_params(iphys=1, nang=nang), idelt=900.0)
    dia = cfg.dia
    ml = int(dia.mlsthg)
    names = t_ipk.DIA_RECORD
    assert len(names) % 4 == 0 and t_ipk.DIA_TAP_REC % 4 == 0
    assert names[t_ipk.DIA_TAP_REC - 1] is None
    assert names.count(None) == 1
    want = {f"rnl{i}" for i in range(25)} | {"af11"} | set(t_ipk.DIA_INTS)
    assert set(names) - {None} == want and len(names) == len(want) + 1
    rec = t_ipk.dia_records(dia)
    assert rec.shape == (ml, len(names)) and rec.dtype == np.float32
    ints = rec.view(np.int32)
    rnl = np.asarray(dia.rnl, np.float64)
    for j in range(ml):
        for i in range(25):
            assert rec[j, names.index(f"rnl{i}")] == np.float32(rnl[i, j])
        assert rec[j, names.index("af11")] == np.float32(dia.af11[j])
        for n in t_ipk.DIA_INTS:
            assert ints[j, names.index(n)] == int(getattr(dia, n)[j]), n
        assert ints[j, t_ipk.DIA_TAP_REC - 1] == 0
    for full in (False, True):
        c = cfg if full else t_ipk.minimal_config(cfg)
        assert t_ipk.smem_layout(c, full)["dia"] % 4 == 0
    tab = t_ipk.pack_tables(cfg, "cpu")["tab"].numpy()
    at = (len(t_ipk.PAR_NAMES) + t_ipk.NFREQTAB * nfre + 3 * nang
          + nang * nang + t_ipk.tables.tabu_swellft().shape[0] + t_ipk.JTOT
          + len(t_ipk.GC_TABLES) * int(t_ipk.gc_mod.gc_tables().nwav))
    np.testing.assert_array_equal(
        tab[at:at + rec.size].view(np.int32), rec.reshape(-1).view(np.int32))


def test_pack_tables_refuses_dia_steps_it_cannot_pipeline():
    """Coinciding target frequencies in a step (the kernel reads every old
    value before it writes), and a step whose ikm1/ikp1 are not the next
    step's ikm/ikp (the kernel keeps those bins from one step to the
    next), are refused."""
    cfg = _o640_physics()
    dia = cfg.dia
    t_ipk.pack_tables(cfg, "cpu")
    same = dataclasses.replace(cfg, dia=dataclasses.replace(
        dia, ikp1=np.asarray(dia.ikp).copy()))
    with pytest.raises(ValueError, match="target frequencies differ"):
        t_ipk.pack_tables(same, "cpu")
    ikm1 = np.asarray(dia.ikm1).copy()
    ikm1[5] = -50                       # off the ladder: no coincidence
    apart = dataclasses.replace(cfg, dia=dataclasses.replace(dia, ikm1=ikm1))
    with pytest.raises(ValueError, match="next step's ikm and ikp"):
        t_ipk.pack_tables(apart, "cpu")


def _block_rows(cfg, full) -> int:
    """The rows (warps) a block of kernel B takes, as csrc/implsch.cu's
    ``launch`` finds them: as many as SMEM_BLOCK holds beside the tables,
    at most 12 (the wide build 8), 16 banks apart where that costs none."""
    lay = t_ipk.smem_layout(cfg, full)
    most = 8 if t_ipk.library(cfg, full) == t_ipk.WIDE_LIB else 12

    def fit(stride):
        return min((t_ipk.SMEM_BLOCK - 4 * lay["table"]) // (4 * stride),
                   most)
    rf = lay["row"]
    return fit(rf if fit(rf + 16) < fit(rf) else rf + 16)


@pytest.mark.parametrize("options", [False, True])
@pytest.mark.parametrize("full", [False, True])
def test_o640_oper_block_holds_twelve_rows(full, options):
    """At the o640_oper cell's 36×36 (mlsthg 40) a block of kernel B holds
    12 rows (warps) beside its tables in minimal and full mode, the
    default and the cycle-50r1 instantiation alike."""
    cfg = _o640_physics(**(dict(lciwa3=True, lciscal=True) if options
                           else {}))
    if options:
        cfg = dataclasses.replace(cfg, params=t_pp.set_phys_params(
            iphys=1, nang=36, **cases.CY49R1))
    cfg = cfg if full else t_ipk.minimal_config(cfg)
    assert int(cfg.dia.mlsthg) == 40
    assert t_ipk.library(cfg, full) == "implsch"
    assert bool(t_ipk.option_bits(cfg, full)) == options
    lay = t_ipk.smem_layout(cfg, full)
    assert _block_rows(cfg, full) == 12
    assert 4 * (lay["table"] + 12 * lay["row"]) <= t_ipk.SMEM_BLOCK
