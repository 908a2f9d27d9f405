"""The physics step on SRL rows against the reference's Pallas kernel.

The port's SRL entry (``implsch_cuda.implsch_srl``; on the CPU its plain
version) with the operational split nfre_red < nfre — the diagnostic
tail block beside the SRL state — against ``ecwam_tpu``'s
``implsch_pallas_srl`` in float32, at the reference's bound for its
substituted forms (rtol 2e-2, atol 1e-7, tests/test_implsch_pallas.py:
99-112).  The reference kernel runs through its plain reference, the XLA
chain with the kernel's packed inputs and outputs
(``test_torch_implsch_full.reference_srl``), which the reference's own
tests pin it to; interpreting it here cost minutes of the tier-1 run.  The CUDA kernel is held against
the plain version in tests/test_torch_gpu.py.
"""

import numpy as np
import jax.numpy as jnp
import torch

import test_implsch_pallas as tip
from ecwam_tpu.ops.physics import implsch_pallas as j_ipk
from ecwam_tpu_torch.ops.physics import implsch as t_impl
from ecwam_tpu_torch.ops.physics import implsch_cuda as t_ipk
from test_torch_implsch_full import reference_srl

NANG, NFRE, NFRE_RED, NPTS = 12, 25, 20, 128


def _rows(seed=0):
    """SRL-style rows: a shuffled row map with duplicates, numpy f32."""
    tb, cfg, env, fl1, frc, stress = tip._problem(npts=NPTS, seed=seed)
    src = np.random.default_rng(3).permutation(np.arange(NPTS + 32) % NPTS)
    rows3 = np.asarray(fl1).transpose(2, 0, 1)[src]       # (nsrl, nang, nfre)
    f_srl = rows3[:, :, :NFRE_RED].reshape(len(src), -1)
    tail = rows3[:, :, NFRE_RED:].reshape(len(src), -1)
    env_s = {k: np.asarray(v)[..., src] for k, v in env.items()}
    frc_s = {k: np.asarray(v)[src] for k, v in frc.items()}
    st_s = {k: np.asarray(v)[src] for k, v in stress.items()}
    env2d = np.asarray(j_ipk.pack_env(env_s, NFRE, jnp.float32))
    scal = np.asarray(j_ipk.pack_scal(frc_s, st_s, env_s, len(src),
                                      jnp.float32))
    return tb, cfg, f_srl, tail, env2d, scal


def _port_cfg(tb, cfg):
    return t_ipk.minimal_config(t_impl.make_physics_config(
        tb, cfg.params, idelt=cfg.idelt))


def test_srl_step_matches_interpret_kernel():
    tb, cfg, f_srl, tail, env2d, scal = _rows()
    L, LT = NANG * NFRE_RED, NANG * (NFRE - NFRE_RED)
    res = reference_srl(j_ipk.minimal_config(cfg), f_srl, env2d, scal, tail,
                        nang=NANG, nfre_red=NFRE_RED, full=False)
    f_t, s_t, t_t = t_ipk.implsch_srl(
        _port_cfg(tb, cfg), torch.tensor(f_srl), torch.tensor(env2d),
        torch.tensor(scal), torch.tensor(tail), nang=NANG, nfre_red=NFRE_RED)
    np.testing.assert_allclose(f_t.numpy(), np.asarray(res[0])[:, :L],
                               rtol=2e-2, atol=1e-7)
    np.testing.assert_allclose(t_t.numpy(), np.asarray(res[2])[:, :LT],
                               rtol=2e-2, atol=1e-7)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(res[1])[:6],
                               rtol=2e-2, atol=1e-7)


def test_frcut_tie_marks_the_rows_whose_cut_can_flip():
    """``frcut_tie`` is a distance from x.5 in [0, 0.5]; away from a tie
    the float32 and float64 chains take the same cut."""
    tb, cfg, f_srl, tail, env2d, scal = _rows()
    pcfg = _port_cfg(tb, cfg)
    kw = dict(nang=NANG, nfre_red=NFRE_RED)
    cuts = {}
    for dtype in (torch.float32, torch.float64):
        fl, env, frc, st = t_ipk.srl_inputs(
            pcfg, *(torch.tensor(a, dtype=dtype)
                    for a in (f_srl, env2d, scal, tail)), **kw)
        cuts[dtype] = t_impl.implsch(pcfg, fl, env, frc, *st)[1]["mij"]
    tie = t_ipk.frcut_tie(pcfg, *(torch.tensor(a, dtype=torch.float64)
                                  for a in (f_srl, env2d, scal, tail)), **kw)
    assert tie.shape == (f_srl.shape[0],)
    assert float(tie.min()) >= 0.0 and float(tie.max()) <= 0.5
    away = tie > 1e-3
    assert int(away.sum()) > 0.9 * f_srl.shape[0]
    assert torch.equal(cuts[torch.float32][away], cuts[torch.float64][away])


def test_physics_state_repeats_the_rows_in_order():
    """``cases.physics_state(rows=n)`` repeats the SRL rows in order, so
    that the card tests reach a row count that is a multiple of neither
    the kernel's rows a warp nor its warps a block; the kernel-vs-plain
    helpers take it (on the CPU both sides run the plain version)."""
    from ecwam_tpu_torch.model import cases
    _, whole = cases.physics_state(cases.shallow_kw(), "cpu")
    n = whole[0].shape[0]
    _, cut = cases.physics_state(cases.shallow_kw(), "cpu", rows=n + 13)
    assert cut[0].shape[0] == n + 13 and cut[3] is None
    assert torch.equal(cut[0][:n], whole[0])
    assert torch.equal(cut[0][n:], whole[0][:13])
    for i in (1, 2):
        assert torch.equal(cut[i][:, n:], whole[i][:, :13])
    spec, stress, held = cases.physics_kernel_vs_plain(
        cases.shallow_kw(), "cpu", rows=n + 13)
    assert spec == 0.0 and stress == 0.0 and held == 0
