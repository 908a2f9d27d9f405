"""``FusedPropagation.phys_srl_chunked`` of the port against the
reference's, on the CPU (kernel B's plain version):

  * tests/test_fused.py:153's comparison in float64 (12°, 12×25, chunks
    of 64 points): the SRL-resident step equals the compact round trip
    (the reference's ``from_srl`` → chunked IMPLSCH → ``to_srl``) and the
    reference's own ``phys_srl_chunked``, spectrum and stress at rtol
    1e-11, at the real points;
  * the port's ``phys_srl`` on all rows, float32, without and with a tail
    (20 of 25 frequencies advected): in one chunk of all the points the
    canonical rows, the tail and the six stress fields equal bit for bit
    (the same chain row by row); in chunks of 64, which do not divide the
    points, within 1e-6 of each field's largest value (the plain chain's
    vectorised CPU reductions round by the batch's size; the card's
    kernel is held bit for bit by chip_smoke.py); the wrap slots
    refreshed from the canonical rows, every row finite.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecwam_tpu.model import preset as j_preset
from ecwam_tpu.model import setup as j_setup
from ecwam_tpu.model import stepper as j_stepper
from ecwam_tpu.model.fusedstep import FusedPropagation as JFused
from ecwam_tpu_torch.model import driver, setup as t_setup
from ecwam_tpu_torch.model.fusedstep import FusedPropagation
from ecwam_tpu_torch.ops.physics import implsch_cuda as ipk

KW = dict(grid_name="12.0", nang=12, nfre=25, idelpro=900.0, idelt=900.0,
          pad_to=64, weights_mode="fused", phys_chunk=64)


def _forcing(n, seed=3):
    rng = np.random.default_rng(seed)
    return dict(wswave=8.0 + 4.0 * rng.random(n),
                wdwave=rng.random(n) * 2.0 * np.pi,
                aird=np.full(n, 1.225), wstar=np.zeros(n),
                cicover=np.zeros(n))


def test_matches_reference_compact_round_trip():
    ms_j = j_setup.build_model(dtype=jnp.float64, **KW)
    ms_t = t_setup.build_model(dtype=torch.float64, device="cpu", **KW)
    n = ms_j.n_pad
    raw = _forcing(n)
    frc_j = {k: jnp.asarray(v, ms_j.dtype) for k, v in raw.items()}
    frc_t = {k: torch.as_tensor(v) for k, v in raw.items()}
    wind = dict(wswave=raw["wswave"], wdwave=raw["wdwave"])
    stress_j = j_stepper.initial_stress(ms_j, wind)
    stress_t = {k: torch.as_tensor(np.array(v))
                for k, v in stress_j.items()}
    env_j = {k: ms_j.env[k] for k in j_stepper.ENV_KEYS}
    fl1 = j_preset.mstart(ms_j.tb, raw["wswave"], raw["wdwave"])

    fj = JFused(ms_j, backend="xla")
    out_j, st_j = fj.phys_srl_chunked(fj.to_srl(jnp.asarray(fl1), fj.bundle),
                                      frc_j, stress_j, env_j, fj.bundle,
                                      chunk=64)
    via_j = np.asarray(fj.from_srl(out_j, fj.bundle))
    want, st_want = j_stepper._chunked_implsch(ms_j, jnp.asarray(fl1),
                                               env_j, frc_j, stress_j)

    fp = FusedPropagation(ms_t)
    f_srl = fp.to_srl(torch.as_tensor(fl1))
    out_t, st_t = fp.phys_srl_chunked(f_srl, frc_t, stress_t, ms_t.env,
                                      chunk=64)
    assert out_t is f_srl                        # written in place
    got = fp.from_srl(out_t).numpy()
    nr = ms_j.n_real            # pad points are don't-care in SRL mode
    for w in (np.asarray(want), via_j):
        np.testing.assert_allclose(got[..., :nr], w[..., :nr], rtol=1e-11,
                                   atol=1e-13)
    assert set(st_t) == set(st_j) == set(ipk.STRESS_KEYS)
    for k in st_t:
        for w in (st_want[k], st_j[k]):
            np.testing.assert_allclose(st_t[k].numpy()[:nr],
                                       np.asarray(w)[:nr], rtol=1e-11,
                                       err_msg=k)


def _same(got, want, tol):
    if tol == 0.0:
        assert torch.equal(got, want)
    else:
        assert float((got - want).abs().max()) <= tol * float(
            want.abs().max())


@pytest.mark.parametrize("nfre_red,chunk", [(25, 4096), (20, 4096),
                                            (25, 64), (20, 64)])
def test_equals_phys_srl_on_all_rows(nfre_red, chunk):
    ms = t_setup.build_model(dtype=torch.float32, device="cpu",
                             **{**KW, "nfre_red": nfre_red})
    raw = _forcing(ms.n_real, seed=5)
    m = driver.FastWaveModel(ms, lambda d: raw, "20230101000000")
    m.advance(2)                                 # a developed state
    fp = m.fp
    args = (m._f_srl, m._stress6, m._frc6, m._denv, m._env2d, m._tail)
    f_all, s_all, t_all = fp.phys_srl(*(a.clone() if a is not None
                                        else None for a in args))
    f_srl = m._f_srl.clone()
    tail = m._tail.clone() if m._tail is not None else None
    out = fp.phys_srl_chunked(f_srl, m.frc, m.stress, ms.env, chunk=chunk,
                              tail=tail)
    acc = out[-1]
    rows = fp.from_srl_pad[:ms.n_real]
    tol = 0.0 if chunk >= ms.n_real else 1e-6
    _same(out[0][rows], f_all[rows], tol)
    if tail is not None:
        assert len(out) == 3
        _same(out[1][rows], t_all[rows], tol)
    for i, k in enumerate(ipk.STRESS_KEYS):
        _same(acc[k][:ms.n_real], s_all[i][rows], tol)
        assert torch.equal(acc[k][ms.n_real:],
                           acc[k][:1].expand(ms.n_pad - ms.n_real))
    wp, wf = fp.tabs["wrap_pos"], fp.tabs["wrap_from"]
    assert torch.equal(f_srl[wp], f_srl[wf])
    assert bool(torch.isfinite(f_srl).all())
    with pytest.raises(ValueError, match="minimal-mode"):
        fp.phys_srl_chunked(f_srl, m.frc, m.stress, ms.env, chunk=chunk,
                            tail=tail, state_keys=("ufric", "emean"))
