"""The chunked output-date physics step against the unchunked one and
against ``ecwam_tpu``'s — the counterpart of tests/test_full_chunked.py.

On tests/test_full_chunked.py's configuration (12° grid, 12×15 with 12
advected, random 6–14 m/s winds from seed 3):
  * ``FusedPropagation.phys_srl_full_chunked(chunk=256)`` equals the
    unchunked full step (``full_chunked_rows`` in one chunk) bit for bit
    (plain versions, float32), and its windsea/swell rows equal
    ``sepwisw`` on the unchunked step's outputs and whole-field mask
    (rtol 5e-5, atol 1e-6, as there);
  * the port's ``sepwisw`` matches ``ecwam_tpu.io.products.sepwisw`` on the
    same inputs (rtol 5e-5, atol 1e-6, as there);
  * the port's ``full_chunked_rows`` matches the reference's chunked full
    step on the same float64 SRL state, at tests/test_implsch_pallas.py:
    171-192's bounds: rtol 1e-6 on the spectrum, the stress rows and the
    windsea/swell rows, exact mij.  The reference runs through its XLA
    chain (``test_torch_implsch_full.reference_chain`` on every SRL row,
    then ``sepwisw``), the function its chunked Pallas step computes; the
    reference's own tests
    pin the two together (tests/test_implsch_pallas.py,
    tests/test_full_chunked.py), and interpreting the Pallas kernel here
    cost two minutes of the tier-1 run.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ecwam_tpu.io import products as j_products
from ecwam_tpu.model import fusedstep as j_fused
from ecwam_tpu.ops.physics import implsch_pallas as j_ipk
from ecwam_tpu.model import setup as j_setup
from ecwam_tpu.model import stepper as j_stepper
from ecwam_tpu_torch.io import products as t_products
from ecwam_tpu_torch.model import fusedstep as t_fused
from ecwam_tpu_torch.model import setup as t_setup
from ecwam_tpu_torch.model.stepper import initial_stress
from ecwam_tpu_torch.ops.physics import implsch_cuda as t_ipk
from test_torch_implsch_full import reference_chain

KW = dict(grid_name="12.0", nang=12, nfre=15, nfre_red=12, idelpro=900.0,
          idelt=900.0, pad_to=128)


def _wind(n):
    rng = np.random.default_rng(3)
    return ((6.0 + 8.0 * rng.random(n)).astype(np.float32),
            (rng.random(n) * 2 * np.pi).astype(np.float32))


def _port(dtype):
    """The port's setup, FusedPropagation (plain) and its SRL inputs."""
    ms = t_setup.build_model(dtype=dtype, device="cpu", **KW)
    fp = t_fused.FusedPropagation(ms, plain=True)
    n = ms.n_pad
    ws, wd = _wind(n)
    frc = {k: torch.as_tensor(v, dtype=dtype) for k, v in dict(
        wswave=ws, wdwave=wd, aird=np.full(n, 1.225), wstar=np.zeros(n),
        cicover=np.zeros(n)).items()}
    stress = initial_stress(ms, dict(wswave=frc["wswave"].numpy(),
                                     wdwave=frc["wdwave"].numpy()))
    env2d, denv, frc6, stress6 = fp.build_phys_srl(frc, stress)
    f_srl, tail = fp.initial_srl(ws, wd)
    return ms, fp, (f_srl, stress6, frc6, denv, env2d, tail)


def test_chunked_matches_unchunked_full():
    ms, fp, args = _port(torch.float32)
    f_srl, stress6, frc6, denv, env2d, tail = args
    tb, nsrl = ms.tb, f_srl.shape[0]
    scal = torch.cat([frc6, denv, stress6])
    # unchunked: one chunk over every row, and the whole-field mask
    fu, tu, st_u = t_fused.full_chunked_rows(
        ms.phys, tb, f_srl.clone(), tail.clone(), scal, env2d,
        nang=tb.nang, nfre_red=tb.nfre_red, chunk=nsrl, plain=True)
    _, so_x, _, xllws = t_ipk.implsch_srl_plain(
        ms.phys, f_srl.clone(), env2d, scal, tail.clone(), nang=tb.nang,
        nfre_red=tb.nfre_red, full=True)
    fc, s6c, tc, st_c = fp.phys_srl_full_chunked(
        *(a.clone() for a in args), chunk=256)
    s6u = torch.stack([st_u[k].to(fu.dtype) for k in t_ipk.STRESS_KEYS])
    for got, want in ((fc, fu), (tc, tu), (s6c, s6u)):
        assert torch.equal(got, want)
    assert set(st_c) == set(t_ipk.SCAL_OUT_FULL) | {"sep"}
    for k in t_ipk.SCAL_OUT_FULL:
        assert torch.equal(st_c[k], st_u[k]), k
    assert torch.equal(t_ipk.pack_scal_out(st_u, full=True), so_x)
    # the separation rows equal sepwisw on the unchunked outputs
    fl = torch.cat([fu.reshape(nsrl, tb.nang, tb.nfre_red),
                    tu.reshape(nsrl, tb.nang, tb.nfre - tb.nfre_red)],
                   dim=2).permute(1, 2, 0)
    want = t_products.sepwisw(fl, xllws, env2d[tb.nfre:2 * tb.nfre],
                              st_u["ufric"], frc6[0], frc6[1], tb)
    # (reductions over a chunk and over the whole field may round apart)
    assert tuple(st_c["sep"]) == t_fused.SEP_KEYS
    for k in t_fused.SEP_KEYS:
        np.testing.assert_allclose(st_c["sep"][k].numpy(), want[k].numpy(),
                                   rtol=5e-5, atol=1e-6, err_msg=k)


def test_sepwisw_matches_reference():
    ms, fp, args = _port(torch.float32)
    f_srl, _, _, _, env2d, tail = args
    fu, so, tu, xllws = t_ipk.implsch_srl_plain(
        ms.phys, f_srl.clone(), env2d, torch.cat(args[2:4] + args[1:2]),
        tail.clone(), nang=ms.tb.nang, nfre_red=ms.tb.nfre_red, full=True)
    tb, nsrl = ms.tb, fu.shape[0]
    fl = torch.cat([fu.reshape(nsrl, tb.nang, tb.nfre_red),
                    tu.reshape(nsrl, tb.nang, tb.nfre - tb.nfre_red)],
                   dim=2).permute(1, 2, 0).contiguous()
    ins = (fl, xllws, env2d[tb.nfre:2 * tb.nfre], so[0], args[2][0],
           args[2][1])
    got = t_products.sepwisw(*ins, tb)
    want = j_products.sepwisw(*(jnp.asarray(a.numpy()) for a in ins), tb)
    for k in t_fused.SEP_KEYS + ("swm", "flsw"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=5e-5, atol=1e-6, err_msg=k)


def _reference_full_step(ms, f_srl, tail, scal, env2d, nang, nfre_red):
    """The reference's full step on every SRL row through its XLA chain
    (``test_torch_implsch_full.reference_chain``) and ``sepwisw``:
    (f_srl, tail, state with the SCAL_OUT_FULL rows and ``sep``), as
    ``fusedstep.full_chunked_rows`` returns them."""
    tb = ms.tb
    nfre, nsrl, lt = tb.nfre, f_srl.shape[0], nang * (tb.nfre - nfre_red)
    fl = jnp.concatenate(
        [f_srl.reshape(nsrl, nang, nfre_red),
         tail[:, :lt].reshape(nsrl, nang, nfre - nfre_red)], axis=2)
    out, rows, xllws = reference_chain(
        ms.phys, jnp.transpose(fl, (1, 2, 0)), env2d, scal, True)
    state = j_ipk.unpack_scal_out(rows, full=True)
    sep = j_products.sepwisw(out, xllws, env2d[nfre:2 * nfre],
                             state["ufric"], scal[0], scal[1], tb)
    state["sep"] = {k: sep[k] for k in j_fused.SEP_KEYS}
    out = jnp.transpose(out, (2, 0, 1))
    return (out[:, :, :nfre_red].reshape(nsrl, -1),
            out[:, :, nfre_red:].reshape(nsrl, -1), state)


@pytest.fixture(scope="module")
def reference_state():
    """The reference's float64 SRL state of the configuration and its
    full step (XLA chain, see the module docstring)."""
    ms = j_setup.build_model(dtype=jnp.float64, weights_mode="fused", **KW)
    fp = j_fused.FusedPropagation(ms)
    n = ms.n_pad
    ws, wd = _wind(n)
    frc = dict(wswave=jnp.asarray(ws, jnp.float64),
               wdwave=jnp.asarray(wd, jnp.float64),
               aird=jnp.full(n, 1.225), wstar=jnp.zeros(n),
               cicover=jnp.zeros(n))
    stress = j_stepper.initial_stress(ms, dict(wswave=ws, wdwave=wd))
    env2d, denv, frc6, stress6 = fp.build_phys_srl(frc, stress)
    f_srl, tail = fp.initial_srl(ws, wd)
    ins = dict(f_srl=np.asarray(f_srl), tail=np.asarray(tail),
               scal=np.asarray(jnp.concatenate([frc6, denv, stress6])),
               env2d=np.asarray(env2d))
    res = _reference_full_step(
        ms, f_srl, tail, jnp.concatenate([frc6, denv, stress6]), env2d,
        fp.nang, fp.nfre_red)
    return ms, ins, res


def test_full_chunked_rows_matches_reference(reference_state):
    ms_j, ins, (f_j, t_j, st_j) = reference_state
    ms = t_setup.build_model(dtype=torch.float64, device="cpu", **KW)
    tb = ms.tb
    lt = tb.nang * (tb.nfre - tb.nfre_red)
    t = lambda a: torch.as_tensor(np.array(a))
    f_t, t_t, st_t = t_fused.full_chunked_rows(
        ms.phys, tb, t(ins["f_srl"]), t(ins["tail"][:, :lt]),
        t(ins["scal"]), t(ins["env2d"]), nang=tb.nang,
        nfre_red=tb.nfre_red, chunk=256, plain=True)
    close = dict(rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), **close)
    np.testing.assert_allclose(t_t.numpy(), np.asarray(t_j)[:, :lt], **close)
    np.testing.assert_array_equal(st_t["mij"].numpy(), np.asarray(st_j["mij"]))
    for k in t_ipk.STRESS_KEYS:
        np.testing.assert_allclose(st_t[k].numpy(), np.asarray(st_j[k]),
                                   err_msg=k, **close)
    for k in t_fused.SEP_KEYS:
        np.testing.assert_allclose(st_t["sep"][k].numpy(),
                                   np.asarray(st_j["sep"][k]), err_msg=k,
                                   **close)
