"""Per-card memory of the sharded kernel-architecture model at O1280/4.

The port's counterpart of tests/test_hbm_budget.py.  It builds the real
sharded fused model (``parallel.sharded.FusedShardedModel``) at the
operational spectrum (36 directions, 36/29 frequencies) on a small grid
on the CPU, takes every tensor a shard holds — its tables, the physics
env rows, the stress and forcing rows, the spectrum and tail rows — and
sorts them into bytes per SRL row and bytes per own point (each is a
(rows, k) or (k, rows) array, so the scaling is exact).  It adds the
step's transients (kernel A's output, one more spectrum; full mode's
65,536-row chunk: the windsea mask and about four chunk spectra of the
separation) and scales to the worst shard of a 4-way row-band split of
the real O1280 octahedral rows (``core.grid``, all sea), with the SRL
rule of ``ops.propagation_fused.build_fused_tables``.  The projection
must fit an 80 GB card with a tenth to spare; O1280 on one card (the
four shards' rows) must not, which is why it is a four-card cell.
"""

import numpy as np
import torch

from ecwam_tpu_torch.core import grid as grid_mod
from ecwam_tpu_torch.model import preset
from ecwam_tpu_torch.model import setup as tsetup
from ecwam_tpu_torch.model import stepper as tstepper
from ecwam_tpu_torch.parallel import decomp, multihost, sharded

CARD_BYTES = 80e9
NANG, NFRE, NFRE_RED = 36, 36, 29
CHUNK = 65536


def _seg_size(ngx: int) -> int:
    """The segment size of setup.build_model."""
    return 1 << max(4, min(7, int(np.log2(max(16, ngx // 4)))))


def o1280_shards(n_shards=4):
    """(rows of the worst shard, its own points, SRL rows of the whole
    grid) of an ``n_shards``-way row-band split of O1280, all sea."""
    g = grid_mod.octahedral_grid(1280)
    cnt = np.asarray(g.nlonrgg, np.int64)
    S = _seg_size(int(g.ngx))
    zd = 360.0 / cnt
    ratio = np.ones(cnt.size)
    ratio[1:] = np.maximum(ratio[1:], zd[1:] / zd[:-1])
    ratio[:-1] = np.maximum(ratio[:-1], zd[:-1] / zd[1:])
    WD = int(min(max(int(np.ceil(ratio.max())) + 2, 3), 12))
    row_len = ((cnt + 2 * WD + S - 1) // S) * S
    row_start = np.concatenate([[0], np.cumsum(cnt)[:-1]])
    npts = int(cnt.sum())
    cuts = decomp.row_cuts(row_start, npts, n_shards)
    row_of = np.searchsorted(row_start, cuts[:-1], side="right") - 1
    worst_rows = worst_pts = 0
    for s in range(n_shards):
        k0 = int(row_of[s])
        k1 = (int(row_of[s + 1]) if s + 1 < n_shards else cnt.size)
        lo, hi = max(k0 - 1, 0), min(k1 + 1, cnt.size)
        worst_rows = max(worst_rows, int(row_len[lo:hi].sum()) + 3 * S)
        worst_pts = max(worst_pts, int(cuts[s + 1] - cuts[s]))
    return worst_rows, worst_pts, int(row_len.sum()) + 3 * S


def _shard_bytes():
    """(bytes per SRL row, bytes per own point) a shard holds."""
    ms = tsetup.build_model(grid_name="6.0", nang=NANG, nfre=NFRE,
                            nfre_red=NFRE_RED, idelpro=450.0, idelt=900.0,
                            pad_to=64, device="cpu")
    sm = sharded.build_sharded_model(ms, multihost.make_point_mesh(["cpu"]
                                                                    * 2))
    rng = np.random.default_rng(0)
    n = ms.n_pad
    frc = dict(wswave=8.0 + 4.0 * rng.random(n),
               wdwave=rng.random(n) * 2 * np.pi, aird=np.full(n, 1.225),
               wstar=np.zeros(n), cicover=np.zeros(n))
    fl1 = np.asarray(preset.mstart(ms.tb, frc["wswave"], frc["wdwave"]))
    rows, tail = sm.put_rows(fl1)
    s6 = sm.put_stress6({k: v.numpy() for k, v in
                         tstepper.initial_stress(ms, frc).items()})
    frc6 = sm.put_forcing(frc)
    nsrl, size = sm.fused_shard_tables.nsrl_loc, sm.size
    assert nsrl != size
    fp = sm.fps[0]
    held = [v for v in fp.tabs.values() if isinstance(v, torch.Tensor)]
    held += [fp.from_srl_pad, sm._env2d[0], sm._denv[0], sm._own_src[0],
             sm._masks[0], rows[0], tail[0], s6[0], frc6[0]]
    per_row = per_pt = 0.0
    for t in held:
        if nsrl in t.shape:
            per_row += t.numel() * t.element_size() / nsrl
        elif size in t.shape:
            per_pt += t.numel() * t.element_size() / size
        else:
            assert t.numel() < 10_000, tuple(t.shape)   # lane constants
    return per_row, per_pt, rows[0].shape[1] * 4


def test_o1280_four_shard_kernel_arch_fits_a_card():
    per_row, per_pt, spec_row = _shard_bytes()
    rows, pts, total_rows = o1280_shards(4)
    assert 1.6e6 < rows < 1.8e6 and total_rows > 6.7e6
    resident = rows * per_row + pts * per_pt
    advect_out = rows * spec_row                  # kernel A's output
    full_chunk = NANG * NFRE * CHUNK * 4 * 5      # mask + separation temps
    total = resident + advect_out + full_chunk
    report = (f"O1280/4 worst shard: {rows} SRL rows, {pts} points; "
              f"{per_row:.0f} B a row + {per_pt:.0f} B a point resident "
              f"= {resident / 1e9:.2f} GB, kernel A's output "
              f"{advect_out / 1e9:.2f} GB, full-mode chunk "
              f"{full_chunk / 1e9:.2f} GB -> {total / 1e9:.2f} GB "
              f"({total / rows / 1e3:.1f} KB a row)")
    print(report)
    assert total < 0.9 * CARD_BYTES, report
    # all of O1280 on one card does not fit: the cell needs four
    one_card = (total_rows * (per_row + spec_row) + 6.6e6 * per_pt
                + full_chunk)
    assert one_card > CARD_BYTES * 0.9, one_card / 1e9
