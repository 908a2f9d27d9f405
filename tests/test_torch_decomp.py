"""The port's decompositions on the 6° aqua grid (its own build, no JAX).

After tests/test_sharded.py:55 and tests/test_sharded2d.py:54, :72, on
``ecwam_tpu_torch.parallel.decomp``/``decomp2d`` (the copies; test_torch_core
holds them to their originals):
  * the row-aligned 8-way cut bounds the halo by about two rows, and its
    layout map is a bijection on the real points;
  * the 2×4 patches: a bijection, every local index inside the ext
    layout, each direction's transfers injective;
  * the patches' exchange is smaller than the row bands' slabs (the
    O(perimeter) point of the reference's 2-D mode);
and the fused model's per-shard tables: every own row's window inside the
shard's rows, the adjacent rows' transfers each one neighbour's own row.
"""

import functools

import numpy as np
import pytest

from ecwam_tpu_torch.model import setup as tsetup
from ecwam_tpu_torch.parallel import decomp, decomp2d, multihost, sharded

LAYOUT = (2, 4)


@functools.lru_cache(maxsize=None)
def _ms(weights_mode="cached"):
    return tsetup.build_model(grid_name="6.0", nang=12, nfre=25,
                              idelpro=900.0, idelt=900.0, pad_to=64,
                              weights_mode=weights_mode, device="cpu")


def _bijection(ss, n):
    real = ss.perm[ss.perm >= 0]
    assert np.array_equal(np.sort(real), np.arange(n))
    idx = np.arange(n)
    assert np.array_equal(ss.perm[ss.g2l[idx]], idx)


def test_row_aligned_halo_is_small():
    ms = _ms()
    ss = decomp.build_sharded_stencil(
        ms.stencil, 8, row_start=np.asarray(ms.blk.row_start))
    max_row = int(np.max(np.asarray(ms.grid.nlonrgg)))
    assert ss.halo <= -(-(2 * max_row + 16) // 8) * 8
    _bijection(ss, ms.n_pad)


def test_patch_layout_structure():
    ms = _ms()
    ss = decomp2d.build_sharded2d_stencil(
        ms.stencil, *LAYOUT, row_start=np.asarray(ms.blk.row_start))
    _bijection(ss, ms.n_pad)
    for tab in (ss.klat, ss.klon, ss.kcor):
        assert tab.min() >= 0 and tab.max() <= ss.nland_local
    for pairs in ss.perm_pairs:
        src = [p[0] for p in pairs]
        dst = [p[1] for p in pairs]
        assert len(set(src)) == len(src) and len(set(dst)) == len(dst)


def test_patch_halo_is_perimeter_scaled():
    ms = _ms()
    rs = np.asarray(ms.blk.row_start)
    ss2 = decomp2d.build_sharded2d_stencil(ms.stencil, *LAYOUT, row_start=rs)
    ss1 = decomp.build_sharded_stencil(ms.stencil, 8, row_start=rs)
    assert sum(ss2.recv_sizes) < 2 * ss1.halo


def test_cached_model_exchange_lists():
    """Each shard's ext layout receives what its stencil reads: every
    local index of a stencil table is an own point, a slot some transfer
    fills, or the land slot."""
    ms = _ms()
    for layout in (None, LAYOUT):
        sm = sharded.build_sharded_model(
            ms, multihost.make_point_mesh(["cpu"] * 8), layout)
        for s in sm.local:
            st = sm._stencils[s]
            filled = np.zeros(sm.ext_len, bool)
            filled[:sm.size] = True
            filled[-1] = True
            for t in sm.transfers:
                if t.dst == s:
                    filled[t.put] = True
            for tab in (st.klat, st.klon, st.kcor):
                assert filled[np.asarray(tab).ravel()].all(), (layout, s)


@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_fused_shard_tables(n_shards):
    ms = _ms("fused")
    sm = sharded.build_sharded_model(
        ms, multihost.make_point_mesh(["cpu"] * n_shards))
    fst = sm.fused_shard_tables
    S = ms.fused.S
    for s in sm.local:
        ft = sm.tables[s]
        assert ft.nsrl == fst.nsrl_loc and ft.nsrl % S == 0
        # own points map to their own SRL rows, valid there
        perm = sm.sharded_stencil.perm[sm._sl(s)]
        real = (perm >= 0) & (perm < ms.n_real)
        pos = np.asarray(ft.from_srl)[real]
        assert np.all(np.asarray(ft.valid)[pos] == 1.0)
        gsrc = np.asarray(ft.srl_src)[pos]
        assert np.array_equal(gsrc, perm[real])
    # the transfers: each from a neighbour, into rows valid nowhere here
    assert len(sm.transfers) == 2 * (n_shards - 1)
    for t in sm.transfers:
        assert abs(t.src - t.dst) == 1
        assert t.put.stop - t.put.start == t.take.stop - t.take.start > 0
        assert np.all(np.asarray(sm.tables[t.dst].valid)[t.put] == 0.0)
        assert np.any(np.asarray(sm.tables[t.src].valid)[t.take] == 1.0)
