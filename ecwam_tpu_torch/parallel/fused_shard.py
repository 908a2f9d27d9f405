"""Per-shard fused-propagation tables for the 1-D row-band decomposition.

The SRL (segmented row layout, ops/propagation_fused.py) is row-aligned
with every row's storage a multiple of S, and the 1-D decomposition cuts
on row starts (parallel/decomp.py) — so a shard's fused domain is simply
a CONTIGUOUS SLICE of the global SRL covering its own rows plus the one
adjacent (halo) row on each side.  This module slices the global
FusedTables per shard, rebases the window bases, and maps the SRL gather
onto the shard's exchanged ext layout [H | own | H | land], producing
equal-size stacked arrays ready for `shard_map`.

Halo-row slots are valid=0 (owned by the neighbour shard); their window
reads may clamp — the masked output never uses them.  Matches the role
split of mpexchng.F90 (halo values) + ctuw/propags2 (local compute).

A copy of ``ecwam_tpu/parallel/fused_shard.py`` (numpy only), its
import pointed at the port's ``ops.propagation_fused.FusedTables``; the
code is the original's (tests/test_torch_core.py holds it to it).  The
port's sharded fused model (:mod:`ecwam_tpu_torch.parallel.sharded`)
takes each shard's slices of the tables from it and keeps the shard's
rows SRL-resident, so it does not use the ext-layout maps ``srl_src`` and
``from_srl`` for a gather every pass.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ecwam_tpu_torch.ops.propagation_fused import FusedTables


@dataclasses.dataclass(frozen=True)
class FusedShardTables:
    """Stacked per-shard fused tables (arrays lead with n_shards*X)."""

    n_shards: int
    nsrl_loc: int            # per-shard SRL length (equalized)
    nseg_loc: int            # per-shard body segments (nsrl_loc/S - 3)
    S: int
    EW: int
    nwrap_loc: int
    spans: tuple             # per-shard (lo, hi, g0, g1, k0, k1) or None
    # stacked (n_shards*nsrl_loc, ...) point tables
    srl_src: np.ndarray      # → local-ext index (land = 2H+size)
    valid: np.ndarray
    taps_dn: np.ndarray
    taps_up: np.ndarray
    sea_own: np.ndarray
    cgland: np.ndarray
    geom: np.ndarray
    obs: np.ndarray
    cg_srl: np.ndarray       # (n_shards*nsrl_loc, nfre)
    pf: np.ndarray | None    # (n_shards*nsrl_loc, 3, nfre)
    # stacked (n_shards*nblocks_loc,) window bases (ALL blocks, pads safe)
    dn_full: np.ndarray
    up_full: np.ndarray
    # stacked (n_shards*shard_size,) local ext point → local SRL position
    from_srl: np.ndarray
    # stacked (n_shards*nwrap_loc,) wrap refresh pairs (local SRL coords)
    wrap_pos: np.ndarray
    wrap_from: np.ndarray
    cg_land: np.ndarray      # (nfre,) deep-water cg (same for all shards)


def required_halo(ft: FusedTables, perm: np.ndarray, g2l: np.ndarray,
                  shard_size: int, n_shards: int,
                  kxlt: np.ndarray) -> int:
    """Halo width needed so each shard's adjacent rows fit in the
    exchanged ext window.  Measured in LAYOUT space: trailing shard pads
    sit between a shard's last real point and the next shard, so the
    halo must cover (pad gap + adjacent row length)."""
    kxlt = np.asarray(kxlt, np.int64)
    npts = ft.npts
    rs_row = np.concatenate(
        [[0], np.cumsum(np.bincount(kxlt, minlength=len(ft.row_base)))])
    need = 8
    for s in range(n_shards):
        own = perm[s * shard_size:(s + 1) * shard_size]
        own = own[(own >= 0) & (own < npts)]
        if own.size == 0:
            continue
        k0 = int(kxlt[own[0]])
        k1 = int(kxlt[own[-1]]) + 1
        start = s * shard_size
        if k0 > 0 and rs_row[k0 - 1] < rs_row[k0]:
            lmin = int(g2l[rs_row[k0 - 1]])
            need = max(need, start - lmin)
        if k1 < len(rs_row) - 1 and rs_row[k1] < rs_row[k1 + 1]:
            lmax = int(g2l[rs_row[k1 + 1] - 1])
            need = max(need, lmax - (start + shard_size) + 1)
    return int(-(-need // 8) * 8)


def build_fused_shard_tables(ft: FusedTables, fe: dict,
                             perm: np.ndarray, g2l: np.ndarray,
                             shard_size: int, n_shards: int, halo: int,
                             kxlt: np.ndarray) -> FusedShardTables:
    """Slice the global fused tables per shard (see module docstring).

    ``fe`` is the setup's fused_env dict (cg_srl/cg_land/pf statics);
    ``perm``/``g2l``/``shard_size``/``halo`` from decomp.ShardedStencil.
    """
    S, EW = ft.S, ft.EW
    ngy = len(ft.row_base)
    kxlt = np.asarray(kxlt, np.int64)
    row_cnt = np.bincount(kxlt, minlength=ngy).astype(np.int64)
    row_end = np.asarray(ft.row_base) + np.asarray(ft.row_len)
    nland_local = 2 * halo + shard_size
    nfre = fe["cg_srl"].shape[1]
    has_pf = "pf" in fe

    spans = []          # (lo, hi, g0, g1, k0, k1) per shard
    for s in range(n_shards):
        own = perm[s * shard_size:(s + 1) * shard_size]
        own = own[(own >= 0) & (own < ft.npts)]
        if own.size == 0:
            spans.append(None)
            continue
        g0, g1 = int(own[0]), int(own[-1]) + 1
        k0, k1 = int(kxlt[own[0]]), int(kxlt[own[-1]]) + 1
        kd = k0 - 1 if k0 > 0 else k0
        ku = k1 if k1 < ngy else k1 - 1
        lo = int(ft.row_base[kd])
        hi = int(row_end[ku]) if row_cnt[ku] > 0 or ku < ngy \
            else int(row_end[k1 - 1])
        hi = max(hi, int(row_end[k1 - 1]))
        spans.append((lo, hi, g0, g1, k0, k1))

    span_len = max((sp[1] - sp[0]) for sp in spans if sp)
    nsrl_loc = span_len + 3 * S
    nblocks_loc = nsrl_loc // S
    nseg_loc = nblocks_loc - 3

    # per-shard wrap pair counts → common length
    wrap_pos_g = np.asarray(ft.wrap_pos)
    wrap_from_g = np.asarray(ft.wrap_from)
    nwrap_loc = 0
    for sp in spans:
        if sp:
            m = (wrap_pos_g >= sp[0]) & (wrap_pos_g < sp[1])
            nwrap_loc = max(nwrap_loc, int(m.sum()))

    def alloc(src, benign):
        out = np.empty((n_shards, nsrl_loc) + src.shape[1:], src.dtype)
        out[...] = benign
        return out

    srl_src = np.full((n_shards, nsrl_loc), nland_local, np.int64)
    valid = np.zeros((n_shards, nsrl_loc))
    taps_dn = alloc(np.asarray(ft.taps_dn), 0.0)
    taps_up = alloc(np.asarray(ft.taps_up), 0.0)
    sea_own = alloc(np.asarray(ft.sea_own), 0.0)
    cgland = alloc(np.asarray(ft.cgland), 0.0)
    geom = alloc(np.asarray(ft.geom), 0.0)
    geom[:, :, 0] = 1.0
    geom[:, :, 1] = 1.0
    geom[:, :, 5] = np.asarray(ft.geom)[0, 5]     # xdella
    obs = alloc(np.asarray(ft.obs), 1.0)
    cg_srl = np.empty((n_shards, nsrl_loc, nfre))
    cg_srl[...] = np.asarray(fe["cg_land"])[None, None, :]
    pf = (np.zeros((n_shards, nsrl_loc, 3, nfre)) if has_pf else None)
    dn_full = np.zeros((n_shards, nblocks_loc), np.int64)
    up_full = np.zeros((n_shards, nblocks_loc), np.int64)
    from_srl = np.zeros((n_shards, shard_size), np.int64)
    wrap_pos = np.zeros((n_shards, nwrap_loc), np.int64)
    wrap_from = np.zeros((n_shards, nwrap_loc), np.int64)

    g_src = np.asarray(ft.srl_src)
    g_valid = np.asarray(ft.valid)
    g_from = np.asarray(ft.from_srl)

    for s, sp in enumerate(spans):
        if sp is None:
            continue
        lo, hi, g0, g1, k0, k1 = sp
        n = hi - lo
        off = lo - S                           # global pos - off = local
        body = slice(S, S + n)

        # srl_src → local ext indices via the layout map (trailing
        # shard pads sit between shards); assert halo coverage
        src = g_src[lo:hi].astype(np.int64)
        is_land = src == ft.land_index
        lpos = g2l[np.where(is_land, 0, src)]
        rel = np.where(is_land, 0, lpos - s * shard_size)
        if ((rel < -halo) | (rel >= shard_size + halo))[~is_land].any():
            raise AssertionError(
                f"shard {s}: halo {halo} does not cover adjacent rows")
        srl_src[s, body] = np.where(is_land, nland_local, halo + rel)

        v = g_valid[lo:hi].copy()
        # halo rows belong to the neighbour shards
        own_lo = int(ft.row_base[k0]) - lo
        own_hi = int(row_end[k1 - 1]) - lo
        v[:own_lo] = 0.0
        v[own_hi:] = 0.0
        valid[s, body] = v

        taps_dn[s, body] = np.asarray(ft.taps_dn)[lo:hi]
        taps_up[s, body] = np.asarray(ft.taps_up)[lo:hi]
        sea_own[s, body] = np.asarray(ft.sea_own)[lo:hi]
        cgland[s, body] = np.asarray(ft.cgland)[lo:hi]
        geom[s, body] = np.asarray(ft.geom)[lo:hi]
        obs[s, body] = np.asarray(ft.obs)[lo:hi]
        cg_srl[s, body] = np.asarray(fe["cg_srl"])[lo:hi]
        if has_pf:
            pf[s, body] = np.asarray(fe["pf"])[lo:hi]

        # window bases: global body segment of local block b is
        # (lo + (b-1)*S - S)//S; clamp into the local array
        EWG = ((EW + 2 + 7) // 8) * 8
        for b in range(nblocks_loc):
            gpos = lo + (b - 1) * S
            gseg = (gpos - S) // S
            if 1 <= b <= (n // S) and 0 <= gseg < ft.nseg:
                dnb = int(ft.dn_base[gseg]) - off
                upb = int(ft.up_base[gseg]) - off
            else:
                dnb = upb = b * S
            dn_full[s, b] = min(max(dnb - dnb % 8, 0),
                                nsrl_loc - S - EWG)
            up_full[s, b] = min(max(upb - upb % 8, 0),
                                nsrl_loc - S - EWG)

        # local ext own points → local SRL positions (pads mirror the
        # shard's first real point)
        own = perm[s * shard_size:(s + 1) * shard_size]
        real = (own >= 0) & (own < ft.npts)
        gidx = np.where(real, own, g0)
        from_srl[s] = g_from[gidx] - off

        m = (wrap_pos_g >= lo) & (wrap_pos_g < hi) \
            & (wrap_from_g >= lo) & (wrap_from_g < hi)
        wp = wrap_pos_g[m] - off
        wf = wrap_from_g[m] - off
        wrap_pos[s, :wp.size] = wp
        wrap_from[s, :wf.size] = wf

    return FusedShardTables(
        n_shards=n_shards, nsrl_loc=int(nsrl_loc),
        nseg_loc=int(nseg_loc), S=S, EW=EW, nwrap_loc=int(nwrap_loc),
        spans=tuple(spans),
        srl_src=srl_src.reshape(-1).astype(np.int32),
        valid=valid.reshape(-1),
        taps_dn=taps_dn.reshape((-1,) + taps_dn.shape[2:]),
        taps_up=taps_up.reshape((-1,) + taps_up.shape[2:]),
        sea_own=sea_own.reshape(-1, 2), cgland=cgland.reshape(-1, 2),
        geom=geom.reshape(-1, 8),
        obs=obs.reshape((-1,) + obs.shape[2:]),
        cg_srl=cg_srl.reshape(-1, nfre),
        pf=None if pf is None else pf.reshape(-1, 3, nfre),
        dn_full=dn_full.reshape(-1).astype(np.int32),
        up_full=up_full.reshape(-1).astype(np.int32),
        from_srl=from_srl.reshape(-1).astype(np.int32),
        wrap_pos=wrap_pos.reshape(-1).astype(np.int32),
        wrap_from=wrap_from.reshape(-1).astype(np.int32),
        cg_land=np.asarray(fe["cg_land"]))


def slice_global_srl(fst: FusedShardTables, arr_global: np.ndarray,
                     benign=0.0) -> np.ndarray:
    """Slice a (nsrl_global, ...) SRL field into the stacked per-shard
    layout (for refresh-time fields like uv/grads)."""
    out = np.empty((fst.n_shards, fst.nsrl_loc) + arr_global.shape[1:],
                   arr_global.dtype)
    out[...] = benign
    S = fst.S
    for s, sp in enumerate(fst.spans):
        if sp is None:
            continue
        lo, hi = sp[0], sp[1]
        out[s, S:S + hi - lo] = arr_global[lo:hi]
    return out.reshape((-1,) + arr_global.shape[1:])
