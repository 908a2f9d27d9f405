"""2-D domain decomposition: latitude-band × within-row patches.

TPU-native equivalent of the reference's 2-D MPDECOMP mode
(mpdecomp.F90, LL1D=.FALSE.): the grid is cut
into ``nlat`` latitude bands (row-aligned, like the 1-D mode) and each
band is cut into ``nlon`` segments at PROPORTIONAL within-row positions,
so shard (i, j) owns, in every row of band i, the slice of points whose
row fraction falls in [j/nlon, (j+1)/nlon).  Patches have O(perimeter)
halos instead of the 1-D mode's O(row-length) slabs, which is the whole
point of the reference's 2-D decomposition at scale.

Because the within-row cuts are proportional, every stencil neighbour of
a patch lives in one of the 8 torus neighbours (N, S, E, W + diagonals;
the lon axis wraps with the periodic grid, the lat axis ends at the
poles).  The halo exchange is GATHER-BASED: at setup each shard gets,
per direction, the exact index list of points its neighbour needs; at
run time the sender gathers that list and one ``jax.lax.ppermute`` per
direction ships it (each direction is a permutation of the flattened
1-D device mesh, so no nested mesh axes are needed).

Local extended layout per shard:
    [own (shard_size) | recv_0 (L_0) | ... | recv_{D-1} | land]

A copy of ``ecwam_tpu/parallel/decomp2d.py`` (numpy only), its imports
pointed at the port's ``ops.propagation`` and ``parallel.decomp``; the
code is the original's (tests/test_torch_core.py holds it to it).  In
the port one point-to-point transfer per direction and receiving shard
(:mod:`ecwam_tpu_torch.parallel.sharded`) takes the place of
``ppermute``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ecwam_tpu_torch.ops.propagation import StencilTables
from ecwam_tpu_torch.parallel.decomp import row_cuts

# receiver-relative neighbour offsets (dlat, dlon); dlon wraps mod nlon
DELTAS = ((-1, 0), (1, 0), (0, -1), (0, 1),
          (-1, -1), (-1, 1), (1, -1), (1, 1))


def _ceil8(x: int) -> int:
    return max(8, -(-int(x) // 8) * 8)


@dataclasses.dataclass(frozen=True)
class Sharded2DStencil:
    """Per-shard stencil tables + exchange index lists (2-D patches).

    Field layout mirrors :class:`ecwam_tpu_torch.parallel.decomp.ShardedStencil`
    so the sharded model builder can consume either.
    """

    nlat: int
    nlon: int
    shard_size: int
    nland_local: int          # shard_size + sum(recv_sizes)
    perm: np.ndarray          # (n_layout,) layout → global index, -1 = pad
    g2l: np.ndarray           # (n_global,) global → layout position
    deltas: tuple             # active directions ((di, dj), ...)
    recv_sizes: tuple         # padded L_k per active direction
    perm_pairs: tuple         # per direction: ((src, dst), ...) for ppermute
    send_idx: dict            # {"send{k}": (n_shards, L_k) int32 local idx}
    # stacked local-index tables (n_layout, ...) into the ext layout
    klat: np.ndarray
    klon: np.ndarray
    kcor: np.ndarray
    # point-wise geometry/weights in layout order
    wlat: np.ndarray
    wcor: np.ndarray
    dp: np.ndarray
    zdello_pt: np.ndarray
    xdella: float
    cosphm1_pt: np.ndarray
    tanph_pt: np.ndarray
    obslat: np.ndarray
    obslon: np.ndarray
    obscor: np.ndarray

    @property
    def n_shards(self) -> int:
        return self.nlat * self.nlon

    @property
    def n_layout(self) -> int:
        return self.n_shards * self.shard_size

    def to_layout(self, arr: np.ndarray, point_axis: int = -1,
                  pad_from: int = 0) -> np.ndarray:
        idx = np.where(self.perm >= 0, self.perm, pad_from)
        return np.take(np.asarray(arr), idx, axis=point_axis)

    def from_layout(self, arr: np.ndarray, point_axis: int = -1,
                    n_global: int | None = None) -> np.ndarray:
        n = self.g2l.shape[0] if n_global is None else n_global
        return np.take(np.asarray(arr), self.g2l[:n], axis=point_axis)


def assign_shards(st_npts: int, row_start: np.ndarray,
                  nlat: int, nlon: int):
    """Shard id per global point: (band via row-aligned cuts) × nlon +
    (proportional within-row column).  Trailing global pad points extend
    the last row (they are isolated, so their placement is arbitrary)."""
    n = st_npts
    row_start = np.asarray(row_start, dtype=np.int64)
    cuts = row_cuts(row_start, n, nlat)
    g = np.arange(n)
    band = np.clip(np.searchsorted(cuts, g, side="right") - 1, 0, nlat - 1)
    row_of = np.searchsorted(row_start, g, side="right") - 1
    bounds = np.append(row_start, n)
    q = g - row_start[row_of]
    rlen = np.maximum(bounds[row_of + 1] - row_start[row_of], 1)
    jcol = np.clip((q * nlon) // rlen, 0, nlon - 1)
    return band * nlon + jcol


def build_sharded2d_stencil(st: StencilTables, nlat: int, nlon: int,
                            row_start: np.ndarray) -> Sharded2DStencil:
    """Remap the global stencil to per-patch local tables + exchange lists.

    Raises ValueError if any stencil reference escapes the 8-neighbour
    torus (pathologically small patches) — reduce ``nlon`` in that case.
    """
    n = st.npts
    nshards = nlat * nlon
    shard_of = assign_shards(n, row_start, nlat, nlon)

    counts = np.bincount(shard_of, minlength=nshards)
    shard_size = _ceil8(counts.max())
    perm = np.full(nshards * shard_size, -1, dtype=np.int64)
    g2l = np.empty(n, dtype=np.int64)
    pts_of = []
    for s in range(nshards):
        gs = np.flatnonzero(shard_of == s)
        loc = s * shard_size + np.arange(gs.size)
        perm[loc] = gs
        g2l[gs] = loc
        pts_of.append(gs)

    # all stencil references, one (n, 12) table
    flat_refs = np.concatenate(
        [st.klat.reshape(n, -1), st.klon.reshape(n, -1),
         st.kcor.reshape(n, -1)], axis=1)
    ncols = flat_refs.shape[1]

    def direction(s: int, owner: np.ndarray):
        """Canonical (di, dj) per owner shard relative to shard s."""
        si, sj = divmod(s, nlon)
        oi, oj = divmod(owner, nlon)
        di = oi - si
        djm = (oj - sj) % nlon
        dj = np.where(djm == 0, 0,
                      np.where(djm == 1, 1,
                               np.where(djm == nlon - 1, -1, 99)))
        return di, dj

    dir_index = {d: k for k, d in enumerate(DELTAS)}

    # ---- pass 1: per-(shard, direction) receive lists -----------------
    recv = [[np.zeros(0, np.int64)] * len(DELTAS) for _ in range(nshards)]
    for s in range(nshards):
        fr = flat_refs[pts_of[s]].ravel()
        fr = np.unique(fr[fr != st.nland])
        owner = shard_of[fr]
        out = owner != s
        fr, owner = fr[out], owner[out]
        if fr.size == 0:
            continue
        di, dj = direction(s, owner)
        keys = [(int(a), int(b)) for a, b in zip(di, dj)]
        bad = [kk for kk in keys if kk not in dir_index]
        if bad:
            raise ValueError(
                f"2-D decomposition: shard {s} references {bad[0]} — "
                f"outside the 8-neighbour torus; reduce nlon={nlon}")
        kidx = np.array([dir_index[kk] for kk in keys])
        for k in range(len(DELTAS)):
            recv[s][k] = np.sort(fr[kidx == k])

    # active directions and padded sizes
    raw_sizes = [max(recv[s][k].size for s in range(nshards))
                 for k in range(len(DELTAS))]
    active = [k for k in range(len(DELTAS)) if raw_sizes[k] > 0]
    deltas = tuple(DELTAS[k] for k in active)
    recv_sizes = tuple(_ceil8(raw_sizes[k]) for k in active)
    offsets = shard_size + np.concatenate([[0], np.cumsum(recv_sizes)])
    nland_local = int(shard_size + sum(recv_sizes))

    # ---- sender index lists + ppermute permutations --------------------
    def nbr(s: int, delta):
        """Shard at receiver-relative offset ``delta`` from s (or -1)."""
        di, dj = delta
        i, j = divmod(s, nlon)
        i2 = i + di
        if not (0 <= i2 < nlat):
            return -1
        return i2 * nlon + (j + dj) % nlon

    send_idx = {}
    perm_pairs = []
    for a, k in enumerate(active):
        delta = DELTAS[k]
        L = recv_sizes[a]
        tab = np.zeros((nshards, L), dtype=np.int32)
        pairs = []
        for r in range(nshards):
            o = nbr(r, delta)                 # r receives from o
            if o < 0:
                continue
            lst = recv[r][k]
            if lst.size:
                tab[o, :lst.size] = (g2l[lst] - o * shard_size)
            pairs.append((o, r))
        send_idx[f"send{a}"] = tab
        perm_pairs.append(tuple(pairs))

    # ---- local stencil tables ------------------------------------------
    def localize(tab_global: np.ndarray) -> np.ndarray:
        flat = tab_global.reshape(n, -1)
        out = np.full((nshards * shard_size, flat.shape[1]),
                      nland_local, dtype=np.int64)
        for s in range(nshards):
            gs = pts_of[s]
            fr = flat[gs]
            res = np.full(fr.shape, nland_local, dtype=np.int64)
            land = fr == st.nland
            owner = np.where(land, -1, shard_of[np.minimum(fr, n - 1)])
            own_m = owner == s
            res[own_m] = g2l[fr[own_m]] - s * shard_size
            rest = ~land & ~own_m
            if rest.any():
                di, dj = direction(s, np.where(rest, owner, s))
                for a, k in enumerate(active):
                    d = DELTAS[k]
                    m = rest & (di == d[0]) & (dj == d[1])
                    if not m.any():
                        continue
                    pos = np.searchsorted(recv[s][k], fr[m])
                    res[m] = offsets[a] + pos
            out[s * shard_size: s * shard_size + gs.size] = res
        return out.reshape((nshards * shard_size,) + tab_global.shape[1:]
                           ).astype(np.int32)

    def pt(a, axis=-1):
        idx = np.where(perm >= 0, perm, 0)
        return np.take(np.asarray(a), idx, axis=axis)

    return Sharded2DStencil(
        nlat=nlat, nlon=nlon, shard_size=shard_size,
        nland_local=nland_local, perm=perm, g2l=g2l,
        deltas=deltas, recv_sizes=recv_sizes,
        perm_pairs=tuple(perm_pairs), send_idx=send_idx,
        klat=localize(st.klat), klon=localize(st.klon),
        kcor=localize(st.kcor),
        wlat=pt(st.wlat, axis=0), wcor=pt(st.wcor, axis=0),
        dp=pt(st.dp, axis=0), zdello_pt=pt(st.zdello_pt, axis=0),
        xdella=st.xdella,
        cosphm1_pt=pt(st.cosphm1_pt, axis=0),
        tanph_pt=pt(st.tanph_pt, axis=0),
        obslat=pt(st.obslat, axis=1), obslon=pt(st.obslon, axis=1),
        obscor=pt(st.obscor, axis=1))
