"""Domain decomposition over the sea-point axis.

TPU-native equivalent of the reference's MPDECOMP 1-D latitude-band split
(mpdecomp.F90:341-390, LL1D mode), with one
deliberate difference: shard boundaries are snapped to LATITUDE-ROW
STARTS.  The lat-major block layout makes every stencil neighbour of a
row either in the same row (including the periodic lon-wrap neighbour)
or in the rows directly above/below, so a row-aligned cut bounds the
halo by one row's length.  A mid-row cut (the naive equal-count split)
would push the wrap-around neighbour of a boundary point up to a whole
row away and inflate the exchanged slab to ~the full row (O1280: 5,136
points per halo side) — the round-1 halo blowup.

Because `shard_map` needs equal-size shards, each row-aligned shard is
padded to the common size with isolated pad points (all-land neighbours,
physics replicated from global point 0 — the same trick as the
reference's NPROMA trailing fictitious points, mchunk.F90:44-45).  The
``perm``/``g2l`` maps convert between the global block order and the
padded layout.

Local extended layout per shard: [H left-halo | shard | H right-halo | land]
so layout index l maps to local  H + l - s·shard_size, and the land slot
is 2H + shard_size.

A copy of ``ecwam_tpu/parallel/decomp.py`` (numpy only), its import
pointed at the port's ``ops.propagation.StencilTables``; the code is the
original's (tests/test_torch_core.py holds it to it).  In the port the
layout feeds :mod:`ecwam_tpu_torch.parallel.sharded`, whose exchange
takes the place of ``shard_map``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ecwam_tpu_torch.ops.propagation import StencilTables


@dataclasses.dataclass(frozen=True)
class ShardedStencil:
    """Per-shard stencil tables in the padded row-aligned layout.

    Index tables hold *local* ext-layout indices and are stacked back into
    (n_layout, ...) arrays ready to be sharded on the point axis.
    """

    n_shards: int
    shard_size: int
    halo: int                 # H
    nland_local: int          # 2H + shard_size
    perm: np.ndarray          # (n_layout,) layout → global index, -1 = pad
    g2l: np.ndarray           # (n_global,) global → layout position
    # stacked local-index tables (n_layout, ...)
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
    def n_layout(self) -> int:
        return self.n_shards * self.shard_size

    def to_layout(self, arr: np.ndarray, point_axis: int = -1,
                  pad_from: int = 0) -> np.ndarray:
        """Reorder a global per-point array into the padded layout.

        Pad slots are filled from global index ``pad_from`` (the
        fictitious-point convention)."""
        idx = np.where(self.perm >= 0, self.perm, pad_from)
        return np.take(np.asarray(arr), idx, axis=point_axis)

    def from_layout(self, arr: np.ndarray, point_axis: int = -1,
                    n_global: int | None = None) -> np.ndarray:
        """Inverse of :meth:`to_layout` (drops the pad slots)."""
        n = self.g2l.shape[0] if n_global is None else n_global
        return np.take(np.asarray(arr), self.g2l[:n], axis=point_axis)


def row_cuts(row_start: np.ndarray, n_total: int, n_shards: int):
    """Choose shard boundaries on row starts with near-equal point counts.

    ``row_start`` is the first global index of each latitude row
    (SeaPointBlock.row_start); trailing global pad points follow the last
    row and land in the last shard.
    """
    bounds = np.unique(np.concatenate([row_start, [n_total]]))
    targets = n_total * np.arange(1, n_shards) / n_shards
    cuts = [0]
    for t in targets:
        i = int(np.argmin(np.abs(bounds - t)))
        b = int(bounds[i])
        if b <= cuts[-1]:                       # keep cuts increasing
            later = bounds[bounds > cuts[-1]]
            if later.size == 0:
                raise ValueError(
                    f"cannot cut {n_shards} shards on {len(bounds)} rows")
            b = int(later[0])
        cuts.append(b)
    cuts.append(n_total)
    return np.asarray(cuts, dtype=np.int64)


def compute_halo_width(st: StencilTables, n_shards: int) -> int:
    """Equal-count-split halo width (legacy diagnostic; see module doc)."""
    n = st.npts
    assert n % n_shards == 0, (n, n_shards)
    size = n // n_shards
    starts = np.arange(n) // size * size
    reach = 0
    for arr in (st.klat.reshape(n, -1), st.klon.reshape(n, -1),
                st.kcor.reshape(n, -1)):
        live = arr != st.nland
        rel = np.where(live, arr - starts[:, None], 0)
        reach = max(reach, int(np.max(rel - (size - 1), initial=0)),
                    int(np.max(-rel, initial=0)))
    return max(8, -(-reach // 8) * 8)


def build_sharded_stencil(st: StencilTables, n_shards: int,
                          row_start: np.ndarray | None = None,
                          halo: int | None = None) -> ShardedStencil:
    """Remap global neighbour indices to the per-shard local ext layout.

    With ``row_start`` given, shard boundaries snap to latitude rows and
    shards are padded to a common size; without it, the legacy equal
    split is used (requires npts % n_shards == 0).
    """
    n = st.npts

    if row_start is not None:
        cuts = row_cuts(np.asarray(row_start), n, n_shards)
        sizes = np.diff(cuts)
        shard_size = int(-(-sizes.max() // 8) * 8)
        perm = np.full(n_shards * shard_size, -1, dtype=np.int64)
        g2l = np.empty(n, dtype=np.int64)
        for s in range(n_shards):
            g = np.arange(cuts[s], cuts[s + 1])
            l = s * shard_size + np.arange(g.size)
            perm[l] = g
            g2l[g] = l
    else:
        assert n % n_shards == 0, (n, n_shards)
        shard_size = n // n_shards
        perm = np.arange(n, dtype=np.int64)
        g2l = perm.copy()

    n_layout = n_shards * shard_size
    shard_of = np.arange(n_layout) // shard_size
    starts = shard_of * shard_size

    # layout-space neighbour tables (pads → land)
    def to_layout_idx(arr):
        """Global neighbour indices → layout positions (land preserved)."""
        flat = arr.reshape(n, -1)
        lay = np.where(flat == st.nland, -2, g2l[np.minimum(flat, n - 1)])
        out = np.full((n_layout, flat.shape[1]), -2, dtype=np.int64)
        own = perm >= 0
        out[own] = lay[perm[own]]
        return out.reshape((n_layout,) + arr.shape[1:])

    klat_l = to_layout_idx(st.klat)
    klon_l = to_layout_idx(st.klon)
    kcor_l = to_layout_idx(st.kcor)

    # halo width: maximum out-of-shard reach in layout space
    if halo is None:
        reach = 0
        for arr in (klat_l.reshape(n_layout, -1),
                    klon_l.reshape(n_layout, -1),
                    kcor_l.reshape(n_layout, -1)):
            live = arr >= 0
            rel = np.where(live, arr - starts[:, None], 0)
            reach = max(reach,
                        int(np.max(rel - (shard_size - 1), initial=0)),
                        int(np.max(-rel, initial=0)))
        halo = max(8, -(-reach // 8) * 8)
    assert halo <= shard_size, f"halo {halo} exceeds shard {shard_size}"
    nland_local = 2 * halo + shard_size

    def localize(arr):
        flat = arr.reshape(n_layout, -1)
        local = halo + flat - starts[:, None]
        local = np.where(flat == -2, nland_local, local)
        assert (local >= 0).all() and (local <= nland_local).all()
        return local.reshape(arr.shape).astype(np.int32)

    def pt(a, axis=-1):
        """Per-point geometry → layout order (pads copy point 0)."""
        idx = np.where(perm >= 0, perm, 0)
        return np.take(np.asarray(a), idx, axis=axis)

    # pads are isolated automatically: their own neighbour entries point at
    # the land slot, and no real point's neighbour list references a pad
    # (g2l only maps real global indices).
    return ShardedStencil(
        n_shards=n_shards, shard_size=shard_size, halo=halo,
        nland_local=nland_local, perm=perm, g2l=g2l,
        klat=localize(klat_l), klon=localize(klon_l),
        kcor=localize(kcor_l),
        wlat=pt(st.wlat, axis=0), wcor=pt(st.wcor, axis=0),
        dp=pt(st.dp, axis=0), zdello_pt=pt(st.zdello_pt, axis=0),
        xdella=st.xdella,
        cosphm1_pt=pt(st.cosphm1_pt, axis=0),
        tanph_pt=pt(st.tanph_pt, axis=0),
        obslat=pt(st.obslat, axis=1), obslon=pt(st.obslon, axis=1),
        obscor=pt(st.obscor, axis=1))
