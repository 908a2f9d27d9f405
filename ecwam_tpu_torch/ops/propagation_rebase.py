"""Kernel A's per-segment tables: rebased FIR taps and the obstruction flag.

The table build (:func:`propagation_fused.build_fused_tables`) aligns each
segment's window base down to a multiple of 8 and rounds the tap window
EW up to a multiple of 4, for the TPU's DMA.  A card needs neither, so
:func:`rebase` folds each segment's leading all-zero tap columns into its
window base and keeps only the nonzero extent: kernel A then runs each
segment's own extent of taps (4–5 for most O320 segments, against EW =
16) with no per-tap branch.  :func:`rebase_taps` and :func:`shift_taps`
are copies of ``ecwam_tpu/ops/propagation_pallas.py: _rebase_taps,
_shift_taps``; :func:`obs_ones` is that file's all-open-water test
(``pack_tables``' ``obs_ones``), under which the kernel reads no
obstruction table.

The plain version (:func:`propagation_fused.advect_xla`) runs on the
original tables; from the rebased ones (windows at ``base + lo`` of width
``ew2`` with the shifted taps) it gives the same sums
(tests/test_torch_advect.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# directions per band of kernel A's work items (csrc/advect.cu: KB)
DIRS_PER_BAND = 4


def rebase_taps(taps: np.ndarray, base_full: np.ndarray, S: int):
    """Fold each block's leading all-zero tap columns into its window
    base.  The host-aligned window bases widen the per-point tap extent
    to EW=16, but the union extent of NONZERO taps per segment is ≤8 on
    octahedral grids (row-length ratios ≤ 4/3) — re-basing lets the
    kernel run half the FIR iterations (the dominant advection cost).

    Returns (lo (nblocks,), extent (nblocks,)); ``base_full`` is NOT
    modified here.
    """
    nb = len(base_full)
    t3 = np.asarray(taps).reshape(nb, -1)
    EW = taps.shape[-1]
    any_e = (t3 != 0.0).reshape(nb, S, -1, EW).any(axis=(1, 2))
    has = any_e.any(axis=1)
    lo = np.where(has, np.argmax(any_e, axis=1), 0).astype(np.int64)
    hi = np.where(has, EW - 1 - np.argmax(any_e[:, ::-1], axis=1), -1)
    ext = np.maximum(hi - lo + 1, 0)
    return lo, ext


def shift_taps(taps: np.ndarray, lo: np.ndarray, S: int, ew2: int):
    """taps (nsrl, 3, EW) → (nsrl, 3, ew2) with block b's columns
    shifted left by lo[b]."""
    nsrl, nsets, EW = taps.shape
    nb = len(lo)
    out = np.zeros((nb, S, nsets, ew2), taps.dtype)
    t4 = taps.reshape(nb, S, nsets, EW)
    for d in np.unique(lo):
        m = lo == d
        w = min(ew2, EW - d)
        out[m, :, :, :w] = t4[m, :, :, d:d + w]
    return out.reshape(nsrl, nsets, ew2)


def obs_ones(obs) -> bool:
    """All-open water: every obstruction factor is 1, so the pass may
    skip the table."""
    return bool(np.all(np.asarray(obs) == 1.0))


@dataclasses.dataclass(frozen=True)
class Rebased:
    """The rebased tap tables of one domain (body segments only)."""

    ew2: int                 # largest nonzero extent over both sides (≥ 1)
    lo: np.ndarray           # (nseg, 2) int64 column offsets [dn, up]
    ext: np.ndarray          # (nseg, 2) int64 nonzero extents [dn, up]
    dn_base: np.ndarray      # (nseg,) int32 rebased window bases
    up_base: np.ndarray      # (nseg,) int32
    taps_dn: np.ndarray      # (nsrl, 3, ew2) shifted taps
    taps_up: np.ndarray      # (nsrl, 3, ew2)
    obs_ones: bool


def rebase(ft) -> Rebased:
    """The rebased tables of :class:`propagation_fused.FusedTables`,
    built as the reference's ``pack_tables`` builds them: blocks of S rows
    over the whole SRL, the front pad block with base 0, block b ≥ 1 with
    segment b−1's base (the pad blocks have no taps)."""
    S, nseg, nsrl = ft.S, ft.nseg, ft.nsrl
    nblocks = nsrl // S
    sides = []
    for base, taps in ((ft.dn_base, ft.taps_dn), (ft.up_base, ft.taps_up)):
        full = np.zeros(nblocks, np.int64)
        full[1:nseg + 1] = np.asarray(base)
        lo, ext = rebase_taps(np.asarray(taps), full, S)
        sides.append((full, taps, lo, ext))
    ew2 = int(max(sides[0][3].max(), sides[1][3].max(), 1))
    body = slice(1, nseg + 1)
    out = {}
    for name, (full, taps, lo, ext) in zip(("dn", "up"), sides):
        out[name] = ((full + lo)[body].astype(np.int32),
                     shift_taps(np.asarray(taps), lo, S, ew2), lo[body],
                     ext[body])
    return Rebased(
        ew2=ew2, lo=np.stack([out["dn"][2], out["up"][2]], axis=1),
        ext=np.stack([out["dn"][3], out["up"][3]], axis=1),
        dn_base=out["dn"][0], up_base=out["up"][0],
        taps_dn=out["dn"][1], taps_up=out["up"][1],
        obs_ones=obs_ones(ft.obs))


def kernel_tables(rb: Rebased, dtype, device) -> dict:
    """Kernel A's tables: ``kseg`` (nseg, 4) int32 [lo_dn, lo_up, ext_dn,
    ext_up] (the kernel adds lo to the original window bases), ``ktaps``
    (nsrl, 2, ew2, 4) with each tap column as a vector [lat, corE, corW,
    0] (dn side then up side), and ``obs_ones``."""
    nsrl = rb.taps_dn.shape[0]
    k = np.zeros((nsrl, 2, rb.ew2, 4))
    k[:, 0, :, :3] = np.swapaxes(rb.taps_dn, 1, 2)
    k[:, 1, :, :3] = np.swapaxes(rb.taps_up, 1, 2)
    kseg = np.concatenate([rb.lo, rb.ext], axis=1)
    return dict(kseg=torch.as_tensor(kseg, dtype=torch.int32, device=device),
                ktaps=torch.as_tensor(k, dtype=dtype, device=device),
                obs_ones=rb.obs_ones)
