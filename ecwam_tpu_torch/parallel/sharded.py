"""Sharded (multi-device) models: the halo exchange over a ring of shards.

Port of ``ecwam_tpu/parallel/sharded.py`` on ``torch.distributed``.  The
reference replaces the reference model's MPI layer with ``shard_map`` over
a device mesh; here each shard is a tensor on its device, and:

  - the halo exchange (mpexchng.F90:116-255) copies each halo from the
    neighbour that owns it: a tensor copy between shards of one process
    (a peer copy between cards, never staged through the host), one
    point-to-point transfer between processes, all of an exchange's in one
    ``dist.batch_isend_irecv``.  The ends of the chain receive zeros;
  - PROENVHALO (proenvhalo.F90:1-113) is the same exchange of the
    wave-property and current fields feeding the refraction terms and the
    CTU weights;
  - the norms gather to the host in global block order (MPMINMAXAVG's
    gather-to-one mode, the same bits at any shard count), or reduce with
    ``all_reduce`` (its monitoring mode).

Two models, after the reference's (:func:`build_sharded_model`):

  * the cached model (``weights_mode`` 'cached'): the row bands of
    :mod:`.decomp` or the patches of :mod:`.decomp2d` (``layout2d``), the
    CTU weights of :func:`ecwam_tpu_torch.model.stepper._compute_weights`
    built once per shard over its local stencil (LUPDTWGHT), PROPAGS2 on
    the exchanged ext layout and the full-mode physics through kernel C,
    as the dense ``WaveModel`` runs them;
  * the fused model (``weights_mode`` 'fused', row bands only): each
    shard keeps its rows in the segmented row layout (SRL) of its own
    slice of the global tables (:mod:`.fused_shard`) — its own rows and
    the one adjacent row on each side — resident.  A pass exchanges only
    the adjacent rows, in place, refreshes the row wraps and runs kernel
    A on the shard's rebased tables; the physics runs kernel B on the
    shard's rows, minimal between output dates and full mode chunked at
    them.  Every own row sees the taps and physics it sees on one device,
    so the shards reproduce ``FastWaveModel`` bit for bit.

Every shard's tensors live on its mesh device; a shard whose kernel fails
to build or launch raises, as the wrappers do on one device.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import numpy as np
import torch
import torch.distributed as dist

from ecwam_tpu_torch.model import stepper as stp
from ecwam_tpu_torch.model.fusedstep import FusedPropagation
from ecwam_tpu_torch.ops import propagation as prop
from ecwam_tpu_torch.ops import propagation_fused as pfz
from ecwam_tpu_torch.ops.physics import implsch_cuda as ipk
from ecwam_tpu_torch.parallel import decomp, decomp2d
from ecwam_tpu_torch.parallel import fused_shard as fsh
from ecwam_tpu_torch.parallel.multihost import PointMesh

ENV_POINT_FIELDS = ("wavnum", "cinv", "cgroup", "xk2cg", "omosnh2kd",
                    "stokfac", "depth", "emaxdpt", "ucur", "vcur")


@dataclasses.dataclass(frozen=True)
class Transfer:
    """One halo: shard ``src`` sends ``take`` (a slice or an index array
    along its axis) to shard ``dst``, which puts it at ``put``."""

    src: int
    dst: int
    take: object
    put: slice


def _take(t: torch.Tensor, take, dim: int) -> torch.Tensor:
    if isinstance(take, slice):
        return t.narrow(dim, take.start, take.stop - take.start)
    return t.index_select(dim, take)


def exchange(mesh: PointMesh, transfers, dim: int, read, write) -> int:
    """Run one halo exchange: for every transfer into a shard of this
    process, ``write(dst)`` (a tensor) takes ``read(src)``'s ``take``
    along ``dim`` at ``put``.  Shards of one process copy (across cards
    where they lie on two); a transfer between processes is one send and
    one receive, all of them in one ``batch_isend_irecv``, in the
    transfers' order on both sides.  Returns the bytes this process
    received."""
    local = set(mesh.local)
    ops, pending, nbytes = [], [], 0
    for tag, t in enumerate(transfers):
        to_me, from_me = t.dst in local, t.src in local
        if not (to_me or from_me):
            continue
        if to_me and from_me:
            dst = write(t.dst)
            part = _take(read(t.src), t.take, dim)
            dst.narrow(dim, t.put.start, t.put.stop - t.put.start).copy_(
                part, non_blocking=True)
            nbytes += part.numel() * part.element_size()
        elif from_me:
            part = _take(read(t.src), t.take, dim).contiguous()
            ops.append(dist.P2POp(dist.isend, part, mesh.ranks[t.dst],
                                  tag=tag))
        else:
            dst = write(t.dst)
            shape = list(dst.shape)
            shape[dim] = t.put.stop - t.put.start
            buf = torch.empty(shape, dtype=dst.dtype, device=dst.device)
            ops.append(dist.P2POp(dist.irecv, buf, mesh.ranks[t.src],
                                  tag=tag))
            pending.append((t, buf))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        for t, buf in pending:
            write(t.dst).narrow(dim, t.put.start,
                                t.put.stop - t.put.start).copy_(buf)
            nbytes += buf.numel() * buf.element_size()
    return nbytes


@dataclasses.dataclass
class ShardedModel:
    """The layout maps, placement and norms shared by the sharded models.

    A sharded field is a list of this process's shards' tensors, in ring
    order (``mesh.local``), each the shard's slice of the padded layout
    along the point axis."""

    setup: object
    mesh: PointMesh
    sharded_stencil: object
    halo_bytes: int = 0           # bytes received by the exchanges

    def __post_init__(self):
        ss = self.sharded_stencil
        n = self.setup.n_real
        self._masks = [self._on(s, torch.as_tensor(
            ((ss.perm[self._sl(s)] >= 0) & (ss.perm[self._sl(s)] < n)),
            dtype=self.setup.dtype)) for s in self.local]

    # -- placement ----------------------------------------------------
    @property
    def local(self) -> tuple:
        return self.mesh.local

    @property
    def size(self) -> int:
        return self.sharded_stencil.shard_size

    def _sl(self, s: int) -> slice:
        return slice(s * self.size, (s + 1) * self.size)

    def _on(self, s: int, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.mesh.devices[s])

    # -- layout mapping -----------------------------------------------
    def to_layout(self, arr, point_axis: int = -1):
        return self.sharded_stencil.to_layout(_host(arr), point_axis)

    def gather(self, parts, point_axis: int = -1) -> np.ndarray:
        """This process's shards of a field, concatenated: the field in
        the padded layout when every shard is this process's."""
        if len(parts) != self.mesh.n_shards:
            raise ValueError("gather needs every shard in this process "
                             "(multi-process runs write restarts instead)")
        return np.concatenate([_host(p) for p in parts], axis=point_axis)

    def from_layout(self, arr, point_axis: int = -1):
        """A field in the padded layout (or as shards) → global order."""
        if isinstance(arr, (list, tuple)):
            arr = self.gather(arr, point_axis)
        return self.sharded_stencil.from_layout(
            _host(arr), point_axis, n_global=self.setup.n_pad)

    def device_put(self, arr, point_axis: int = -1, *, layout=False):
        """Place a global per-point array on this process's shards
        (reordering it into the padded layout first unless ``layout``);
        floating arrays take the model's dtype."""
        a = _host(arr) if layout else self.to_layout(arr, point_axis)
        ax = point_axis % a.ndim
        out = []
        for s in self.local:
            part = np.take(a, np.arange(s * self.size, (s + 1) * self.size),
                           axis=ax)
            t = torch.as_tensor(np.ascontiguousarray(part))
            if t.is_floating_point():
                t = t.to(self.setup.dtype)
            out.append(self._on(s, t))
        return out

    # -- norms ---------------------------------------------------------
    def norms(self, field, n_real: int | None = None):
        """Reproducible avg/min/max over real sea points (MPMINMAXAVG,
        mpminmaxavg.F90:44): gathered to the host in global block order
        and reduced there, so the result is the same bits for any shard
        count (the reference's LLNORMWAMOUT_GLOBAL mode)."""
        n = n_real if n_real is not None else self.setup.n_real
        v = self.from_layout(field)[..., :n]
        return dict(average=float(v.mean()), minimum=float(v.min()),
                    maximum=float(v.max()), count=int(v.size))

    def norms_device(self, parts):
        """Norms reduced on the devices (mpminmaxavg.F90:44 with
        LLNORMWAMOUT_GLOBAL=.FALSE.): each shard's sums over its real
        points, then ``all_reduce`` SUM, MIN and MAX over the process
        group where one is started; no host gather, not bit-reproducible
        across shard counts."""
        big = float(np.finfo(np.float32).max)
        dev = parts[0].device
        sums = torch.zeros(2, dtype=parts[0].dtype, device=dev)
        mn = torch.full((1,), big, dtype=parts[0].dtype, device=dev)
        mx = torch.full((1,), -big, dtype=parts[0].dtype, device=dev)
        for f, m in zip(parts, self._masks):
            part = torch.stack([torch.sum(f * m), torch.sum(m)])
            sums += part.to(dev)
            mn = torch.minimum(mn, torch.where(m > 0, f, big).min()
                               .reshape(1).to(dev))
            mx = torch.maximum(mx, torch.where(m > 0, f, -big).max()
                               .reshape(1).to(dev))
        if dist.is_initialized():
            dist.all_reduce(sums, op=dist.ReduceOp.SUM)
            dist.all_reduce(mn, op=dist.ReduceOp.MIN)
            dist.all_reduce(mx, op=dist.ReduceOp.MAX)
        tot, cnt = float(sums[0]), float(sums[1])
        return dict(average=tot / max(cnt, 1.0), minimum=float(mn[0]),
                    maximum=float(mx[0]), count=int(cnt))


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


# ---------------------------------------------------------------------------
# the cached model: row bands or patches, PROPAGS2 on the ext layout
# ---------------------------------------------------------------------------

class CachedShardedModel(ShardedModel):
    """The cached-weights model over row bands or patches.

    Each shard's ext layout is [own | halos | land]: the row bands' left
    and right slabs of ``halo`` points, or the patches' receive lists, one
    per active direction; the local stencil indexes it."""

    def __init__(self, setup, mesh, layout2d=None):
        n_shards = mesh.n_shards
        row_start = np.asarray(setup.blk.row_start)
        if layout2d is not None:
            nlat, nlon = layout2d
            if nlat * nlon != n_shards:
                raise ValueError(f"layout2d {layout2d} != {n_shards} shards")
            ss = decomp2d.build_sharded2d_stencil(setup.stencil, nlat, nlon,
                                                  row_start=row_start)
        else:
            ss = decomp.build_sharded_stencil(setup.stencil, n_shards,
                                              row_start=row_start)
        super().__init__(setup, mesh, ss)
        size = ss.shard_size
        self.layout2d = layout2d
        if layout2d is None:
            H = ss.halo
            self.ext_len = size + 2 * H + 1
            self.transfers = []
            for s in range(n_shards):
                if s > 0:               # left slab: the neighbour's tail
                    self.transfers.append(Transfer(
                        s - 1, s, slice(size - H, size),
                        slice(size, size + H)))
                if s < n_shards - 1:    # right slab: its head
                    self.transfers.append(Transfer(
                        s + 1, s, slice(0, H),
                        slice(size + H, size + 2 * H)))
        else:
            self.ext_len = ss.nland_local + 1
            offs = size + np.concatenate([[0], np.cumsum(ss.recv_sizes)])
            self.transfers = []
            for a, pairs in enumerate(ss.perm_pairs):
                take = ss.send_idx[f"send{a}"]
                for o, r in pairs:
                    # the sender's index list, on its device where it is
                    # this process's (another process's sends its own)
                    idx = (torch.as_tensor(take[o], dtype=torch.int64,
                                           device=mesh.devices[o])
                           if o in mesh.local else take[o])
                    self.transfers.append(Transfer(
                        o, r, idx, slice(int(offs[a]), int(offs[a + 1]))))
        self._stencils = {s: self._local_stencil(s) for s in self.local}
        self._st = {s: prop.stencil_tensors(self._stencils[s], setup.dtype,
                                            mesh.devices[s])
                    for s in self.local}
        self._env = {k: self.device_put(setup.env[k])
                     for k in ENV_POINT_FIELDS if k in setup.env}
        self._land = {k: setup.env[f"{k}_ext"][..., -1]
                      for k in ("wavnum", "cgroup", "omosnh2kd", "depth")}
        self._env2d = [torch.cat([self._env[k][j] for k in ipk.ENV_FIELDS])
                       .contiguous() for j in range(len(self.local))]
        self._tables = {}
        self._weights = None

    def _local_stencil(self, s):
        """Shard s's stencil over its own-first ext layout (numpy)."""
        ss, size = self.sharded_stencil, self.size
        sl = self._sl(s)

        def idx(a):
            a = np.asarray(a[sl], np.int64)
            if self.layout2d is None:   # [H | own | H | land] → own first
                H = ss.halo
                a = np.where(a < H, a + size, np.where(a < H + size, a - H,
                                                       a))
            return a
        return SimpleNamespace(
            npts=size, nland=self.ext_len - 1,
            klat=idx(ss.klat), klon=idx(ss.klon), kcor=idx(ss.kcor),
            wlat=ss.wlat[sl], wcor=ss.wcor[sl], dp=ss.dp[sl],
            zdello_pt=ss.zdello_pt[sl], xdella=ss.xdella,
            cosphm1_pt=ss.cosphm1_pt[sl], tanph_pt=ss.tanph_pt[sl],
            obslat=ss.obslat[:, sl], obslon=ss.obslon[:, sl],
            obscor=ss.obscor[:, sl])

    def ext(self, parts, land_col=None):
        """Each shard's ext layout of ``parts`` (…, size): own points, the
        exchanged halos (zeros at the ends of the chain) and the land
        slot (zero, or ``land_col``)."""
        exts = []
        for f in parts:
            e = f.new_zeros(f.shape[:-1] + (self.ext_len,))
            e[..., :self.size] = f
            if land_col is not None:
                e[..., -1] = torch.as_tensor(land_col, dtype=f.dtype,
                                             device=f.device)
            exts.append(e)
        pos = {s: j for j, s in enumerate(self.local)}
        self.halo_bytes += exchange(
            self.mesh, self.transfers, parts[0].dim() - 1,
            lambda s: parts[pos[s]], lambda s: exts[pos[s]])
        return exts

    # -- weights (CTUWUPDT + PROPDOT, cached) -----------------------------
    def refresh_weights(self, ucur=None, vcur=None):
        """Recompute the CTU weights (LUPDTWGHT); new currents come as
        global (n_pad,) arrays (GETCURR → weight refresh)."""
        setup = self.setup
        if ucur is not None:
            self._env["ucur"] = self.device_put(np.asarray(ucur)[:setup.n_pad])
            self._env["vcur"] = self.device_put(np.asarray(vcur)[:setup.n_pad])
        nfr = setup.tb.nfre_red
        env = self._env
        cg = self.ext([e[:nfr] for e in env["cgroup"]],
                      self._land["cgroup"][:nfr])
        wenv = [dict(cgroup_ext=c) for c in cg]
        if setup.irefra:
            for k, land in (("wavnum", self._land["wavnum"][:nfr]),
                            ("omosnh2kd", self._land["omosnh2kd"][:nfr]),
                            ("depth", self._land["depth"]),
                            ("ucur", None), ("vcur", None)):
                src = env[k] if k in ("depth", "ucur", "vcur") \
                    else [e[:nfr] for e in env[k]]
                for w, e in zip(wenv, self.ext(src, land)):
                    w[f"{k}_ext"] = e
        self._weights = None                   # never two sets at a time
        self._weights = [
            stp._compute_weights(setup, self._st[s], cg[j], wenv[j],
                                 stencil=self._stencils[s])
            for j, s in enumerate(self.local)]
        return self._weights

    @property
    def weights(self):
        if self._weights is None:
            self.refresh_weights()
        return self._weights

    # -- step ----------------------------------------------------------
    def _propagate(self, fl1):
        """One advection step of every shard (propag_wam.F90:240-330 with
        the cached weights), the fast-wave sub-steps in lockstep: each
        pass exchanges its input's halos first."""
        setup, tb = self.setup, self.setup.tb
        nfr, W = tb.nfre_red, self.weights
        st = [self._st[s] for s in self.local]
        out = [torch.empty_like(f) for f in fl1]
        for o, f in zip(out, fl1):
            o[:, nfr:] = f[:, nfr:]
        if setup.ifrelfmax > 0:
            nsub = max(1, round(setup.idelpro / setup.delpro_lf))
            mlf = setup.ifrelfmax
            mw = mlf + 1 if setup.irefra in (2, 3) else mlf
            ex = self.ext([f[:, mlf:nfr] for f in fl1])
            for j, e in enumerate(ex):
                prop.propags2(e, W[j][1], st[j], tb, out=out[j][:, mlf:nfr])
            win = [f[:, :mw] for f in fl1]
            for _ in range(nsub):
                ex = self.ext(win)
                lf = [prop.propags2(e, W[j][0], st[j], tb)[:, :mlf]
                      for j, e in enumerate(ex)]
                win = ([torch.cat([a, o[:, mlf:mlf + 1]], dim=1)
                        for a, o in zip(lf, out)] if mw > mlf else lf)
            for o, a in zip(out, lf):
                o[:, :mlf] = a
        else:
            ex = self.ext([f[:, :nfr] for f in fl1])
            for j, e in enumerate(ex):
                prop.propags2(e, W[j][0], st[j], tb, out=out[j][:, :nfr])
        return out

    def _tables_on(self, dev):
        if dev.type != "cuda":
            return None
        if dev not in self._tables:
            self._tables[dev] = ipk.pack_tables(self.setup.phys, dev)
        return self._tables[dev]

    def step_full(self, fl1, frc, stress):
        """Advection then full-mode physics on every shard; ``fl1`` is a
        sharded (nang, nfre, size) field, ``frc``/``stress`` dicts of
        sharded (size,) fields.  Returns (fl1, state), the state's fields
        sharded."""
        adv = self._propagate(fl1)
        out, states = [], []
        for j, f in enumerate(adv):
            env = dict(depth=self._env["depth"][j],
                       emaxdpt=self._env["emaxdpt"][j])
            f, st = stp._chunked_implsch(
                self.setup, f, self._env2d[j],
                {k: v[j] for k, v in frc.items()},
                {k: v[j] for k, v in stress.items()}, plain=False,
                tables=self._tables_on(f.device), env=env)
            out.append(f)
            states.append(st)
        return out, {k: [st[k] for st in states] for k in states[0]}


# ---------------------------------------------------------------------------
# the fused model: SRL-resident rows per shard, kernels A and B
# ---------------------------------------------------------------------------

def _shard_tables(ft, fst, s: int, size: int, span):
    """Shard s's FusedTables (local SRL coordinates) from the global
    tables and their per-shard slices ``fst`` (:mod:`.fused_shard`).

    ``srl_src`` indexes the setup's compact points (land = n_pad), so
    that env and state gather from global arrays; ``from_srl`` maps the
    shard's ``size`` layout slots (pads mirror its first point).  Body
    segments of its own rows keep the global window bases, shifted; the
    others (the adjacent rows, pads) get no taps — their output is masked
    (``valid`` 0) and overwritten by the next exchange."""
    S, EW = ft.S, ft.EW
    lo, hi, g0, g1, k0, k1 = span
    nsrl = fst.nsrl_loc
    nseg = fst.nseg_loc
    off = lo - S
    rows = slice(s * nsrl, (s + 1) * nsrl)
    row_end = np.asarray(ft.row_base) + np.asarray(ft.row_len)
    own_lo = int(ft.row_base[k0]) - off
    own_hi = int(row_end[k1 - 1]) - off

    srl_src = np.full(nsrl, ft.land_index, np.int64)
    srl_src[S:S + hi - lo] = np.asarray(ft.srl_src)[lo:hi]
    taps_dn = fst.taps_dn[rows].copy()
    taps_up = fst.taps_up[rows].copy()
    dn = np.empty(nseg, np.int64)
    up = np.empty(nseg, np.int64)
    top = nsrl - S - EW                         # the last full window
    for b in range(nseg):
        p = S + b * S                           # local SRL start
        seg = (p + off - S) // S                # its global segment
        if own_lo <= p and p + S <= own_hi:
            dn[b] = int(ft.dn_base[seg]) - off
            up[b] = int(ft.up_base[seg]) - off
            if not (0 <= dn[b] <= top and 0 <= up[b] <= top):
                raise AssertionError(
                    f"shard {s}: segment {b}'s window leaves its rows")
        else:
            dn[b] = up[b] = min(p, top)
            taps_dn[p:p + S] = 0.0
            taps_up[p:p + S] = 0.0
    nw = fst.nwrap_loc
    return pfz.FusedTables(
        S=S, EW=EW, WD=ft.WD, nseg=nseg, nsrl=nsrl, body0=S, npts=size,
        land_index=ft.land_index,
        row_base=np.asarray(ft.row_base)[max(k0 - 1, 0):k1 + 1] - off,
        row_len=np.asarray(ft.row_len)[max(k0 - 1, 0):k1 + 1],
        srl_src=srl_src.astype(np.int32),
        from_srl=fst.from_srl[s * size:(s + 1) * size],
        valid=fst.valid[rows],
        wrap_pos=fst.wrap_pos[s * nw:(s + 1) * nw],
        wrap_from=fst.wrap_from[s * nw:(s + 1) * nw],
        dn_base=dn.astype(np.int32), up_base=up.astype(np.int32),
        taps_dn=taps_dn, taps_up=taps_up,
        sea_own=fst.sea_own[rows], cgland=fst.cgland[rows],
        geom=fst.geom[rows], obs=fst.obs[rows])


class FusedShardedModel(ShardedModel):
    """The fused model over row bands (see the module docstring).

    Two step surfaces, as the reference's:

      * ``step_full`` — the compact per-shard layout in and out (float64
        capable): the spectrum goes into the shard's rows, is advected
        there and comes back; the physics runs in full mode through
        kernel C;
      * ``step_rows``/``step_rows_full`` — the kernel architecture: the
        state stays in the shards' SRL rows (``put_rows``), kernel A per
        shard and pass, kernel B per shard and physics step.
    """

    kernel_arch = True

    def __init__(self, setup, mesh):
        if setup.fused is None:
            raise ValueError("the fused sharded model needs a setup built "
                             "with weights_mode='fused'")
        n_shards = mesh.n_shards
        ft, fe = setup.fused, setup.fused_env
        kxlt = np.asarray(setup.blk.kxlt)
        row_start = np.asarray(setup.blk.row_start)
        ss = decomp.build_sharded_stencil(setup.stencil, n_shards,
                                          row_start=row_start)
        need = fsh.required_halo(ft, ss.perm, ss.g2l, ss.shard_size,
                                 n_shards, kxlt)
        if need > ss.halo:
            ss = decomp.build_sharded_stencil(setup.stencil, n_shards,
                                              row_start=row_start, halo=need)
        fst = fsh.build_fused_shard_tables(ft, fe, ss.perm, ss.g2l,
                                           ss.shard_size, n_shards, ss.halo,
                                           kxlt)
        if any(sp is None for sp in fst.spans):
            raise ValueError(f"{n_shards} shards leave one without rows")
        super().__init__(setup, mesh, ss)
        self.fused_shard_tables = fst
        size, S = ss.shard_size, ft.S
        row_end = np.asarray(ft.row_base) + np.asarray(ft.row_len)
        offs = [sp[0] - S for sp in fst.spans]
        owned = [(int(ft.row_base[sp[4]]), int(row_end[sp[5] - 1]))
                 for sp in fst.spans]
        # the adjacent rows: my span ∩ the neighbour's own rows, copied
        self.transfers = []
        for s, sp in enumerate(fst.spans):
            for n in (s - 1, s + 1):
                if not 0 <= n < n_shards:
                    continue
                a, b = max(sp[0], owned[n][0]), min(sp[1], owned[n][1])
                if a < b:
                    self.transfers.append(Transfer(
                        n, s, slice(a - offs[n], b - offs[n]),
                        slice(a - offs[s], b - offs[s])))
        self.tables = {}
        self.fps = []
        for s in self.local:
            fts = _shard_tables(ft, fst, s, size, fst.spans[s])
            rows = slice(s * fst.nsrl_loc, (s + 1) * fst.nsrl_loc)
            fes = dict(cg_srl=fst.cg_srl[rows], cg_land=fst.cg_land,
                       depth_ext=fe["depth_ext"])
            if fst.pf is not None:
                fes["pf"] = fst.pf[rows]
            self.tables[s] = fts
            self.fps.append(FusedPropagation(
                setup, ft=fts, fused_env=fes, device=mesh.devices[s]))
        env = setup.env
        self._env2d, self._denv = [], []
        for fp in self.fps:
            src = torch.as_tensor(fp.ft.srl_src, dtype=torch.int64,
                                  device=setup.device)
            self._env2d.append(torch.cat(
                [env[k + "_ext"][:, src] for k in ipk.ENV_FIELDS])
                .to(fp.device).contiguous())
            self._denv.append(torch.stack(
                [env["depth_ext"][src], env["emaxdpt_ext"][src]])
                .to(fp.device))
        # the compact step's map: SRL slot → own point (size: a zero)
        self._own_src = []
        for s, fp in zip(self.local, self.fps):
            src = np.asarray(fp.ft.srl_src, np.int64)
            real = src < setup.n_pad
            lpos = np.where(real, ss.g2l[np.minimum(src, setup.n_pad - 1)]
                            - s * size, -1)
            mine = real & (lpos >= 0) & (lpos < size)
            self._own_src.append(torch.as_tensor(
                np.where(mine, lpos, size), dtype=torch.int64,
                device=fp.device))

    # -- the exchange of the adjacent rows ---------------------------------
    def exchange_rows(self, rows):
        """Copy each shard's adjacent rows (all their storage: points,
        wraps and pads) from the neighbour that owns them, in place."""
        pos = {s: j for j, s in enumerate(self.local)}
        self.halo_bytes += exchange(self.mesh, self.transfers, 0,
                                    lambda s: rows[pos[s]],
                                    lambda s: rows[pos[s]])

    def advect_rows(self, rows):
        """One advection step of every shard's rows (in lockstep: each
        pass exchanges the adjacent rows, refreshes the wraps and runs
        kernel A, or its plain version, on each shard)."""
        for i in range(self.fps[0].nsub):
            self.exchange_rows(rows)
            for j, fp in enumerate(self.fps):
                pfz.refresh_wraps(rows[j], fp.tabs)
                rows[j] = fp.advect_pass(rows[j], i)
        return rows

    # -- weights (the refraction inputs; static currents) ------------------
    def refresh_weights(self, ucur=None, vcur=None):
        """GETCURR → the shards' refraction inputs and CFL retry again,
        from global (n_pad,) currents (irefra 2/3)."""
        if ucur is not None and self.setup.irefra in (2, 3):
            for fp in self.fps:
                fp.refresh(np.asarray(ucur, np.float64),
                           np.asarray(vcur, np.float64))
        return ()

    @property
    def weights(self):
        return ()

    # -- the compact step -------------------------------------------------
    def step_full(self, fl1, frc, stress):
        """Advection through the shards' rows, then full-mode physics on
        the compact shards; the arguments and results as
        :meth:`CachedShardedModel.step_full`."""
        setup = self.setup
        nfr, nang = setup.tb.nfre_red, setup.tb.nang
        rows = []
        for j, (fp, f) in enumerate(zip(self.fps, fl1)):
            fll = pfz.to_lanes(f, nfr, nang)
            rows.append(torch.cat([fll, fll.new_zeros((1, fp.L))])
                        [self._own_src[j]])
        self.advect_rows(rows)
        out, states = [], []
        for j, (fp, r) in enumerate(zip(self.fps, rows)):
            adv = fp.from_srl(r)
            if nfr < fl1[j].shape[1]:
                adv = torch.cat([adv, fl1[j][:, nfr:]], dim=1)
            env = dict(depth=self._denv[j][0][fp.from_srl_pad],
                       emaxdpt=self._denv[j][1][fp.from_srl_pad])
            env2d = self._env2d[j][:, fp.from_srl_pad].contiguous()
            f, st = stp._chunked_implsch(
                setup, adv, env2d, {k: v[j] for k, v in frc.items()},
                {k: v[j] for k, v in stress.items()}, plain=False,
                tables=fp._tables(adv), env=env)
            out.append(f)
            states.append(st)
        return out, {k: [st[k] for st in states] for k in states[0]}

    # -- the kernel-architecture surface ----------------------------------
    def put_rows(self, fl1):
        """Compact global (nang, nfre, n_pad) spectrum → each shard's SRL
        rows (nsrl_loc, nang·nfre_red) and diagnostic-tail rows
        (nsrl_loc, nang·(nfre − nfre_red)), or None without a tail."""
        rows, tails = [], []
        for fp in self.fps:
            f = torch.as_tensor(fl1, dtype=self.setup.dtype).to(fp.device)
            rows.append(fp.to_srl(f))
            if fp.LT:
                t = pfz.to_lanes(f[:, fp.nfre_red:],
                                 f.shape[1] - fp.nfre_red, fp.nang)
                t = torch.cat([t, t.new_zeros((1, fp.LT))])
                tails.append(t[fp.tabs["srl_src"]].contiguous())
            else:
                tails.append(None)
        return rows, tails

    def rows_to_compact(self, rows, tail):
        """Every shard's rows → the compact global (nang, nfre, n_pad)
        spectrum (all shards in this process)."""
        parts = self.rows_to_parts(rows, tail)
        return self.from_layout(parts)

    def rows_to_parts(self, rows, tail):
        """Each shard's rows → its compact (nang, nfre, size) shard (the
        layout of :func:`.multihost.save_sharded_restart`)."""
        out = []
        for fp, r, t in zip(self.fps, rows, tail):
            c = fp.from_srl(r)
            if t is not None:
                tt = t[fp.from_srl_pad].reshape(-1, fp.nang,
                                                fp.LT // fp.nang)
                c = torch.cat([c, tt.permute(1, 2, 0)], dim=1)
            out.append(c)
        return out

    def put_stress6(self, stress):
        """Global (n_pad,) stress fields → each shard's (6, nsrl_loc)
        stress rows."""
        return [fp.stress_srl({k: torch.as_tensor(_host(stress[k]))
                               for k in ipk.STRESS_KEYS})
                for fp in self.fps]

    def stress6_to_dict(self, s6):
        return {k: self.from_layout(self.state_parts(s6, i))
                for i, k in enumerate(ipk.STRESS_KEYS)}

    def state_parts(self, srl_rows, i=None):
        """Each shard's own points of per-SRL-row fields (row ``i`` of a
        block, or the field itself) → sharded (size,) fields."""
        return [fp.extract_state(r if i is None else r[i])
                for fp, r in zip(self.fps, srl_rows)]

    def put_forcing(self, frc):
        """Global (n_pad,) forcing fields → each shard's (6, nsrl_loc)
        forcing rows (rebuilt per wind date)."""
        return [fp.frc_srl({k: torch.as_tensor(_host(v), dtype=fp.dtype,
                                               device=fp.device)
                            for k, v in frc.items()}) for fp in self.fps]

    def _forcing(self, frc):
        return self.put_forcing(frc) if isinstance(frc, dict) else frc

    def step_rows(self, rows, tail, stress6, frc, *, phys: bool = True):
        """Fast step (between output dates, wamintgr.F90:94-146): the
        advection, then minimal-mode physics through kernel B on every
        shard (``phys`` False: the advection alone, a step between
        physics steps where idelpro < idelt).  ``frc`` is
        :meth:`put_forcing`'s rows or a dict of global fields.  Returns
        (rows, tail, stress6)."""
        frc6 = self._forcing(frc)
        self.advect_rows(rows)
        if not phys:
            return rows, tail, stress6
        for j, fp in enumerate(self.fps):
            rows[j], stress6[j], tail[j] = fp.phys_srl(
                rows[j], stress6[j], frc6[j], self._denv[j],
                self._env2d[j], tail[j])
        return rows, tail, stress6

    def step_rows_full(self, rows, tail, stress6, frc):
        """Output-date step: the advection, then full-mode physics chunked
        over each shard's rows with the windsea/swell split.  Returns
        (rows, tail, stress6, state), the state's fields (and its ``sep``
        rows) sharded over own points."""
        frc6 = self._forcing(frc)
        self.advect_rows(rows)
        states = []
        for j, fp in enumerate(self.fps):
            rows[j], stress6[j], tail[j], st = fp.phys_srl_full_chunked(
                rows[j], stress6[j], frc6[j], self._denv[j],
                self._env2d[j], tail[j])
            states.append(st)
        state = {k: self.state_parts([st[k] for st in states])
                 for k in states[0] if k != "sep"}
        state["sep"] = {k: self.state_parts([st["sep"][k] for st in states])
                        for k in states[0]["sep"]}
        return rows, tail, stress6, state


def build_sharded_model(setup, mesh: PointMesh,
                        layout2d: tuple | None = None) -> ShardedModel:
    """The sharded model of ``setup`` over ``mesh``'s shards.

    ``weights_mode`` 'fused' gives :class:`FusedShardedModel` (row bands
    only: ``layout2d`` is refused, as the reference refuses it), 'cached'
    :class:`CachedShardedModel` over row bands or, with ``layout2d=(nlat,
    nlon)``, the reference's 2-D patches (mpdecomp.F90 LL1D=.FALSE.) with
    the gather-based exchange."""
    if setup.weights_mode == "fused":
        if layout2d is not None:
            raise NotImplementedError(
                "fused sharded propagation supports the 1-D row-band "
                "decomposition; use layout2d with weights_mode='cached'")
        return FusedShardedModel(setup, mesh)
    if setup.weights_mode != "cached":
        raise NotImplementedError(
            f"weights_mode={setup.weights_mode!r}: the sharded models are "
            "'fused' and 'cached'")
    return CachedShardedModel(setup, mesh, layout2d)
