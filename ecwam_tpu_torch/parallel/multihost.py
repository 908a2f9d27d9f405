"""Multi-process scaffolding: process group, the ring of shards, sharded
restarts and the writer-rank output.

Port of ``ecwam_tpu/parallel/multihost.py`` on ``torch.distributed``.  The
reference scales over nodes with MPI (mpdecomp.F90 rank tables,
mpexchng.F90 inter-node sends); here:

  - :func:`init_distributed` starts the process group (the MPL_INIT role,
    chief.F90:111-114): NCCL when the shards live on cards, gloo when they
    live on the CPU, never the one in place of the other;
  - :func:`make_point_mesh` is the ordered ring of shards, host-major:
    each rank's shards are contiguous, so that of the 2·(n_shards − 1)
    halo edges only 2·(n_ranks − 1) cross a process boundary.  A list of
    devices names this rank's shards, and may name one card several times
    (several shards on one device, as the reference proves its sharded
    path on XLA's virtual host devices);
  - per-rank restart files (savspec.F90:96-115 LRSTPARALW ``.%p_%n``):
    each rank writes only its own shards; the reader reassembles the
    global state from any file set, so a run restarts at another shard
    count (getspec.F90:673-728).  The files are the reference's, name and
    npz layout, so that either package reads the other's;
  - :func:`write_distributed_fields`, OUTGRID's writer-rank split.

Everything works in one process (the degenerate NPROC = 1 case, no
process group needed).
"""

from __future__ import annotations

import dataclasses
import glob
import os
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

# the group's timeout: an exchange whose peer died fails within it
GROUP_TIMEOUT_S = 120.0


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     backend: str | None = None,
                     timeout_s: float = GROUP_TIMEOUT_S) -> None:
    """Start the process group (no-op for one process unless a
    ``backend`` is named).

    ``coordinator_address`` is ``host:port`` (or a ``tcp://`` URL) of rank
    0's store.  ``backend`` None takes NCCL where CUDA is available and
    gloo otherwise; a failure to start raises (NCCL is never replaced by
    gloo).  A named backend starts a group even for one process, as the
    card's world-size-1 NCCL check does."""
    if dist.is_initialized():
        raise RuntimeError("the process group is already initialized")
    n = 1 if num_processes is None else int(num_processes)
    if n <= 1 and backend is None:
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if coordinator_address is None:
        raise ValueError("init_distributed needs the coordinator address")
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    dist.init_process_group(backend=backend, init_method=url, world_size=n,
                            rank=int(process_id or 0),
                            timeout=timedelta(seconds=timeout_s))


def shutdown() -> None:
    """Destroy the process group if one was started."""
    if dist.is_initialized():
        dist.destroy_process_group()


def rank() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    """The number of processes (1 without a process group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


@dataclasses.dataclass(frozen=True)
class PointMesh:
    """The ring of shards: shard i lives on ``devices[i]`` of rank
    ``ranks[i]``, in host-major order; ``rank`` is this process's."""

    ranks: tuple
    devices: tuple            # torch.device of each shard (this rank's
    #                           real ones; others' as their ranks named)
    rank: int = 0

    @property
    def n_shards(self) -> int:
        return len(self.ranks)

    @property
    def local(self) -> tuple:
        """The shard indices this process owns, in ring order."""
        return tuple(i for i, r in enumerate(self.ranks) if r == self.rank)

    @property
    def multiprocess(self) -> bool:
        return len(set(self.ranks)) > 1


def make_point_mesh(devices=None) -> PointMesh:
    """The host-major ring over every rank's shards.

    ``devices`` lists this rank's shards' devices (names or torch
    devices); None takes one shard per visible card.  With a process
    group every rank's list is gathered, and the ring is rank 0's shards,
    then rank 1's, and so on."""
    if devices is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("no card visible: name the devices "
                               "(e.g. ['cpu', 'cpu'])")
        devices = [torch.device("cuda", i) for i in range(n)]
    devs = [torch.device(d) for d in devices]
    if not devs:
        raise ValueError("a mesh needs at least one shard")
    me, world = rank(), world_size()
    names = [str(d) for d in devs]
    if world > 1:
        every = [None] * world
        dist.all_gather_object(every, names)
    else:
        every = [names]
    ranks, all_devs = [], []
    for r, lst in enumerate(every):
        for name in lst:
            ranks.append(r)
            all_devs.append(torch.device(name))
    return PointMesh(ranks=tuple(ranks), devices=tuple(all_devs), rank=me)


def _shard_file(dirpath: str, date14: str, name: str, s: int,
                n: int) -> str:
    """savspec.F90:101 '.%p_%n' parallel-file naming."""
    return os.path.join(dirpath, f"BLS{date14}.{name}.{s + 1}_{n}")


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def save_sharded_restart(dirpath: str, date14: str, sm, fl1,
                         stress: dict) -> list[str]:
    """Per-rank parallel restart write (LRSTPARALW, savspec.F90:96-115).

    ``fl1`` is the model's spectrum as this rank's shards (a list of
    (nang, nfre, shard_size) tensors, the compact layout of
    ``ShardedModel.device_put``), ``stress`` a dict of such lists of
    (shard_size,) tensors.  Each shard goes into one .npz holding its
    slice and the global indices it covers (``perm``, −1 for its pads),
    which makes the reader independent of the layout."""
    os.makedirs(dirpath, exist_ok=True)
    ss = sm.sharded_stencil
    n_shards = ss.n_shards
    written = []
    for j, s in enumerate(sm.mesh.local):
        lo = s * ss.shard_size
        payload = dict(fl1=_host(fl1[j]),
                       perm=ss.perm[lo: lo + ss.shard_size])
        for k, v in stress.items():
            payload[f"stress_{k}"] = _host(v[j])
        fn = _shard_file(dirpath, date14, "w", s, n_shards) + ".npz"
        np.savez_compressed(fn, **payload)
        written.append(fn)
    return written


def load_sharded_restart(dirpath: str, date14: str, n_global: int):
    """Reassemble the global (block-ordered) state from any parallel
    restart file set, whatever the writer's shard count
    (getspec.F90:673-728 redistribution).

    Returns (fl1_global, stress_global_dict) as numpy arrays over the
    global point axis; the caller places them with its own model
    (``device_put``) or uses them on one device."""
    files = sorted(glob.glob(os.path.join(dirpath,
                                          f"BLS{date14}.w.*_*.npz")))
    if not files:
        raise FileNotFoundError(
            f"no parallel restart files BLS{date14}.w.* in {dirpath}")
    fl1_g = None
    stress_g: dict = {}
    for fn in files:
        with np.load(fn) as z:
            perm = z["perm"]
            own = perm >= 0
            gidx = perm[own]
            shard_fl1 = z["fl1"]
            if fl1_g is None:
                fl1_g = np.zeros(shard_fl1.shape[:-1] + (n_global,),
                                 shard_fl1.dtype)
            fl1_g[..., gidx] = shard_fl1[..., own]
            for k in z.files:
                if not k.startswith("stress_"):
                    continue
                name = k[len("stress_"):]
                if name not in stress_g:
                    stress_g[name] = np.zeros(n_global, z[k].dtype)
                stress_g[name][gidx] = z[k][own]
    return fl1_g, stress_g


def write_distributed_fields(rundir: str, date14: str, fields: dict,
                             outctl, blk, grid, *,
                             process_index: int | None = None,
                             num_processes: int | None = None) -> list[str]:
    """OUTGRID writer-rank output (outgrid.F90:64-212 role).

    Each output field is assigned a writer process by the IPFGTBL
    round-robin (io/outcontrol.py); this process GRIB-encodes and writes
    only the fields it owns, into its own ``MPP<date>.w<rank>.grib`` so
    no two writers touch the same file.  ``fields`` must be host-global
    (n_real,) arrays (``ShardedModel.from_layout`` gathers them, the
    MPGATHERFL role).

    Writer ranks beyond the process count wrap around, so the same
    config works at any NPROC (mpcrtbl.F90:481-484 wraps at NPROC too).
    """
    from ecwam_tpu_torch.io import gribout

    pid = rank() if process_index is None else process_index
    npr = world_size() if num_processes is None else num_processes
    os.makedirs(rundir, exist_ok=True)

    mine = {}
    for name, vals in fields.items():
        r = outctl.writer_rank(name)
        if r < 0:                       # norms-only field — nobody writes
            continue
        if r % npr == pid:
            mine[name] = vals
    if not mine:
        return []
    fn = os.path.join(rundir, f"MPP{date14}.w{pid}.grib")
    gribout.write_fields(fn, mine, blk, grid, date14)
    return [fn]
