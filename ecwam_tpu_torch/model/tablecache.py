"""On-disk cache of the host-built model tables (PREPROC write-once).

Copied from ``ecwam_tpu/model/tablecache.py`` (numpy only, no JAX),
with one deliberate difference: :func:`build_key` hashes each obstruction
array on its own, with its shape and dtype, where the original hashes
them after broadcasting them together (which fails for tables that do not
broadcast and maps a table and its broadcast copy to one key).

The reference preprocesses each grid once and reuses the artifact
(preproc writing wam_grid_tables read back by READPRE,
outcom.F90, readpre.F90); here the expensive
host products of ``build_model`` — the propagation stencil, the fused
SRL tables and the dispersion env — are stored in one .npz keyed by a
hash of everything that determines them (grid + bathymetry + spectral
discretization + obstruction tables).

Constant arrays (e.g. all-ones obstruction tables on unobstructed
grids, which at O1280 would dominate the file at ~10 GB) are stored as
a scalar + shape marker.  Floats keep their build dtype so cached and
fresh builds are bit-identical.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os

import numpy as np


CACHE_VERSION = 1


def build_key(grid, bathy: np.ndarray, *, nang: int, nfre: int,
              nfre_red: int, pad_to: int, seg: int,
              obstructions) -> str:
    """Hash of the build inputs that determine the cached tables."""
    h = hashlib.sha256()
    h.update(f"v{CACHE_VERSION}".encode())
    h.update(f"{grid.name},{grid.ngx},{grid.ngy},{grid.amowep},"
             f"{grid.amoeap},{grid.amosop},{grid.amonop},{grid.xdella},"
             f"{grid.iper},{grid.irgg}".encode())
    h.update(np.asarray(grid.nlonrgg).tobytes())
    h.update(np.asarray(grid.zdello).tobytes())
    h.update(np.ascontiguousarray(bathy).tobytes())
    h.update(f"{nang},{nfre},{nfre_red},{pad_to},{seg}".encode())
    if obstructions is not None:
        items = (sorted(obstructions.items()) if isinstance(obstructions, dict)
                 else enumerate(obstructions))
        for name, v in items:
            a = np.ascontiguousarray(v)
            h.update(f"{name}:{a.shape}:{a.dtype.str};".encode())
            h.update(a.tobytes())
    return h.hexdigest()[:24]


def _flatten(prefix: str, obj, out: dict):
    """Dataclass / dict of arrays+scalars → flat npz-compatible dict.
    Constant arrays become '<key>@const' (value) + '<key>@shape'."""
    if dataclasses.is_dataclass(obj):
        items = [(f.name, getattr(obj, f.name))
                 for f in dataclasses.fields(obj)]
    elif isinstance(obj, dict):
        items = list(obj.items())
    else:
        raise TypeError(f"cannot flatten {type(obj)}")
    for name, v in items:
        key = f"{prefix}.{name}"
        if isinstance(v, (int, float, np.integer, np.floating)):
            out[key + "@scalar"] = np.asarray(v)
        elif isinstance(v, np.ndarray):
            if v.size > 1024 and np.all(v == v.flat[0]):
                out[key + "@const"] = np.asarray(v.flat[0])
                out[key + "@shape"] = np.asarray(v.shape)
            else:
                out[key] = v
        elif v is None:
            out[key + "@none"] = np.asarray(0)
        else:
            raise TypeError(f"cannot serialize field {key}: {type(v)}")
    return out


def _unflatten(prefix: str, data: dict) -> dict:
    out = {}
    plen = len(prefix) + 1
    for key in data.files if hasattr(data, "files") else data.keys():
        if not key.startswith(prefix + "."):
            continue
        name = key[plen:]
        if name.endswith("@scalar"):
            v = data[key][()]
            out[name[:-7]] = v.item() if isinstance(v, np.generic) else v
        elif name.endswith("@const"):
            base = name[:-6]
            shape = tuple(data[f"{prefix}.{base}@shape"])
            out[base] = np.full(shape, data[key][()],
                                dtype=data[key].dtype)
        elif name.endswith("@shape") or name.endswith("@none"):
            if name.endswith("@none"):
                out[name[:-5]] = None
        else:
            out[name] = data[key]
    return out


def save(cache_dir: str, key: str, *, blk, stencil, fused, props: dict,
         log=None):
    os.makedirs(cache_dir, exist_ok=True)
    flat: dict = {}
    _flatten("blk", blk, flat)
    _flatten("st", stencil, flat)
    if fused is not None:
        _flatten("ft", fused, flat)
    _flatten("props", props, flat)
    path = os.path.join(cache_dir, f"wamtables_{key}.npz")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, path)
    if log:
        log(f"table cache written: {path} "
            f"({os.path.getsize(path)/1e9:.2f} GB)")
    return path


def load(cache_dir: str, key: str, *, blk_cls, st_cls, ft_cls, log=None):
    """Returns (blk, stencil, fused, props) or None on miss."""
    path = os.path.join(cache_dir, f"wamtables_{key}.npz")
    if not os.path.exists(path):
        return None
    data = np.load(path, allow_pickle=False)
    blk = blk_cls(**_unflatten("blk", data))
    st = st_cls(**_unflatten("st", data))
    ft_fields = _unflatten("ft", data)
    fused = ft_cls(**ft_fields) if ft_fields else None
    props = _unflatten("props", data)
    if log:
        log(f"table cache hit: {path}")
    return blk, st, fused, props
