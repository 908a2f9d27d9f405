"""Model assembly: grid + spectra + physics + fused propagation tables.

Port of ``ecwam_tpu/model/setup.py``: the reference's init chain
(runwam.F90:235-257, initmdl.F90) as one host-side build of numpy
tables, with the env arrays as torch tensors on the chosen device, for
the three weight modes of the reference (``fused``: the SRL tables of
kernel A; ``cached``/``otf``: the dense CTU weights of ``model.stepper``).

  - the sea-point axis is padded to a multiple of ``pad_to``; padded
    points replicate point 0 and are excluded from norms/outputs by
    ``n_real``;
  - index ``n_pad`` is the land slot of the ``*_ext`` arrays.

:func:`setup_from_arrays` assembles a setup from the tables and env of
an ``ecwam_tpu`` ModelSetup passed as numpy arrays, so that both
packages can be fed identical tables.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from wavebench.reference.ecw.core import dispersion
from wavebench.reference.ecw.core import physparams as pp
from wavebench.reference.ecw.core.grid import (WaveGrid, SeaPointBlock, aqua_bathymetry,
                                 build_sea_point_block, octahedral_grid,
                                 regular_grid)
from wavebench.reference.ecw.core.spectral import SpectralTables, build_spectral_tables
from wavebench.reference.ecw.device import resolve
from wavebench.reference.ecw.ops import propagation as prop
from wavebench.reference.ecw.ops import propagation_fused as pfz
from wavebench.reference.ecw.ops.physics import implsch as impl

# env fields built from the dispersion relation (core/dispersion.py)
PROPS = ("wavnum", "cinv", "cgroup", "xk2cg", "omosnh2kd", "stokfac")


@dataclasses.dataclass(frozen=True)
class ModelSetup:
    grid: WaveGrid
    blk: SeaPointBlock
    tb: SpectralTables
    phys: impl.PhysicsConfig
    stencil: prop.StencilTables
    n_real: int
    n_pad: int
    idelpro: float            # advection timestep (s)
    idelt: float              # physics timestep (s)
    delpro_lf: float          # fast-wave substep (s); = idelpro if unused
    ifrelfmax: int            # number of fast-wave frequencies (0 = none)
    irefra: int
    env: dict                 # env tensors (padded, + _ext variants)
    dtype: torch.dtype
    device: torch.device
    # 'fused' only: the SRL tables of kernel A and their host statics
    # (cg_srl, cg_land, depth_ext, pf); None in the dense modes
    fused: pfz.FusedTables | None = None
    fused_env: dict | None = None
    # the memory knobs of the dense modes (model/stepper.py): 'cached'
    # keeps the CTU weights resident (17 or 19 planes per bin,
    # propag_wam.F90 LUPDTWGHT), 'otf' recomputes them per block of
    # ``otf_block`` frequencies every step; ``phys_chunk`` splits the
    # point axis of the physics into NPROMA chunks (mchunk.F90:44-45),
    # 0 = one chunk
    weights_mode: str = "fused"
    otf_block: int = 1
    phys_chunk: int = 0


def _pad_stencil(st: prop.StencilTables, n_real: int,
                 n_pad: int) -> prop.StencilTables:
    """Extend stencil to the padded point count; padded points are isolated
    (all neighbours = land) and the land slot moves to n_pad."""
    def remap_idx(a, extra_shape):
        out = np.full((n_pad,) + extra_shape, n_pad, dtype=a.dtype)
        out[:n_real] = np.where(a == st.nland, n_pad, a)
        return out

    def pad_pt(a):
        out = np.empty((n_pad,) + a.shape[1:], dtype=a.dtype)
        out[:n_real] = a
        out[n_real:] = a[0]
        return out

    def pad_freq_pt(a):
        # (nfre, npts, …) → pad the point axis
        out = np.empty((a.shape[0], n_pad) + a.shape[2:], dtype=a.dtype)
        out[:, :n_real] = a
        out[:, n_real:] = a[:, :1]
        return out

    return prop.StencilTables(
        npts=n_pad, nland=n_pad,
        klat=remap_idx(st.klat, (2, 2)), klon=remap_idx(st.klon, (2,)),
        kcor=remap_idx(st.kcor, (4, 2)),
        wlat=pad_pt(st.wlat), wlatm1=pad_pt(st.wlatm1),
        wcor=pad_pt(st.wcor), wcorm1=pad_pt(st.wcorm1),
        dp=pad_pt(st.dp),
        zdello_pt=pad_pt(st.zdello_pt), xdella=st.xdella,
        cosphm1_pt=pad_pt(st.cosphm1_pt), tanph_pt=pad_pt(st.tanph_pt),
        obslat=pad_freq_pt(st.obslat), obslon=pad_freq_pt(st.obslon),
        obscor=pad_freq_pt(st.obscor))


def _env_tensors(props_ext: dict, depth_ext: np.ndarray, n_pad: int,
                 dtype, device, ucur_ext=None, vcur_ext=None) -> dict:
    """Env dict: ``<k>_ext`` (nfre, n_pad+1) tensors with ``<k>`` the
    (nfre, n_pad) view without the land slot, plus the per-point depth /
    emaxdpt and surface currents (zero without currents, land slot
    zero)."""
    def t(a):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)
    env = {}
    for k, v in props_ext.items():
        env[f"{k}_ext"] = t(np.asarray(v).T)
        env[k] = env[f"{k}_ext"][:, :n_pad]
    env["depth_ext"] = t(depth_ext)
    env["depth"] = env["depth_ext"][:n_pad]
    env["emaxdpt_ext"] = t(dispersion.depth_limited_energy(depth_ext))
    env["emaxdpt"] = env["emaxdpt_ext"][:n_pad]
    zeros = np.zeros(n_pad + 1)
    for k, v in (("ucur", ucur_ext), ("vcur", vcur_ext)):
        env[f"{k}_ext"] = t(zeros if v is None else v)
        env[k] = env[f"{k}_ext"][:n_pad]
    return env


def _fused_env(ft: pfz.FusedTables, props_ext: dict, depth_ext, nfre_red,
               irefra) -> dict:
    """Host-side SRL statics of the fused step."""
    src = np.asarray(ft.srl_src)
    cg = np.asarray(props_ext["cgroup"])           # (n_pad+1, nfre)
    out = {"cg_srl": cg[src][:, :nfre_red], "cg_land": cg[-1, :nfre_red],
           "depth_ext": depth_ext}
    if irefra:
        omos = np.asarray(props_ext["omosnh2kd"])
        wav = np.asarray(props_ext["wavnum"])
        pf = np.stack([omos, cg * wav, omos * wav], axis=1)
        out["pf"] = pf[src][:, :, :nfre_red]
    return out


def build_model(
    *,
    grid_name: str | None = None,
    grid: WaveGrid | None = None,
    bathy: np.ndarray | None = None,
    nang: int = 12,
    nfre: int = 25,
    nfre_red: int | None = None,
    idelpro: float = 900.0,
    idelt: float = 900.0,
    delpro_lf: float | None = None,
    ifrelfmax: int = 0,
    iphys: int = 1,
    irefra: int = 0,
    isnonlin: int = 1,
    icode_wnd: int = 3,
    llgcbz0: bool = False,
    llnormagam: bool = False,
    llcapchnk: bool = False,
    lciwa3: bool = False,
    lciscal: bool = False,
    pad_to: int = 128,
    dtype: torch.dtype = torch.float32,
    obstructions=None,
    currents: tuple | None = None,
    weights_mode: str = "fused",
    otf_block: int = 1,
    phys_chunk: int = 0,
    cache_dir: str | None = None,
    device: str | torch.device | None = None,
) -> ModelSetup:
    """Build a complete single-domain model.

    ``weights_mode``: ``fused`` (the default here; the reference's is
    ``cached``) builds the SRL tables of kernel A for ``FastWaveModel``
    and ``WaveModel``'s fused mode; ``cached`` and ``otf`` build none, for
    ``WaveModel``'s dense CTU weights (``otf_block`` frequencies a block in
    ``otf``).  ``phys_chunk``: points a physics chunk of ``WaveModel``
    (0: all).  ``cache_dir``: an on-disk cache of the host tables (stencil,
    SRL tables, dispersion env) keyed by the build inputs
    (:mod:`.tablecache`, the PREPROC write-once artifact).
    ``device`` names where the env tensors live: ``"cuda"`` (the
    default, None) or ``"cpu"``; the numpy tables stay on the host.
    ``currents``: optional (u, v) surface-current fields over the sea
    points (n_real,), used when ``irefra`` ∈ {2, 3} (GETCURR).  The five
    physics flags select ECMWF's cycle-49/50 options: the
    gravity-capillary roughness closure (``llgcbz0``), normalised growth
    (``llnormagam``), the capped Charnock parameter (``llcapchnk``), the
    SDICE3 sea-ice attenuation (``lciwa3``) and the sea-ice scaling of the
    sources (``lciscal``); ``iphys`` 0/1 and ``isnonlin`` 0/1/2 select the
    input physics and the DIA enhancement.  As in the reference, the
    options without a keyword here (SDICE1/2, LSTRN, LBIWBK, LICERUN,
    LMASKICE) are set on the returned setup's ``phys``
    (``cases.with_phys``).
    """
    if weights_mode not in ("fused", "cached", "otf"):
        raise ValueError(f"weights_mode={weights_mode!r}: fused, cached or "
                         "otf")
    if irefra not in (0, 1, 2, 3):
        raise ValueError(f"irefra={irefra}")
    dev = resolve(device)
    if grid is None:
        if grid_name is None:
            raise ValueError("need grid or grid_name")
        grid = (octahedral_grid(int(grid_name[1:]))
                if grid_name.startswith("O") else regular_grid(float(grid_name)))
    if bathy is None:
        bathy = aqua_bathymetry(grid)
    nfre_red = nfre_red or nfre
    if ifrelfmax >= nfre_red:
        raise ValueError("ifrelfmax must be < nfre_red (propag_wam.F90:257)")
    if irefra in (2, 3) and ifrelfmax and weights_mode == "otf":
        raise NotImplementedError(
            "current refraction + fast-wave substepping is supported in "
            "the 'fused' and 'cached' weights modes only")

    tb = build_spectral_tables(nang=nang, nfre=nfre, nfre_red=nfre_red)
    params = pp.set_phys_params(iphys, nang=nang, llgcbz0=llgcbz0,
                                llnormagam=llnormagam, llcapchnk=llcapchnk)
    phys = impl.make_physics_config(tb, params, idelt, nfre_red=nfre_red,
                                    isnonlin=isnonlin, icode_wnd=icode_wnd,
                                    lciwa3=lciwa3, lciscal=lciscal)

    # segment size scales with the typical row length (16..128)
    seg = 1 << max(4, min(7, int(np.log2(max(16, grid.ngx // 4)))))
    fused = weights_mode == "fused"
    cached = cache_key = None
    if cache_dir is not None:
        from wavebench.reference.ecw.model import tablecache
        cache_key = tablecache.build_key(
            grid, bathy, nang=nang, nfre=nfre, nfre_red=nfre_red,
            pad_to=pad_to, seg=seg if fused else 0,
            obstructions=obstructions)
        cached = tablecache.load(
            cache_dir, cache_key, blk_cls=SeaPointBlock,
            st_cls=prop.StencilTables, ft_cls=pfz.FusedTables)
    if cached is not None:
        blk, st_real, ft, props_ext = cached
        n_real = blk.nsea
        n_pad = ((n_real + pad_to - 1) // pad_to) * pad_to
    else:
        blk = build_sea_point_block(grid, bathy)
        n_real = blk.nsea
        n_pad = ((n_real + pad_to - 1) // pad_to) * pad_to
        st_real = prop.build_stencil(grid, blk, nfre_red,
                                     obstructions=obstructions)
        ft = (pfz.build_fused_tables(st_real, blk.kxlt, nfre_red, S=seg,
                                     land_index=n_pad) if fused else None)
    depth = np.empty(n_pad)
    depth[:n_real] = blk.depth
    depth[n_real:] = blk.depth[0]
    depth_ext = np.concatenate([depth, [dispersion.BATHYMAX]])
    if cached is None:
        props_ext = dispersion.depth_properties(depth_ext, tb.fr)
        if cache_dir is not None:
            tablecache.save(cache_dir, cache_key, blk=blk, stencil=st_real,
                            fused=ft, props=props_ext)
    uc, vc = np.zeros(n_pad + 1), np.zeros(n_pad + 1)
    if currents is not None:
        uc[:n_real], vc[:n_real] = currents[0], currents[1]

    return ModelSetup(
        grid=grid, blk=blk, tb=tb, phys=phys,
        stencil=_pad_stencil(st_real, n_real, n_pad),
        n_real=n_real, n_pad=n_pad, idelpro=idelpro, idelt=idelt,
        delpro_lf=delpro_lf or idelpro, ifrelfmax=ifrelfmax, irefra=irefra,
        env=_env_tensors(props_ext, depth_ext, n_pad, dtype, dev, uc, vc),
        dtype=dtype, device=dev, fused=ft,
        fused_env=(_fused_env(ft, props_ext, depth_ext, nfre_red, irefra)
                   if fused else None),
        weights_mode=weights_mode, otf_block=otf_block,
        phys_chunk=phys_chunk)


def setup_from_arrays(*, grid, blk, tb, params, stencil: dict, fused: dict,
                      env: dict, n_real: int, n_pad: int, idelpro: float,
                      idelt: float, delpro_lf: float, ifrelfmax: int,
                      irefra: int, isnonlin: int = 1, icode_wnd: int = 3,
                      lciwa3: bool = False, lciscal: bool = False,
                      dtype: torch.dtype = torch.float32,
                      device: str | torch.device | None = None
                      ) -> ModelSetup:
    """A setup from another build's tables, all as host numpy.

    ``stencil``/``fused`` are the field dicts of the (padded)
    StencilTables / FusedTables; ``env`` holds the ``<prop>_ext``
    (nfre, n_pad+1) arrays, ``depth_ext`` and ``ucur_ext``/``vcur_ext``
    — the reference ModelSetup's layout.  Physics tables are rebuilt from
    ``tb`` and ``params`` (pure numpy, identical in both packages; the
    gravity-capillary flags ride in ``params``)."""
    dev = resolve(device)
    ft = pfz.FusedTables(**fused)
    props_ext = {k: np.asarray(env[f"{k}_ext"], np.float64).T for k in PROPS}
    depth_ext = np.asarray(env["depth_ext"], np.float64)
    phys = impl.make_physics_config(tb, params, idelt,
                                    nfre_red=tb.nfre_red, isnonlin=isnonlin,
                                    icode_wnd=icode_wnd, lciwa3=lciwa3,
                                    lciscal=lciscal)
    cur = [np.asarray(env[k], np.float64) if k in env else None
           for k in ("ucur_ext", "vcur_ext")]
    return ModelSetup(
        grid=grid, blk=blk, tb=tb, phys=phys,
        stencil=prop.StencilTables(**stencil), n_real=n_real, n_pad=n_pad,
        idelpro=idelpro, idelt=idelt, delpro_lf=delpro_lf,
        ifrelfmax=ifrelfmax, irefra=irefra,
        env=_env_tensors(props_ext, depth_ext, n_pad, dtype, dev, *cur),
        dtype=dtype, device=dev, fused=ft,
        fused_env=_fused_env(ft, props_ext, depth_ext, tb.nfre_red, irefra))


def pad_point_field(setup: ModelSetup, values: np.ndarray) -> np.ndarray:
    """Pad a (…, n_real) host field to n_pad by replicating point 0."""
    out = np.empty(values.shape[:-1] + (setup.n_pad,), dtype=values.dtype)
    out[..., : setup.n_real] = values
    out[..., setup.n_real:] = values[..., :1]
    return out
