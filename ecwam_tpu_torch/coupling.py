"""Coupling surface: wave ⇄ atmosphere / ocean field exchange.

Port of ``ecwam_tpu/coupling.py``, the functional re-derivation of the
reference's coupled-mode interfaces:

  - **atmosphere → wave**: the WAVEMDL argument forcing block
    (wavemdl.F90:10-24 FIELDS/NFIELDS; decoded per wind period in
    PREWIND/WAMWND) — here a plain dict push that feeds the driver's
    NEWWIND staging.
  - **wave → atmosphere**: the WVFLDG return block assembled at
    wavemdl.F90:679-760 — Charnock, surface Stokes drift, dimensional
    energy/momentum fluxes to the ocean, windsea variance and mean
    frequency, with the reference's default values (DEFVAL) applied at
    ice-covered points.
  - **wave → ocean (NEMO)**: the WAM2NEMO fields shipped by
    UPDNEMOFIELDS (updnemofields.F90:74-95): SWH, mean period, φ_eps,
    τ_oc, Stokes drift, sea-ice mean-square strain.
  - **ocean → wave (NEMO)**: RECVNEMOFIELDS (recvnemofields.F90): sea-ice
    cover/thickness and surface currents; new currents re-derive the CTU
    weights exactly as GETCURR sets LUPDTWGHT.

The wrapped model is the port's dense :class:`~ecwam_tpu_torch.model.
driver.WaveModel` on the setup's device, in the setup's weight mode (the
port's default, ``fused``, advects through kernel A; the physics runs
through kernel C).  The caller exchanges (n_real,) host arrays on the
wave model's own sea-point block: pushes are staged on the host and
reach the device through the driver's forcing swap, and the returned
blocks are copied to the host explicitly.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ecwam_tpu_torch.io import products
from ecwam_tpu_torch.model import driver as driver_mod

PRCHAR = 0.018          # default Charnock for uncovered points (wavemdl DEFVAL)
CITHRSH = 0.3           # ice threshold (yowice CITHRSH role)


@dataclasses.dataclass
class Wave2Atmosphere:
    """WVFLDG block (wavemdl.F90:688-746), one array per FLABEL."""

    charnock: np.ndarray     # ' Charnock'
    ustokes: np.ndarray      # ' U-Stokes'
    vstokes: np.ndarray      # ' V-Stokes'
    phiocd: np.ndarray       # ' Phi_ocd'  dimensional energy flux to ocean
    tauocx: np.ndarray       # ' Tau_ocx'  dimensional momentum flux to ocean
    tauocy: np.ndarray       # ' Tau_ocy'
    wsemean: np.ndarray      # ' WSEmean'  windsea variance
    wsfmean: np.ndarray      # ' WSFmean'  windsea mean frequency


@dataclasses.dataclass
class Wave2Ocean:
    """WAM2NEMO block (updnemofields.F90:74-95)."""

    nswh: np.ndarray         # significant wave height
    nmwp: np.ndarray         # mean wave period
    nphieps: np.ndarray      # normalised energy flux to ocean
    ntauoc: np.ndarray       # normalised momentum flux to ocean
    nustokes: np.ndarray
    nvstokes: np.ndarray
    nemostrn: np.ndarray | None = None    # sea-ice mean square strain


@dataclasses.dataclass
class Ocean2Wave:
    """RECVNEMOFIELDS block: NEMO state pushed into the wave model."""

    cicover: np.ndarray | None = None
    cithick: np.ndarray | None = None
    ucur: np.ndarray | None = None
    vcur: np.ndarray | None = None


def _host(x, n: int) -> np.ndarray:
    """The first ``n`` values of a tensor (any device) or array as a new
    float64 host array."""
    if hasattr(x, "detach"):
        return x.detach()[:n].double().cpu().numpy().copy()
    return np.array(np.asarray(x, np.float64)[:n])


class CoupledWaveModel:
    """WAVEMDL-role supervisor for two-way coupled stepping.

    Wraps the port's :class:`~ecwam_tpu_torch.model.driver.WaveModel`
    whose forcing provider reads from an internal staging buffer that the
    atmosphere caller fills via :meth:`push_atmosphere` — the FF_NEXT
    role.  One :meth:`advance_coupling_period` call = one wind-input
    period of NADV advection steps (wavemdl.F90:575-599).  ``plain=True``
    runs the plain PyTorch versions of the kernels.
    """

    def __init__(self, setup, date14: str, *, fl1=None, stress=None,
                 prchar: float = PRCHAR, cithrsh: float = CITHRSH,
                 plain: bool = False):
        self.setup = setup
        self.prchar = prchar
        self.cithrsh = cithrsh
        self.plain = plain
        self._date14 = date14
        self._fl1, self._stress = fl1, stress
        n = setup.n_real
        self._staged: dict = dict(
            wswave=np.full(n, 1.0), wdwave=np.zeros(n),
            aird=np.full(n, 1.225), wstar=np.zeros(n),
            cicover=np.zeros(n))
        # The model is created on the FIRST push_atmosphere so the cold
        # start (MSTART JONSWAP) sees the first real wind field — the
        # INITMDL/GETFRSTWND ordering (initmdl.F90:994, getwnd.F90).
        self.model = None

    def _ensure_model(self):
        if self.model is None:
            self.model = driver_mod.WaveModel(
                self.setup, lambda date14: dict(self._staged),
                self._date14, fl1=self._fl1, stress=self._stress,
                plain=self.plain)
        return self.model

    # ---- atmosphere → wave -------------------------------------------------
    def push_atmosphere(self, date14: str, *, wswave, wdwave, aird=None,
                        wstar=None, cicover=None, cithick=None,
                        ucur=None, vcur=None):
        """Stage a new forcing period and swap it in (PREWIND+NEWWIND).

        Arrays are (n_real,) on the sea-point block.  Unspecified fields
        keep their previous values (the reference keeps FF_NOW fields not
        present in the atmospheric message).
        """
        upd = dict(wswave=wswave, wdwave=wdwave, aird=aird, wstar=wstar,
                   cicover=cicover, cithick=cithick, ucur=ucur, vcur=vcur)
        for k, v in upd.items():
            if v is not None:
                self._staged[k] = np.asarray(v, np.float64)
        first = self.model is None
        m = self._ensure_model()
        if not first:
            m.newwind(driver_mod.parse_date(date14)
                      if isinstance(date14, str) else date14)
        return self

    # ---- ocean → wave -------------------------------------------------------
    def push_ocean(self, o2w: Ocean2Wave, date14: str | None = None):
        """RECVNEMOFIELDS role: ice/currents from the ocean model.

        Currents trigger the CTU-weight refresh (GETCURR → LUPDTWGHT,
        getcurr.F90)."""
        return self.push_atmosphere(
            date14 or self.model.date,
            wswave=None, wdwave=None,
            cicover=o2w.cicover, cithick=o2w.cithick,
            ucur=o2w.ucur, vcur=o2w.vcur)

    # ---- stepping -----------------------------------------------------------
    def advance_coupling_period(self, nadv: int = 1):
        """Run NADV advection steps (the WAMODEL loop of one WAVEMDL
        call)."""
        self._ensure_model().advance(nadv)
        return self

    # ---- wave → atmosphere ---------------------------------------------------
    def wave_to_atmosphere(self) -> Wave2Atmosphere:
        """Assemble the WVFLDG block with the reference default values at
        ice-covered points (wavemdl.F90:692-747 DEFVAL comments: 'default
        value for grid points not covered by the wave model ice free sea
        points')."""
        m = self.model
        n = self.setup.n_real
        st, sr = m.state, m.stress
        tb = self.setup.tb

        def real(x, default):
            return np.full(n, default) if x is None else _host(x, n)

        ice = real(m.frc.get("cicover"), 0.0) > self.cithrsh
        flmin = 0.1e-6 ** 2            # FLMIN role for WSEmean default

        def defval(x, default):
            v = real(x, default)
            v[ice] = default
            return v

        return Wave2Atmosphere(
            charnock=defval(sr.get("chrnck"), self.prchar),
            ustokes=defval(st.get("ustokes"), 0.0),
            vstokes=defval(st.get("vstokes"), 0.0),
            phiocd=defval(st.get("phiocd"), 0.0),
            tauocx=defval(st.get("tauocxd"), 0.0),
            tauocy=defval(st.get("tauocyd"), 0.0),
            wsemean=defval(st.get("wsemean"), flmin),
            wsfmean=defval(st.get("wsfmean"), float(tb.fr[-1])))

    # ---- wave → ocean ---------------------------------------------------------
    def wave_to_ocean(self) -> Wave2Ocean:
        """Assemble the WAM2NEMO block (updnemofields.F90:92-98); the
        catalog's ``swh`` and ``mwp`` on the model's device."""
        m = self.model
        n = self.setup.n_real
        st = m.state
        fields = products.compute(
            ["swh", "mwp"], m.fl1, self.setup.tb,
            {**st, **m.stress}, m.frc, self.setup.phys.params,
            env=self.setup.env)

        def real(x, default=0.0):
            return np.full(n, default) if x is None else _host(x, n)

        return Wave2Ocean(
            nswh=real(fields["swh"]),
            nmwp=real(fields["mwp"]),
            nphieps=real(st.get("phieps")),
            ntauoc=real(st.get("tauoc"), 1.0),
            nustokes=real(st.get("ustokes")),
            nvstokes=real(st.get("vstokes")),
            # the physics state always has a strain row (zero without
            # LSTRN); the block carries it only where LSTRN computes it
            nemostrn=(real(st["strnms"]) if self.setup.phys.lstrn
                      else None))
