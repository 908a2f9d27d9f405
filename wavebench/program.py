"""The system under test: ``ecwam_tpu_torch``'s ``FastWaveModel`` driven
the way a forecast drives it, and nothing else of the port.

One unit of work is a forcing period (a forecast hour): NEWWIND with the
period's forcing (``FastWaveModel.newwind``; with currents it refreshes
the refraction inputs and the CFL retry), then its advection and physics
steps through ``FastWaveModel.advance``.  In a cell with output dates the
period's last step is an output date, as ``cli/main.py: _run_model``
takes it: ``advance(1, full_phys=True)`` (full-mode physics with the
windsea/swell split), then ``io/products.compute_chunked`` over the
cell's fields with ``ops/secondorder.cal_second_order_spec`` applied
to each chunk, then the fields copied to the host.  No GRIB is written.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch

from wavebench import forcing as forcing_mod

# the output path's point chunk (cli/main.py and io/products.py's default)
OUTPUT_CHUNK = 65536


class Program:
    """The port's model of one configuration on ``device``.

    ``spans(name)`` is a context manager around each call into a layer
    (the harness's spans and host clocks); ``fields`` the catalog names
    of an output date (empty: no output dates)."""

    def __init__(self, build_kw: dict, forcing, device, *, cache_dir,
                 fields=(), second_order: bool = True):
        from ecwam_tpu_torch.model import driver, setup
        from ecwam_tpu_torch.ops.physics import implsch_cuda as ipk
        self.device = device = torch.device(device)
        self.fields = tuple(fields)
        had = _listing(cache_dir)
        t0 = time.perf_counter()
        self.ms = ms = setup.build_model(
            **build_kw, currents=forcing.currents0(), cache_dir=cache_dir,
            device=device)
        # the model's set-up: host tables from the cache (or built into it
        # where ``tables_built``) and moved to the device
        self.model_s = time.perf_counter() - t0
        self.tables_built = _listing(cache_dir) != had
        self.builds = {}
        if device.type == "cuda":
            # only the libraries this cell launches: kernel A and kernel
            # B's build in each mode the cell runs
            from ecwam_tpu_torch import _build
            names = {"advect", ipk.library(ms.phys, False)}
            if self.fields:
                names.add(ipk.library(ms.phys, True))
            self.builds = _build.build(sorted(names))
            for n in sorted(names):
                _build.load(n)
        self.model = driver.FastWaveModel(ms, forcing.provider,
                                          forcing_mod.START)
        self.so_correct = None
        if self.fields and second_order:
            from ecwam_tpu_torch.ops import secondorder as so_mod
            so_tab = so_mod.build_second_order_tables(ms.tb)
            so_dev = so_mod.device_tables(so_tab, ms.env["depth"])

            def so_correct(fl, env_c):
                return so_mod.cal_second_order_spec(
                    fl, env_c["wavnum"], env_c["depth"], ms.tb, so_tab,
                    sig=1.0, tabs=so_dev)
            self.so_correct = so_correct

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- the unit of work ----------------------------------------------
    def unit(self, steps: int, output: bool, spans,
             date=contextlib.nullcontext):
        """One forcing period of ``steps`` advection steps, the last an
        output date where ``output``, run inside the context ``date()``.
        Returns the output date's host fields, or None."""
        m = self.model
        with spans("newwind"):
            m.newwind(m.date)
        with spans("advance"):
            m.advance(steps - 1 if output else steps)
        if not output:
            return None
        with date():
            return self.output_date(spans)

    def output_date(self, spans) -> np.ndarray:
        """An output date: its physics step, the second order and the
        products per chunk, the copy to the host.  Returns the
        (len(fields), n_real) host array."""
        from ecwam_tpu_torch.io import products as products_mod
        m, ms = self.model, self.ms
        with spans("output_phys"):
            m.advance(1, full_phys=True)
        state = {**m.state, **m.stress}
        so_fn = None
        if self.so_correct is not None:
            def so_fn(fl, env_c):
                with spans("secondorder"):
                    return self.so_correct(fl, env_c)
        with spans("products"):
            fields = products_mod.compute_chunked(
                self.fields, m.fl1_chunk, ms.n_pad, ms.tb, state, m.frc,
                ms.phys.params, env=ms.env,
                llgcbz0=ms.phys.params.llgcbz0, so_correct=so_fn,
                chunk=OUTPUT_CHUNK)
        with spans("host_copy"):
            stacked = torch.stack([fields[n][:ms.n_real].to(ms.dtype)
                                   for n in self.fields])
            host = stacked.cpu().numpy()
        return host

    # -- what the check reads --------------------------------------------
    def snapshot(self) -> dict:
        """The state on the host: the compact spectrum (nang, nfre, n_pad)
        gathered chunk by chunk, and the STRESS_KEYS fields."""
        m, ms = self.model, self.ms
        tb = ms.tb
        fl = torch.empty((tb.nang, tb.nfre, ms.n_pad), dtype=ms.dtype)
        for s in range(0, ms.n_pad, OUTPUT_CHUNK):
            n = min(OUTPUT_CHUNK, ms.n_pad - s)
            fl[..., s:s + n] = m.fl1_chunk(s, n).cpu()
        return dict(fl1=fl, stress={k: v.cpu() for k, v in m.stress.items()},
                    date=m.date)

    def take(self, idx) -> torch.Tensor:
        """The spectra (nang, nfre, len(idx)) at the points ``idx``."""
        return self.model.take_points(idx).cpu()

    def state_host(self) -> dict:
        """The last output date's full-mode state on the host."""
        out = {}
        for k, v in self.model.state.items():
            if isinstance(v, dict):
                out.update({f"sep.{kk}": vv.cpu() for kk, vv in v.items()})
            else:
                out[k] = v.cpu()
        return out


def _listing(path: str) -> set:
    return set(os.listdir(path)) if os.path.isdir(path) else set()


def launch_counts() -> dict:
    """The port's launch counters of kernels A and B (both modes)."""
    from ecwam_tpu_torch.ops import propagation_cuda as pcu
    from ecwam_tpu_torch.ops.physics import implsch_cuda as ipk
    return dict(advect=pcu.advect.launches,
                implsch=ipk.implsch_srl.launches,
                implsch_full=ipk.implsch_srl.full_launches)


def timers(model) -> dict:
    t = model.timers
    return dict(propag=t.propag, phys=t.phys, phys_full=t.phys_full,
                steps=t.steps)
