"""Diagnostics manager: runtime-selected fields, time reductions, NetCDF output.

Port of isca_tpu/io/diag_manager.py (reference: the FMS diag_manager +
DiagTable, src/shared/diag_manager/*, src/extra/python/isca/diagtable.py).
The user registers output files (with a frequency) and fields
(instantaneous or time-averaged/max/min); the model supplies a dict of
diagnostic tensors each step. The running sums are tensors that the
manager owns, on the model's device: `update` adds one elementwise op per
field per step, in place into those tensors (never into the model's
state), and never waits for the device. `flush` is the one place where data
goes to the host: it writes one record per file to classic NetCDF3 via
scipy (float32 variables), one file per diag file per run segment.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

import numpy as np
import torch


@dataclasses.dataclass
class DiagFieldSpec:
    module: str
    name: str
    reduction: str = "average"   # average | instantaneous | max | min
    long_name: str = ""
    units: str = ""


@dataclasses.dataclass
class DiagFileSpec:
    name: str
    output_freq_seconds: int
    fields: list = dataclasses.field(default_factory=list)


class DiagTable:
    """Programmatic diag_table (reference: isca/diagtable.py:47-121)."""

    def __init__(self):
        self.files: dict[str, DiagFileSpec] = {}

    def add_file(self, name: str, freq_seconds: int):
        self.files[name] = DiagFileSpec(name, int(freq_seconds))
        return self

    def add_field(self, file_name: str, module: str, name: str,
                  time_avg: bool = True, reduction: str | None = None,
                  long_name: str = "", units: str = ""):
        red = reduction or ("average" if time_avg else "instantaneous")
        self.files[file_name].fields.append(
            DiagFieldSpec(module, name, red, long_name, units)
        )
        return self


class DiagAccumulator:
    """Running accumulation for one diag file, on the model's device.

    State: {'_count': steps accumulated (a host int), field: running tensor}.
    """

    def __init__(self, spec: DiagFileSpec):
        self.spec = spec

    def init_state(self, sample: dict) -> dict:
        state = {"_count": 0}
        for f in self.spec.fields:
            x = sample[f.name]
            if f.reduction == "max":
                state[f.name] = torch.full_like(x, -torch.inf)
            elif f.reduction == "min":
                state[f.name] = torch.full_like(x, torch.inf)
            else:
                state[f.name] = torch.zeros_like(x)
        return state

    def update(self, state: dict, diag: dict) -> dict:
        """Fold one step's fields into the running tensors, in place."""
        state["_count"] += 1
        for f in self.spec.fields:
            acc, x = state[f.name], diag[f.name]
            if f.reduction == "average":
                acc.add_(x)
            elif f.reduction == "max":
                torch.maximum(acc, x, out=acc)
            elif f.reduction == "min":
                torch.minimum(acc, x, out=acc)
            else:  # instantaneous: keep the latest
                acc.copy_(x)
        return state

    def finalize(self, state: dict) -> dict:
        """Host-side: produce the output arrays for one interval."""
        count = max(state["_count"], 1)
        out = {}
        for f in self.spec.fields:
            x = state[f.name].to("cpu", copy=True).numpy()
            out[f.name] = x / count if f.reduction == "average" else x
        return out


class NetCDFWriter:
    """Classic NetCDF3 writer on the model's Gaussian grid (scipy backend)."""

    def __init__(self, path: str, lats_deg, lons_deg, p_full=None, p_half=None,
                 time_units: str = "days"):
        from scipy.io import netcdf_file

        self.path = path
        self._nc = netcdf_file(path, "w")
        nc = self._nc
        nc.createDimension("time", None)  # scipy: unlimited dim must be first
        nc.createDimension("lat", len(lats_deg))
        nc.createDimension("lon", len(lons_deg))
        v = nc.createVariable("lat", "d", ("lat",)); v[:] = np.asarray(lats_deg); v.units = "degrees_N"
        v = nc.createVariable("lon", "d", ("lon",)); v[:] = np.asarray(lons_deg); v.units = "degrees_E"
        self._tvar = nc.createVariable("time", "d", ("time",))
        self._tvar.units = time_units
        if p_full is not None:
            nc.createDimension("pfull", len(p_full))
            v = nc.createVariable("pfull", "d", ("pfull",)); v[:] = np.asarray(p_full); v.units = "hPa"
        if p_half is not None:
            nc.createDimension("phalf", len(p_half))
            v = nc.createVariable("phalf", "d", ("phalf",)); v[:] = np.asarray(p_half); v.units = "hPa"
        self._vars: dict[str, Any] = {}
        self._nt = 0

    def _ensure_var(self, name: str, arr: np.ndarray, units="", long_name=""):
        if name in self._vars:
            return self._vars[name]
        if arr.ndim == 3:
            dims = ("time", "pfull", "lat", "lon")
        elif arr.ndim == 2:
            dims = ("time", "lat", "lon")
        elif arr.ndim == 1:
            dims = ("time", "pfull") if "pfull" in self._nc.dimensions and arr.shape[0] == self._nc.dimensions["pfull"] else ("time", "lat")
        else:
            dims = ("time",)
        v = self._nc.createVariable(name, "f", dims)
        if units:
            v.units = units
        if long_name:
            v.long_name = long_name
        self._vars[name] = v
        return v

    def append(self, time_value: float, fields: dict, meta: dict | None = None):
        it = self._nt
        self._tvar[it] = time_value
        for name, arr in fields.items():
            arr = np.asarray(arr, np.float32)
            m = (meta or {}).get(name)
            v = self._ensure_var(name, arr, getattr(m, "units", ""), getattr(m, "long_name", ""))
            v[it] = arr
        self._nt += 1

    def close(self):
        self._nc.close()


class DiagManager:
    """Ties a DiagTable to accumulators and writers for a run segment."""

    def __init__(self, table: DiagTable, lats_deg, lons_deg, p_full_hpa=None,
                 p_half_hpa=None, outdir: str = "."):
        self.table = table
        self.outdir = outdir
        self.grid = (np.asarray(lats_deg), np.asarray(lons_deg), p_full_hpa, p_half_hpa)
        self.accumulators = {n: DiagAccumulator(s) for n, s in table.files.items()}
        self.writers: dict[str, NetCDFWriter] = {}
        os.makedirs(outdir, exist_ok=True)

    def init_state(self, sample: dict) -> dict:
        return {n: a.init_state(sample) for n, a in self.accumulators.items()}

    def update(self, state: dict, diag: dict) -> dict:
        return {n: a.update(state[n], diag) for n, a in self.accumulators.items()}

    def flush(self, state: dict, time_days: float, segment_label: str = "") -> dict:
        """Host-side: write one interval per file, return a reset state."""
        lats, lons, pf, ph = self.grid
        new_state = {}
        for name, acc in self.accumulators.items():
            if name not in self.writers:
                suffix = f"_{segment_label}" if segment_label else ""
                path = os.path.join(self.outdir, f"{name}{suffix}.nc")
                self.writers[name] = NetCDFWriter(path, lats, lons, pf, ph)
            out = acc.finalize(state[name])
            meta = {f.name: f for f in acc.spec.fields}
            self.writers[name].append(time_days, out, meta)
            new_state[name] = acc.init_state({f.name: state[name][f.name] for f in acc.spec.fields})
        return new_state

    def close(self):
        for w in self.writers.values():
            w.close()
        self.writers = {}
