"""Calendar-aware interpolation of time-varying climatology inputs.

Port of isca_tpu/utils/time_interp.py, which replaces the reference's
interpolator/time_interp machinery (src/atmos_shared/interpolator/
interpolator.F90, src/shared/time_interp) for the common cases:
annually-periodic monthly climatologies (ozone, SSTs, sea ice) and
multi-year timeseries (CO2 concentrations). All file reading and regridding
happens host-side at model build; a lookup is a gather of two time slices
plus a linear blend on the series' device, driven by the model's
time_seconds tensor, with no read back to the host.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from isca_tpu_torch import resolve_device


def _take(x: torch.Tensor, i: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """x[i] along `dim` for a 0-d index tensor, without a host read."""
    return torch.index_select(x, dim, i.reshape(1)).squeeze(dim)


@dataclasses.dataclass(frozen=True)
class TimeSeries:
    """A (time, ...) climatology with on-device linear time interpolation."""

    data: torch.Tensor     # (nt, ...) field values
    times: torch.Tensor    # (nt,) seconds (within one period if periodic)
    periodic: bool         # annually repeating climatology
    period_seconds: float

    def at(self, time_seconds):
        """Linearly interpolated field at model time (a number or a 0-d tensor)."""
        times = self.times
        t = torch.as_tensor(time_seconds).to(device=times.device, dtype=times.dtype)
        nt = times.shape[0]
        if self.periodic:
            t = torch.remainder(t, self.period_seconds)
        right = torch.searchsorted(times, t.reshape(1), right=True)[0]
        if self.periodic:
            # wrap-around: index of the last record <= t
            i0 = torch.clamp(right - 1, -1, nt - 1)
            i1 = torch.remainder(i0 + 1, nt)
            t0 = torch.where(i0 < 0, times[nt - 1] - self.period_seconds,
                             _take(times, torch.remainder(i0, nt)))
            t1 = torch.where(i0 + 1 >= nt, times[0] + self.period_seconds, _take(times, i1))
            i0 = torch.remainder(i0, nt)
            w = (t - t0) / torch.where(t1 != t0, t1 - t0, 1.0)
            return (1.0 - w) * _take(self.data, i0) + w * _take(self.data, i1)
        i0 = torch.clamp(right - 1, 0, nt - 2)
        t_lo, t_hi = _take(times, i0), _take(times, i0 + 1)
        w = torch.clamp((t - t_lo) / (t_hi - t_lo), 0.0, 1.0)
        return (1.0 - w) * _take(self.data, i0) + w * _take(self.data, i0 + 1)


def monthly_climatology(fields, year_seconds: float = 360 * 86400.0,
                        dtype=torch.float32, device=None) -> TimeSeries:
    """An annually-periodic TimeSeries from 12 monthly mean fields,
    timestamped at month centers (the reference's climatology convention),
    on `device` (None is CUDA, as isca_tpu_torch.resolve_device has it)."""
    device = resolve_device(device)
    fields = np.asarray(fields)
    nt = fields.shape[0]
    month = year_seconds / nt
    times = (np.arange(nt) + 0.5) * month
    f = lambda x: torch.as_tensor(np.asarray(x, np.float64)).to(device=device, dtype=dtype)
    return TimeSeries(data=f(fields), times=f(times), periodic=True,
                      period_seconds=float(year_seconds))


def from_netcdf(path: str, var: str, time_units_seconds: float = 86400.0,
                periodic: bool = False, period_seconds: float = 360 * 86400.0,
                dtype=torch.float32, device=None) -> TimeSeries:
    """Load a (time, ...) variable from a NetCDF file as a TimeSeries on
    `device` (None is CUDA)."""
    from isca_tpu_torch.utils.input_files import read_netcdf

    device = resolve_device(device)
    d = read_netcdf(path)
    data = d[var]
    t = d.get("time", np.arange(data.shape[0]))
    f = lambda x: torch.as_tensor(np.asarray(x, np.float64)).to(device=device, dtype=dtype)
    return TimeSeries(
        data=f(data), times=f(np.asarray(t, np.float64) * time_units_seconds),
        periodic=periodic, period_seconds=float(period_seconds))


def interp_pressure(field, plevs, p_full):
    """Vertical interpolation of a pressure-level climatology onto model
    levels: the reference interpolator's INTERP_WEIGHTED_P mode
    (src/atmos_shared/interpolator/interpolator.F90).

    field: (..., nplev) values on climatology pressure levels (any leading
    dims broadcastable against p_full's leading dims); plevs: (nplev,)
    increasing [Pa]; p_full: (..., L) model pressures [Pa]. Linear in
    log-pressure, constant extrapolation outside the climatology range.
    """
    plevs = torch.as_tensor(plevs).to(device=p_full.device, dtype=p_full.dtype)
    logp = torch.log(plevs)
    lt = torch.log(p_full)
    np_ = plevs.shape[0]
    i0 = torch.clamp(torch.searchsorted(logp, lt.contiguous(), right=True) - 1, 0, np_ - 2)
    w = torch.clamp((lt - logp[i0]) / (logp[i0 + 1] - logp[i0]), 0.0, 1.0)
    f = torch.broadcast_to(field, tuple(p_full.shape[:-1]) + (np_,))
    lo = torch.take_along_dim(f, i0, dim=-1)
    hi = torch.take_along_dim(f, i0 + 1, dim=-1)
    return (1.0 - w) * lo + w * hi


@dataclasses.dataclass(frozen=True)
class PressureTimeSeries:
    """Time-varying climatology on fixed pressure levels (e.g. ozone): time
    interpolation + per-column log-p vertical interpolation, on the device.

    series.data has shape (nt, ..., nplev) with the pressure axis LAST (the
    loader moves it); `at(t, p_full)` returns (..., L) on model levels.
    """

    series: TimeSeries
    plevs: torch.Tensor     # (nplev,) increasing [Pa]

    def at(self, time_seconds, p_full):
        return interp_pressure(self.series.at(time_seconds), self.plevs, p_full)


def load_pressure_climatology(path, var, lat_model, lon_model, periodic=True,
                              year_seconds=360 * 86400.0, dtype=torch.float32,
                              device=None) -> PressureTimeSeries:
    """Read a (time, pfull, lat[, lon]) climatology file (the reference's
    ozone_1990-style input), regrid it horizontally onto the model grid at
    load time (bilinear, or linear in latitude for a zonal-mean file), and
    wrap it for on-device time and pressure interpolation.

    Mirrors interpolator_init + interpolator (interpolator.F90) for the
    INTERP_WEIGHTED_P / annually-periodic case used by rrtm_radiation
    (rrtm_radiation.F90 o3 input). The series lives on `device` (None is
    CUDA).
    """
    from isca_tpu_torch.utils.input_files import read_netcdf, regrid_bilinear

    device = resolve_device(device)
    d = read_netcdf(path)
    data = np.asarray(d[var], np.float64)
    lat_names = [k for k in ("lat", "latitude") if k in d]
    lon_names = [k for k in ("lon", "longitude") if k in d]
    p_names = [k for k in ("pfull", "plev", "level", "pressure") if k in d]
    lat_in = np.asarray(d[lat_names[0]]).ravel()
    p_in = np.asarray(d[p_names[0]], np.float64).ravel()
    if p_in.max() < 2000.0:          # file in hPa -> Pa
        p_in = p_in * 100.0
    if data.ndim == 3:               # (time, pfull, lat): zonal-mean file
        data = data[..., None]
        lon_in = np.array([0.0])
    else:
        lon_in = np.asarray(d[lon_names[0]]).ravel()

    lat_model, lon_model = np.asarray(lat_model), np.asarray(lon_model)
    nt, npl = data.shape[0], data.shape[1]
    out = np.empty((nt, npl, lat_model.size, lon_model.size))
    for it in range(nt):
        for ip in range(npl):
            if lon_in.size == 1:
                prof = np.interp(lat_model, np.sort(lat_in),
                                 data[it, ip, np.argsort(lat_in), 0])
                out[it, ip] = prof[:, None]
            else:
                out[it, ip] = regrid_bilinear(lat_in, lon_in, data[it, ip],
                                              lat_model, lon_model)
    # sort pressure increasing and move the level axis last
    order = np.argsort(p_in)
    out = np.moveaxis(out[:, order], 1, -1)    # (nt, lat, lon, nplev)
    f = lambda x: torch.as_tensor(np.asarray(x, np.float64)).to(device=device, dtype=dtype)
    if periodic:
        series = monthly_climatology(out, year_seconds, dtype, device)
    else:
        times = np.asarray(d.get("time", np.arange(nt)), np.float64) * 86400.0
        series = TimeSeries(data=f(out), times=f(times), periodic=False,
                            period_seconds=float(year_seconds))
    return PressureTimeSeries(series=series, plevs=f(p_in[order]))
