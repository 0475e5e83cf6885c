"""Pressure-level interpolation of model output (run_plevel equivalent).

Port of isca_tpu/io/plevel.py: host-side NetCDF post-processing in numpy
and scipy.io, as isca_tpu's is (nothing runs on the device), so it writes
what isca_tpu's writes, to the bit. It replaces the reference's
postprocessing/plevel_interpolation pipeline (run_plevel.py + the plevel.sh
Fortran tool): reads a diagnostics NetCDF written by io/diag_manager
(fields on model sigma/hybrid levels, `pfull`
reference pressures + a `ps` surface-pressure field when saved), interpolates
3-D fields onto fixed pressure levels in log-p, and writes a new NetCDF.

When `ps` (surface pressure, Pa or hPa) is present in the file, the per-
column pressures are reconstructed as p(k) = pfull_ref(k) * ps/ps0 (sigma
coordinate, the framework's default vertical coordinate for output);
otherwise the reference `pfull` column applies everywhere.  Values outside
the column's pressure range are masked with `fill_value` (the reference
tool's behavior) or held constant with extrapolate=True.
"""

from __future__ import annotations

import numpy as np

# standard output levels of the reference's run_plevel.py (Pa)
DEFAULT_PLEVS = np.array([100., 300., 1000., 3000., 10000., 20000., 30000.,
                          40000., 50000., 60000., 70000., 85000., 92500.,
                          100000.])


def interp_to_plevels(field, p_col, plevs, fill_value=np.nan,
                      extrapolate=False):
    """field (..., L); p_col (..., L) increasing; plevs (P,). Returns
    (..., P) via linear-in-log-p interpolation (numpy, host-side)."""
    lt = np.log(np.asarray(plevs, np.float64))
    lp = np.log(np.asarray(p_col, np.float64))
    out = np.empty(field.shape[:-1] + (len(plevs),), np.float64)
    flat_f = field.reshape(-1, field.shape[-1])
    flat_p = np.broadcast_to(lp, field.shape).reshape(-1, field.shape[-1])
    flat_o = out.reshape(-1, len(plevs))
    for i in range(flat_f.shape[0]):
        flat_o[i] = np.interp(lt, flat_p[i], flat_f[i])
        if not extrapolate:
            bad = (lt < flat_p[i, 0]) | (lt > flat_p[i, -1])
            flat_o[i, bad] = fill_value
    return out


def run_plevel(infile, outfile, plevs=DEFAULT_PLEVS, variables=None,
               ps0=1.0e5, extrapolate=False):
    """Interpolate all (time, pfull, lat, lon) variables of a diag file to
    fixed pressure levels; copies 2-D fields through unchanged."""
    from scipy.io import netcdf_file

    with netcdf_file(str(infile), "r", mmap=False) as nc:
        dims = {k: v for k, v in nc.dimensions.items()}
        data = {k: (v.dimensions, np.array(v[:]))
                for k, v in nc.variables.items()}

    pfull = data["pfull"][1] * 100.0 if "pfull" in data else None  # Pa
    ps = None
    if "ps" in data and data["ps"][0] == ("time", "lat", "lon"):
        ps = data["ps"][1]
        if ps.max() < 2.0e4:          # stored in hPa
            ps = ps * 100.0

    plevs = np.asarray(plevs, np.float64)
    with netcdf_file(str(outfile), "w") as out:
        out.createDimension("time", None)
        out.createDimension("lat", dims["lat"])
        out.createDimension("lon", dims["lon"])
        out.createDimension("plev", len(plevs))
        vp = out.createVariable("plev", "d", ("plev",))
        vp[:] = plevs
        vp.units = "Pa"
        for cname in ("lat", "lon", "time"):
            if cname in data:
                d, arr = data[cname]
                v = out.createVariable(cname, "d", d)
                v[:] = arr
        for name, (d, arr) in data.items():
            if name in ("lat", "lon", "time", "pfull", "phalf", "ps"):
                continue
            if variables is not None and name not in variables:
                continue
            if d == ("time", "pfull", "lat", "lon"):
                nt = arr.shape[0]
                res = np.empty((nt, len(plevs)) + arr.shape[2:], np.float64)
                for it in range(nt):
                    # column pressures: sigma scaling by ps when available
                    if ps is not None:
                        p_col = (pfull[:, None, None] / ps0
                                 * ps[it][None, :, :])
                    else:
                        p_col = np.broadcast_to(
                            pfull[:, None, None],
                            (len(pfull),) + arr.shape[2:])
                    f = np.moveaxis(arr[it], 0, -1)           # (lat,lon,L)
                    p_c = np.moveaxis(p_col, 0, -1)
                    res[it] = np.moveaxis(
                        interp_to_plevels(f, p_c, plevs,
                                          extrapolate=extrapolate), -1, 0)
                v = out.createVariable(name, "f", ("time", "plev",
                                                   "lat", "lon"))
                v[:] = res.astype(np.float32)
            elif d == ("time", "lat", "lon"):
                v = out.createVariable(name, "f", d)
                v[:] = arr.astype(np.float32)
        if "ps" in data and (variables is None or "ps" in variables):
            v = out.createVariable("ps", "f", ("time", "lat", "lon"))
            v[:] = data["ps"][1].astype(np.float32)
    return outfile
