"""Input-file handling: NetCDF reading and regridding.

Port of isca_tpu/utils/input_files.py, which replaces the reference's
topography/interpolator input pipeline for boundary conditions
(src/shared/topography, horiz_interp): reads topography / land-mask files
and regrids them onto the model's Gaussian grid, bilinearly or
conservatively (grid-box mean, standard deviation and land fraction).
Host-side numpy at model-build time only.
"""

from __future__ import annotations

import numpy as np


def read_netcdf(path: str) -> dict:
    """Read all variables of a NetCDF file: classic (NetCDF-3) through
    scipy, NetCDF-4 (HDF5) through h5py where it is installed."""
    from scipy.io import netcdf_file

    try:
        with netcdf_file(path, "r", mmap=False) as nc:
            return {k: np.array(v[:]) for k, v in nc.variables.items()}
    except TypeError as exc:    # scipy: "... is not a valid NetCDF 3 file"
        try:
            import h5py
        except ImportError:
            raise ImportError(
                f"{path} is not a classic NetCDF-3 file, and reading NetCDF-4 "
                "(HDF5) needs h5py, which is not installed") from exc
    out = {}
    with h5py.File(path, "r") as f:
        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                out[name.split("/")[-1]] = np.array(obj[...])
        f.visititems(visit)
    return out


def regrid_bilinear(lat_in, lon_in, data, lat_out, lon_out):
    """Bilinear regrid of (lat, lon) data with periodic longitude."""
    lat_in = np.asarray(lat_in, np.float64)
    lon_in = np.asarray(lon_in, np.float64)
    data = np.asarray(data, np.float64)
    flip = lat_in[0] > lat_in[-1]
    if flip:
        lat_in = lat_in[::-1]
        data = data[::-1]

    # latitude interpolation indices/weights (clamped)
    j = np.clip(np.searchsorted(lat_in, lat_out) - 1, 0, len(lat_in) - 2)
    wj = (lat_out - lat_in[j]) / (lat_in[j + 1] - lat_in[j])
    wj = np.clip(wj, 0.0, 1.0)

    # periodic longitude
    lon_ext = np.concatenate([lon_in, [lon_in[0] + 360.0]])
    data_ext = np.concatenate([data, data[:, :1]], axis=1)
    lon_out_mod = np.mod(lon_out - lon_in[0], 360.0) + lon_in[0]
    i = np.clip(np.searchsorted(lon_ext, lon_out_mod) - 1, 0, len(lon_ext) - 2)
    wi = (lon_out_mod - lon_ext[i]) / (lon_ext[i + 1] - lon_ext[i])
    wi = np.clip(wi, 0.0, 1.0)

    d00 = data_ext[np.ix_(j, i)]
    d01 = data_ext[np.ix_(j, i + 1)]
    d10 = data_ext[np.ix_(j + 1, i)]
    d11 = data_ext[np.ix_(j + 1, i + 1)]
    wj2 = wj[:, None]
    wi2 = wi[None, :]
    return (
        d00 * (1 - wj2) * (1 - wi2)
        + d01 * (1 - wj2) * wi2
        + d10 * wj2 * (1 - wi2)
        + d11 * wj2 * wi2
    )


def load_topography(path: str, lats_deg, lons_deg, var: str = "zsurf"):
    """Load a topography (or any 2-D lat/lon) variable regridded to the model grid."""
    d = read_netcdf(path)
    lat_in = d.get("lat", d.get("latitude"))
    lon_in = d.get("lon", d.get("longitude"))
    z = d[var]
    if z.ndim == 3:
        z = z[0]
    if tuple(z.shape) == (len(lats_deg), len(lons_deg)) and np.allclose(
        np.sort(lat_in), np.sort(lats_deg), atol=0.5
    ):
        return z[::-1] if lat_in[0] > lat_in[-1] else z
    return regrid_bilinear(lat_in, lon_in, z, np.asarray(lats_deg), np.asarray(lons_deg))


def _box_bounds(centers, periodic_span=None):
    """Cell boundaries from 1-D cell centers (midpoints, clamped/periodic)."""
    c = np.asarray(centers, np.float64)
    mid = 0.5 * (c[1:] + c[:-1])
    if periodic_span is not None:
        lo = c[0] - 0.5 * (periodic_span - (c[-1] - c[0]))
        hi = lo + periodic_span
        return np.concatenate([[lo], mid, [hi]])
    lo = c[0] - (mid[0] - c[0])
    hi = c[-1] + (c[-1] - mid[-1])
    return np.concatenate([[lo], mid, [hi]])


def regrid_conservative(lat_in, lon_in, data, lat_out, lon_out):
    """First-order conservative (area-binned) regrid of fine (lat, lon) data.

    The reference computes grid-box MEAN and STDEV of high-resolution
    topography over each model cell (src/shared/topography/topography.F90
    get_topog_mean/get_topog_stdev; stdev feeds mg_drag's sub-grid mountain
    amplitude) and ocean fraction from a mask.  Source cells are binned into
    target boxes by center containment, weighted by cos(lat) cell area.

    Returns (mean, stdev) on the (lat_out, lon_out) grid.
    """
    lat_in = np.asarray(lat_in, np.float64)
    lon_in = np.asarray(lon_in, np.float64)
    data = np.asarray(data, np.float64)
    if lat_in[0] > lat_in[-1]:
        lat_in = lat_in[::-1]
        data = data[::-1]
    lat_out = np.asarray(lat_out, np.float64)
    lon_out = np.asarray(lon_out, np.float64)

    latb = _box_bounds(lat_out)
    lonb = _box_bounds(lon_out, periodic_span=360.0)
    lon_src = np.mod(lon_in - lonb[0], 360.0) + lonb[0]

    j = np.clip(np.searchsorted(latb, lat_in) - 1, 0, len(lat_out) - 1)
    i = np.clip(np.searchsorted(lonb, lon_src) - 1, 0, len(lon_out) - 1)
    w = np.cos(np.radians(lat_in))[:, None] * np.ones_like(lon_in)[None, :]
    flat_idx = (j[:, None] * len(lon_out) + i[None, :]).ravel()

    nbox = len(lat_out) * len(lon_out)
    wsum = np.bincount(flat_idx, weights=w.ravel(), minlength=nbox)
    dsum = np.bincount(flat_idx, weights=(w * data).ravel(), minlength=nbox)
    d2sum = np.bincount(flat_idx, weights=(w * data * data).ravel(),
                        minlength=nbox)
    wsum = np.maximum(wsum, 1e-30)
    mean = (dsum / wsum).reshape(len(lat_out), len(lon_out))
    var = np.maximum(d2sum / wsum - (dsum / wsum) ** 2, 0.0)
    return mean, np.sqrt(var).reshape(len(lat_out), len(lon_out))


def topog_stats(path: str, lats_deg, lons_deg, var: str = "zsurf",
                ocean_below: float = 0.0):
    """Grid-box topography statistics for the model grid: (zsurf mean,
    sgsmtn stdev for mg_drag, land fraction) - the topography_nml
    'interpolated' input pipeline (topography.F90:65-80)."""
    d = read_netcdf(path)
    lat_in = d.get("lat", d.get("latitude"))
    lon_in = d.get("lon", d.get("longitude"))
    z = d[var]
    if z.ndim == 3:
        z = z[0]
    zmean, zstd = regrid_conservative(lat_in, lon_in, z, lats_deg, lons_deg)
    land = (np.asarray(z, np.float64) > ocean_below).astype(np.float64)
    lfrac, _ = regrid_conservative(lat_in, lon_in, land, lats_deg, lons_deg)
    return zmean, zstd, lfrac
