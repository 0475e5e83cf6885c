"""Input-file handling: NetCDF reading and regridding.

Port of two functions of isca_tpu/utils/input_files.py: `read_netcdf`,
which `dycore/initial_conditions.apply_external_file` needs, and
`regrid_bilinear`, which `io/restart.change_resolution` needs. The rest of
that module (topography and conservative regridding) belongs to the moist
GCM's land pipeline and is not ported yet (ROADMAP A.5). Host-side numpy.
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
