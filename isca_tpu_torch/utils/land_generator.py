"""Idealized land-mask and topography generator.

The port's own copy of isca_tpu/utils/land_generator.py (pure numpy), which
replaces src/extra/python/isca/land_generator_fn.py (write_land): analytic
land masks — a lat/lon square, or the Sauliere (2012)-derived idealized
continent set (North/South America, Eurasia, Africa, plus Australia, India
and South-East Asia in the newer configuration) — and idealized topography
(Sauliere 2012 Rockies/Tibet, or a Gaussian mountain).  Returns arrays and
optionally writes a `land.nc` boundary file readable by
`GreyMoistModel.set_land` / utils/input_files.

The continent boundary lines are the reference's published geometric
constants (land_generator_fn.py:57-100); the topography shapes follow
Sauliere et al. 2012 (J. Atmos. Sci.) eq. 1-2.
"""

from __future__ import annotations

import numpy as np

CONTINENT_IDS = ("NA", "SA", "EA", "AF", "OZ", "IN", "SEA")


def _continent_masks(lat, lon, new_setup=True):
    """Boolean masks per continent; lat/lon broadcast 2-D arrays [deg]."""
    lam = lon - 180.0
    na = ((103.0 - 43.0 / 40.0 * lam < lat)
          & (lam * 43.0 / 50.0 - 51.8 < lat) & (lat < 60.0))
    sa = ((737.0 - 7.2 * lam < lat)
          & (lam * 10.0 / 7.0 - 212.1 < lat)
          & (lat < -22.0 / 45.0 * lam + 65.9))
    lat_cut = 23.0 if new_setup else 17.0
    w_edge = -8.0 if new_setup else -5.0
    e_wrap = 352.0 if new_setup else 355.0
    af_c = 7.59 if new_setup else 7.37
    ea = (((lat_cut <= lat) & (lat < 60.0) & (w_edge < lon)
           & (43.0 / 40.0 * lon - 101.25 < lat))
          | ((lat_cut <= lat) & (lat < 60.0) & (e_wrap < lon)))
    af = (((lat < lat_cut) & (-52.0 / 27.0 * lon + af_c < lat)
           & (52.0 / 38.0 * lon - 65.1 < lat))
          | ((lat < lat_cut) & (-52.0 / 27.0 * (lon - 360.0) + af_c < lat)))
    oz = (lat > -35.0) & (lat < -17.0) & (lon > 115.0) & (lon < 150.0)
    india = ((lat < 23.0) & (-15.0 / 8.0 * lon + 152.0 < lat)
             & (15.0 / 13.0 * lon - 81.0 < lat))
    sea = ((lat < 23.0) & (43.0 / 40.0 * lon - 101.25 < lat)
           & (-14.0 / 13.0 * lon + 120.0 < lat))
    return dict(NA=na, SA=sa, EA=ea, AF=af, OZ=oz, IN=india, SEA=sea)


def _rotated_gaussian(lat, lon, h0, clat, clon, l1, l2, g1, g2):
    d1 = ((lon - clon) * np.cos(np.radians(g1))
          + (lat - clat) * np.sin(np.radians(g1))) / l1
    d2 = (-(lon - clon) * np.sin(np.radians(g2))
          + (lat - clat) * np.cos(np.radians(g2))) / l2
    return h0 * np.exp(-(d1 ** 2 + d2 ** 2)), d1, d2


def generate_land(lats, lons, land_mode="square",
                  boundaries=(20.0, 60.0, 20.0, 60.0),
                  continents=("all",), topo_mode="none",
                  mountains=("all",),
                  topo_gauss=(40.0, 40.0, 20.0, 10.0, 3500.0),
                  waterworld=False):
    """Returns (land_mask, zsurf) as (nlat, nlon) float arrays.

    lats/lons: 1-D model grid [deg]. Options mirror write_land
    (land_generator_fn.py:32)."""
    lon2, lat2 = np.meshgrid(np.asarray(lons), np.asarray(lats))
    land = np.zeros_like(lat2)

    if land_mode == "square":
        s, n, w, e = boundaries
        land[(s <= lat2) & (lat2 < n) & (w < lon2) & (lon2 < e)] = 1.0
    elif land_mode in ("continents", "continents_old"):
        masks = _continent_masks(lat2, lon2,
                                 new_setup=(land_mode == "continents"))
        names = (CONTINENT_IDS[:7] if land_mode == "continents"
                 else CONTINENT_IDS[:4])
        chosen = names if "all" in continents else \
            [c for c in continents if c in names]
        for c in chosen:
            land[masks[c]] = 1.0
    elif land_mode != "none":
        raise ValueError(f"unknown land_mode {land_mode!r}")

    topo = np.zeros_like(lat2)
    if topo_mode == "sauliere2012":
        rockys, _, _ = _rotated_gaussian(lat2, lon2, 2670.0, 40.0, 247.5,
                                         7.5, 20.0, 42.0, 42.0)
        # Tibet: gaussian in rotated x, lognormal in rotated y
        _, d1, d2 = _rotated_gaussian(lat2, lon2, 1.0, 28.0, 82.5,
                                      12.5, 12.5, -49.5, -18.0)
        with np.errstate(divide="ignore", invalid="ignore"):
            tib = np.exp(-d1 ** 2) * (1.0 / d2) * np.exp(
                -0.5 * np.log(np.where(d2 > 0, d2, np.nan)) ** 2)
        tib = np.nan_to_num(tib)
        tibet = tib / np.nanmax(tib) * 5700.0
        if "all" in mountains or "rockys" in mountains:
            m = rockys / 2670.0 > 0.05
            topo[m] = rockys[m]
        if "all" in mountains or "tibet" in mountains:
            m = tibet / 5700.0 > 0.05
            topo[m] = tibet[m]
    elif topo_mode == "gaussian":
        clat, clon, radius, std, height = topo_gauss
        r = np.sqrt((lon2 - clon) ** 2 + (lat2 - clat) ** 2)
        m = r < radius
        topo[m] = height * np.exp(-(r[m] ** 2) / (2.0 * std ** 2))
    elif topo_mode != "none":
        raise ValueError(f"unknown topo_mode {topo_mode!r}")

    if not waterworld:
        topo[(land == 0.0) & (topo != 0.0)] = 0.0
    return land, topo


def write_land(path, lats, lons, **kw):
    """Generate and write a classic-NetCDF land.nc (zsurf + land_mask)."""
    from scipy.io import netcdf_file

    land, topo = generate_land(lats, lons, **kw)
    with netcdf_file(str(path), "w") as nc:
        nc.createDimension("lat", len(lats))
        nc.createDimension("lon", len(lons))
        vlat = nc.createVariable("lat", "f4", ("lat",))
        vlon = nc.createVariable("lon", "f4", ("lon",))
        vz = nc.createVariable("zsurf", "f4", ("lat", "lon"))
        vl = nc.createVariable("land_mask", "f4", ("lat", "lon"))
        vlat[:] = np.asarray(lats, np.float32)
        vlon[:] = np.asarray(lons, np.float32)
        vz[:] = np.asarray(topo, np.float32)
        vl[:] = np.asarray(land, np.float32)
    return land, topo
