"""The GCM configurations of the gravity-wave-drag, series and boundary-layer
paths, with the seeded climatologies they are driven by.

No input file of these paths is in the repository (an ozone climatology such
as ozone_1990.nc, an AMIP SST or sea-ice climatology, a q-flux file), so each
series is made in memory from a seed: 12 monthly fields of plausible shape
and size, built in numpy (`*_fields`), so that isca_tpu and this package can
be fed the same values, then wrapped by `monthly_climatology` and
`PressureTimeSeries` on the model's device.

  mima_gwd_config        mima_test_case_config() with mima.nml's damping
                         (Rayleigh sponge below 50 Pa, trayfric -0.5 days,
                         energy conserving) and the Alexander-Dunkerton
                         convective gravity-wave drag (CgDragConfig());
                         `add_mima_series` attaches an ozone and a q-flux
                         series.
  continents_config      realistic_continents_test_case.py: GreyMoistConfig()
                         with the bucket; `continents_sst=True` adds
                         prescribed SSTs over the ocean (do_sc_sst,
                         specify_sst_over_ocean_only), the sea-ice albedo
                         (update_albedo_from_ice) and the orographic drag
                         (do_mg_drag). `set_continents` attaches the land,
                         the topography, hprime (300 m over land) and, for
                         continents_sst, the SST and ice series.
  ras_bl_config          frierson_test_case_config() with RAS convection, or
                         simple Betts-Miller with one of the boundary-layer
                         schemes (mellor_yamada, edt, entrain, stable_bl with
                         shallow convection).

On a mesh every seeded field, the continents and the topography are built
on the whole globe and each rank keeps its band's rows, so a sharded model
is fed what the model on one device is fed (the draws of a field depend on
its whole shape).

A cold start is isothermal and dry, so no convection scheme acts in its
first steps; `convective_start` gives a conditionally unstable start (a
6.5 K/km lapse rate from 300 K at the surface and 80% relative humidity
below sigma 0.7) for comparisons that should see the schemes act.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from isca_tpu_torch.dycore.time_integration import TwoLevel
from isca_tpu_torch.spectral import transforms as tr
from isca_tpu_torch.utils.time_interp import PressureTimeSeries, monthly_climatology

SEED = 20261017
YEAR_SECONDS = 360 * 86400.0
MONTHS = 12
# ozone climatology levels [Pa], increasing: 1 Pa to 1000 hPa
O3_PLEVS = np.geomspace(1.0, 1.0e5, 24)
HPRIME_LAND = 300.0          # m, subgrid orography over land (mg_drag)
BL_SCHEMES = ("mellor_yamada", "edt", "entrain", "stable_bl")


def _month_phase():
    return 2.0 * np.pi * (np.arange(MONTHS) + 0.5) / MONTHS


def ozone_fields(lat_deg, seed=SEED):
    """(12, nlat, 1, nplev) zonal-mean ozone mass mixing ratio on O3_PLEVS:
    a stratospheric layer peaking near 10 hPa at ~1.6e-5 kg/kg, thicker
    toward the winter pole, with 2% seeded noise."""
    rng = np.random.default_rng(seed)
    lat = np.asarray(lat_deg, np.float64)[None, :, None, None]
    season = np.cos(_month_phase())[:, None, None, None]
    lnp = np.log(O3_PLEVS / 1.0e3)[None, None, None, :]
    peak = 1.6e-5 * (1.0 + 0.25 * season * np.sin(np.deg2rad(lat)))
    prof = peak * np.exp(-0.5 * (lnp / 1.3) ** 2) + 3.0e-8
    noise = 1.0 + 0.02 * rng.standard_normal((MONTHS, lat.shape[1], 1, O3_PLEVS.size))
    return prof * noise


def qflux_fields(lat_deg, nlon, seed=SEED + 1):
    """(12, nlat, nlon) ocean q-flux [W/m2]: qflux.f90's analytic profile
    (qflux_amp 30 W/m2, width 16 degrees) with its centre following the sun
    by 5 degrees, and 2 W/m2 of seeded noise."""
    rng = np.random.default_rng(seed)
    lat = np.asarray(lat_deg, np.float64)[None, :, None]
    centre = 5.0 * np.sin(_month_phase())[:, None, None]
    x = (lat - centre) / 16.0
    q = 30.0 * (1.0 - 2.0 * x**2) * np.exp(-x**2) / np.maximum(np.cos(np.deg2rad(lat)), 0.1)
    return np.broadcast_to(q, (MONTHS, lat.shape[1], nlon)) + 2.0 * rng.standard_normal(
        (MONTHS, lat.shape[1], nlon))


def sst_fields(lat_deg, nlon, seed=SEED + 2):
    """(12, nlat, nlon) SSTs [K]: the APE profile 27 K (1 - sin^2(3 lat/2))
    above 273.15 K equatorward of 60 degrees, its maximum following the sun
    by 5 degrees, with 0.2 K of seeded noise."""
    rng = np.random.default_rng(seed)
    lat = np.asarray(lat_deg, np.float64)[None, :, None] - 5.0 * np.sin(
        _month_phase())[:, None, None]
    ape = np.where(np.abs(lat) < 60.0, 27.0 * (1.0 - np.sin(np.deg2rad(1.5 * lat)) ** 2), 0.0)
    return np.broadcast_to(273.15 + ape, (MONTHS, lat.shape[1], nlon)) + 0.2 * \
        rng.standard_normal((MONTHS, lat.shape[1], nlon))


def ice_fields(lat_deg, nlon, seed=SEED + 3):
    """(12, nlat, nlon) sea-ice concentration in [0, 1]: a 10-degree ramp to
    full cover poleward of 60-70 degrees, reaching furthest in each
    hemisphere's winter, with 0.05 of seeded noise."""
    rng = np.random.default_rng(seed)
    lat = np.asarray(lat_deg, np.float64)[None, :, None]
    season = np.cos(_month_phase())[:, None, None]
    edge = 65.0 + 5.0 * season * np.sign(lat)
    conc = np.clip((np.abs(lat) - edge) / 10.0 + 0.5, 0.0, 1.0)
    conc = conc + 0.05 * rng.standard_normal((MONTHS, lat.shape[1], nlon))
    return np.clip(np.broadcast_to(conc, (MONTHS, lat.shape[1], nlon)), 0.0, 1.0)


def _lat_deg(model):
    """The whole globe's latitudes [deg] (the band's rows are cut later)."""
    lats = tr.global_lats(model.core.T)
    return np.degrees(lats.detach().cpu().numpy().astype(np.float64))


def _series(model, fields):
    """A monthly series of whole-globe (12, nlat, ...) fields, this rank's
    rows of them on a mesh."""
    fields = model.core.T.local_lat(fields, axis=1)
    return monthly_climatology(fields, YEAR_SECONDS, model.config.core.dtype, model.device)


def globe_transforms(model):
    """The model's transforms when they hold the whole globe; on a mesh,
    mesh-less ones of the same truncation and dtype on the model's device
    (for band_limit_topography)."""
    T, c = model.core.T, model.config.core
    if T.mesh is None:
        return T
    return tr.make_transforms(c.resolution, nlon=c.nlon, nlat=c.nlat,
                              radius=c.constants.radius, dtype=c.dtype,
                              make_symmetric=c.make_symmetric,
                              precision=c.transform_precision,
                              fourier_method=c.fourier_method,
                              truncation_shape=c.truncation_shape,
                              fourier_inc=c.fourier_inc, device=model.device)


def mima_gwd_config(dtype=torch.float32, **core_overrides):
    """mima_test_case_config() with mima.nml's damping_driver_nml and
    do_cg_drag (CgDragConfig() defaults)."""
    from isca_tpu_torch.models.moist import mima_test_case_config
    from isca_tpu_torch.physics.damping_driver import DampingDriverConfig

    cfg = mima_test_case_config(dtype=dtype, **core_overrides)
    return dataclasses.replace(cfg, physics=dataclasses.replace(
        cfg.physics, do_damping=True,
        damping=DampingDriverConfig(do_rayleigh=True, trayfric=-0.5, sponge_pbottom=50.0,
                                    do_conserve_energy=True, do_cg_drag=True)))


def add_mima_series(model, seed=SEED):
    """Attach the seeded 12-month ozone (RRTM's o3 input) and q-flux series."""
    lat = _lat_deg(model)
    dtype, dev = model.config.core.dtype, model.device
    model.physics.o3_series = PressureTimeSeries(
        series=_series(model, ozone_fields(lat, seed)),
        plevs=torch.as_tensor(O3_PLEVS).to(device=dev, dtype=dtype))
    model.physics.qflux_series = _series(model, qflux_fields(lat, model.core.T.nlon, seed + 1))
    return model


def continents_config(dtype=torch.float32, continents_sst=False, **core_overrides):
    """realistic_continents_test_case.py (GreyMoistConfig() with the bucket),
    with exact transforms; continents_sst adds the prescribed ocean SSTs, the
    sea-ice albedo and the orographic gravity-wave drag."""
    from isca_tpu_torch.models.moist import GreyMoistConfig
    from isca_tpu_torch.physics.damping_driver import DampingDriverConfig

    cfg = GreyMoistConfig()
    physics = dataclasses.replace(cfg.physics, bucket=True)
    if continents_sst:
        physics = dataclasses.replace(
            physics,
            mixed_layer=dataclasses.replace(physics.mixed_layer, do_sc_sst=True,
                                            specify_sst_over_ocean_only=True,
                                            update_albedo_from_ice=True),
            do_damping=True, damping=DampingDriverConfig(do_mg_drag=True))
    return dataclasses.replace(
        cfg, core=dataclasses.replace(cfg.core, dtype=dtype, **core_overrides),
        physics=physics)


def continents_land(model):
    """The idealized continents and the Sauliere 2012 topography band-limited
    through the model's truncation, as numpy (land mask, height in m) on the
    whole globe, also on a mesh (set_land keeps the band)."""
    from isca_tpu_torch.utils.land_generator import generate_land
    from isca_tpu_torch.utils.topography import band_limit_topography

    T = globe_transforms(model)
    lats, lons = np.degrees(T.lats.cpu().numpy()), np.degrees(T.lons.cpu().numpy())
    land, topo = generate_land(lats, lons, "continents", topo_mode="sauliere2012")
    topo = band_limit_topography(T, np.asarray(topo, np.float64), n_smooth_passes=2,
                                 smooth_fraction=0.02)
    topo = topo.cpu().numpy() if torch.is_tensor(topo) else topo
    return np.asarray(land, np.float64), np.asarray(topo, np.float64)


def set_continents(model, seed=SEED):
    """Attach the continents; with do_mg_drag, hprime = 300 m over land; with
    do_sc_sst, the seeded SST and sea-ice series."""
    land, topo = continents_land(model)
    model.set_land(land, surf_geopotential=topo)
    pc = model.config.physics
    if pc.do_damping and pc.damping.do_mg_drag:
        model.physics.hprime = torch.where(model.land_mask > 0.5, HPRIME_LAND, 0.0).to(
            model.config.core.dtype)
    if pc.mixed_layer.do_sc_sst:
        lat, nlon = _lat_deg(model), model.core.T.nlon
        model.physics.sst_series = _series(model, sst_fields(lat, nlon, seed + 2))
        model.physics.ice_series = _series(model, ice_fields(lat, nlon, seed + 3))
    return model


def ras_bl_config(dtype=torch.float32, scheme="RAS", **core_overrides):
    """frierson_test_case_config() with RAS convection (scheme "RAS"), or
    with its simple Betts-Miller and the named boundary-layer scheme;
    "stable_bl" comes with shallow convection."""
    from isca_tpu_torch.models.moist import frierson_test_case_config

    cfg = frierson_test_case_config(dtype=dtype)
    cfg = dataclasses.replace(cfg, core=dataclasses.replace(cfg.core, **core_overrides))
    if scheme == "RAS":
        physics = dataclasses.replace(cfg.physics, convection_scheme="RAS")
    else:
        physics = dataclasses.replace(cfg.physics, bl_scheme=scheme,
                                      do_shallow_conv=scheme == "stable_bl")
    return dataclasses.replace(cfg, physics=physics)


def convective_start(model):
    """The model's initial state with a conditionally unstable column
    everywhere: T = 300 K sigma^(R Gamma / g) (Gamma = 6.5 K/km) floored at
    200 K, band-limited through the model's truncation, and specific
    humidity 0.8 qs(T, p) where sigma > 0.7 (the initial value above)."""
    from isca_tpu_torch.physics.sat_vapor_pres import SatVaporPres

    state = model.initial_state()
    core, C = model.core, model.core.C
    dyn = state.dyn
    ps = dyn.psg.curr
    p_half = core.pk[:, None, None] + core.bk[:, None, None] * ps
    p_full = 0.5 * (p_half[1:] + p_half[:-1])
    sigma = p_full / ps
    tg = torch.clamp(300.0 * sigma ** (C.rdgas * 6.5e-3 / C.grav), min=200.0)
    ts = tr.grid_to_spec(core.T, tg)
    tg = tr.spec_to_grid(core.T, ts)
    qs = SatVaporPres(constants=C, do_simple=model.config.physics.do_simple_sat).qs(tg, p_full)
    q = torch.where(sigma > 0.7, 0.8 * qs, dyn.tracers["sphum"].curr)
    dyn.tg, dyn.ts = TwoLevel(tg, tg), TwoLevel(ts, ts)
    dyn.tracers["sphum"] = TwoLevel(q, q)
    return state
