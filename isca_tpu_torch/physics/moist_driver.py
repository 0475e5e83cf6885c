"""Idealized moist physics driver (Frierson grey-radiation tier, RRTM radiation).

Port of isca_tpu/physics/moist_driver.py (reference:
src/atmos_spectral/driver/solo/idealized_moist_phys.F90:819-1395) for the
branches the single-column RRTM configuration takes. Sequencing: convection
-> large-scale condensation -> radiation down-sweep -> surface fluxes ->
radiation up-sweep -> boundary-layer diffusivities -> vertical-diffusion
down-sweep -> mixed-layer implicit surface energy balance -> vertical-diffusion
up-sweep.

Ported: simple Betts-Miller, dry or no convection, large-scale condensation,
grey two-stream or RRTM (RRTMG-SW + grey LW) radiation every step, bulk
surface fluxes over ocean and land (with the Manabe bucket's evaporation
limit, `bucket=True`, whose depth the GCM leapfrogs from `dt_bucket`), the
giant-planet lower boundary (interior heat flux and Rayleigh bottom drag,
no surface fluxes), the upper-atmosphere damping (Rayleigh sponge and
constant drag), the K-profile diffusivity, vertical diffusion and the slab
mixed layer with its land options. A land mask and surface height are
attached by the model (`land_mask`, `zsurf`), and a CO2 series by the user
(`co2_series`). Every other scheme and option raises NotImplementedError
when the driver is built: RAS and full Betts-Miller, SOCRATES, clouds, the
gravity-wave drags, the other boundary-layer schemes, shallow convection;
radiation substepping (dt_rad > dt) and the SST, sea-ice, q-flux and ozone
series raise when the driver is called. The keyword inputs of those
options (`wg_full`, `tke`, `rad_cache`) are accepted so that the GCM calls
both packages' drivers alike.

Prognostic fields are taken at the `previous` time level, pressures/heights
at `current`. The mixed layer advances with dt_real (not the leapfrog 2*dt).
All physics tensors are level-LAST (..., L) columns.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from isca_tpu_torch.constants import Constants, EARTH
from isca_tpu_torch.physics.damping_driver import (
    DampingDriverConfig,
    check_ported as check_damping_ported,
    damping_driver,
)
from isca_tpu_torch.physics.diffusivity import DiffusivityConfig, diffusivity
from isca_tpu_torch.physics.dry_convection import DryConvectionConfig, dry_convection
from isca_tpu_torch.physics.giant_planet import (
    GiantPlanetConfig,
    gp_surface_flux,
    rayleigh_bottom_drag,
)
from isca_tpu_torch.physics.lscale_cond import LscaleCond, LscaleCondConfig
from isca_tpu_torch.physics.mixed_layer import (
    MixedLayerConfig,
    analytic_qflux,
    heat_capacity_field,
    mixed_layer_step,
    surface_albedo,
    warmpool_qflux,
)
from isca_tpu_torch.physics.qe_moist_convection import (
    QEMoistConvection,
    QEMoistConvectionConfig,
)
from isca_tpu_torch.physics.sat_vapor_pres import SatVaporPres
from isca_tpu_torch.physics.surface_flux import SurfaceFluxConfig, surface_flux
from isca_tpu_torch.physics.two_stream_gray import TwoStreamConfig, TwoStreamGray
from isca_tpu_torch.physics.vert_diff import gcm_vert_diff_down, gcm_vert_diff_up


@dataclasses.dataclass(frozen=True)
class MoistPhysicsConfig:
    convection_scheme: str = "SIMPLE_BETTS_MILLER"   # | NONE | DRY (others not ported)
    turb: bool = True
    do_damping: bool = False
    mixed_layer_bc: bool = True
    gp_surface: bool = False         # giant-planet lower boundary
    # Manabe bucket hydrology (idealized_moist_phys.F90:147-155)
    bucket: bool = False
    init_bucket_depth: float = 1000.0
    init_bucket_depth_land: float = 20.0
    max_bucket_depth_land: float = 0.15
    robert_bucket: float = 0.04
    raw_bucket: float = 0.53
    radiation_scheme: str = "two_stream"   # | "rrtm" (RRTMG-SW + grey LW)
    do_cloud_simple: bool = False
    do_cloud_spookie: bool = False
    do_simple_sat: bool = True          # sat_vapor_pres do_simple (Frierson)
    roughness_mom: float = 0.05
    roughness_heat: float = 0.05
    roughness_moist: float = 0.05
    land_roughness_prefactor: float = 1.0
    gust_const: float = 1.0
    do_conserve_energy_diff: bool = True
    # radiation timestep [s]; <= dt means every step (the only ported case)
    dt_rad: float = 0.0
    convection: QEMoistConvectionConfig = QEMoistConvectionConfig()
    condensation: LscaleCondConfig = LscaleCondConfig(do_simple=False, do_evap=False)
    radiation: TwoStreamConfig = TwoStreamConfig()
    surface: SurfaceFluxConfig = SurfaceFluxConfig()
    bl_scheme: str = "diffusivity"   # others not ported
    bl: DiffusivityConfig = DiffusivityConfig(do_simple=True, frac_inner=0.1)
    do_shallow_conv: bool = False
    mixed_layer: MixedLayerConfig = MixedLayerConfig()
    dry_convection: DryConvectionConfig = DryConvectionConfig()
    damping: DampingDriverConfig = DampingDriverConfig()
    giant: GiantPlanetConfig = GiantPlanetConfig()
    rrtm: "RRTMConfig | None" = None       # used when radiation_scheme="rrtm"
    constants: Constants = EARTH


class RadCache(NamedTuple):
    """Stored radiation results for dt_rad substepping (the reference
    rrtm adapter's stored intermediate fluxes, rrtm_radiation.F90:150-205).
    Substepping is not ported: every step computes radiation and returns a
    fresh cache with age 1. The model state carries it, so that restarts
    interchange with isca_tpu's."""
    tdt_rad: torch.Tensor          # (..., L)
    tdt_solar: torch.Tensor        # (..., L)
    olr: torch.Tensor              # (...)
    net_surf_sw_down: torch.Tensor
    surf_lw_down: torch.Tensor
    coszen: torch.Tensor
    net_lw_surf: torch.Tensor
    age: torch.Tensor              # int32 steps since last radiation call


def zero_rad_cache(shape2d, L, dtype, device=None):
    z2 = torch.zeros(shape2d, dtype=dtype, device=device)
    z3 = torch.zeros(tuple(shape2d) + (L,), dtype=dtype, device=device)
    return RadCache(tdt_rad=z3, tdt_solar=z3, olr=z2, net_surf_sw_down=z2,
                    surf_lw_down=z2, coszen=z2, net_lw_surf=z2,
                    age=torch.zeros((), dtype=torch.int32, device=device))


class MoistPhysicsResult(NamedTuple):
    dt_u: torch.Tensor
    dt_v: torch.Tensor
    dt_t: torch.Tensor
    dt_q: torch.Tensor
    t_surf: torch.Tensor
    diagnostics: dict
    rad_cache: RadCache | None = None


def _check_ported(cfg: MoistPhysicsConfig):
    later = {
        "convection_scheme": cfg.convection_scheme not in ("SIMPLE_BETTS_MILLER", "NONE",
                                                           "DRY"),
        "radiation_scheme": cfg.radiation_scheme.lower() not in ("two_stream", "rrtm"),
        "do_cloud_simple": cfg.do_cloud_simple,
        "do_cloud_spookie": cfg.do_cloud_spookie,
        "bl_scheme": cfg.bl_scheme.lower() != "diffusivity",
        "do_shallow_conv": cfg.do_shallow_conv,
    }
    for name, unported in later.items():
        if unported:
            raise NotImplementedError(
                f"MoistPhysicsConfig({name}={getattr(cfg, name)!r}) is not "
                "ported to isca_tpu_torch yet")
    if cfg.do_damping:
        check_damping_ported(cfg.damping)


class MoistPhysics:
    def __init__(self, config: MoistPhysicsConfig, lats, lons):
        """lats (nlat,), lons (nlon,) in radians, on the device the physics
        runs on."""
        _check_ported(config)
        self.config = config
        self.C = config.constants
        self.svp = SatVaporPres(constants=self.C, do_simple=config.do_simple_sat)
        self.convection = QEMoistConvection(config.convection, self.svp)
        self.condensation = LscaleCond(config.condensation, self.svp)
        if config.radiation_scheme.lower() == "rrtm":
            from isca_tpu_torch.physics.rrtm_radiation import RRTMConfig, RRTMRadiation
            self.radiation = RRTMRadiation(config.rrtm or RRTMConfig(),
                                           device=lats.device)
        else:
            self.radiation = TwoStreamGray(config.radiation)
        self.lat2d = lats[:, None] * torch.ones_like(lons)[None, :]
        self.lon2d = torch.ones_like(lats)[:, None] * lons[None, :]
        ml = config.mixed_layer
        self.ocean_qflux = (analytic_qflux(ml, self.lat2d) if ml.do_qflux
                            else torch.zeros_like(self.lat2d))
        if ml.do_warmpool:
            self.ocean_qflux = self.ocean_qflux + warmpool_qflux(ml, self.lon2d, self.lat2d)
        self.land_mask = None    # optional (nlat, nlon) float mask set by the model
        self.zsurf = None        # optional (nlat, nlon) surface height in m
        self.co2_series = None   # optional TimeSeries of CO2 ppmv
        # the series hooks of isca_tpu not ported yet (ROADMAP A.5b): setting
        # one raises when the driver is called
        self.sst_series = None
        self.ice_series = None
        self.qflux_series = None
        self.o3_series = None

    def __call__(
        self,
        delta_t, dt_real,
        # level-last prognostic fields at `previous`
        u_prev, v_prev, t_prev, q_prev,
        # pressures/heights: previous and current
        p_full_prev, p_half_prev,
        p_full_curr, p_half_curr, z_full_curr, z_half_curr,
        t_surf,
        gmt=0.0, time_since_ae=0.0,
        bucket_depth=None,      # (lat, lon) at `current` when cfg.bucket
        time_seconds=0.0,       # model time (constant drag, CO2 series)
        wg_full=None,           # (..., L); feeds SimCloud (not ported)
        tke=None,               # (..., L+1); feeds MY2.5 (not ported)
        rad_cache=None,         # RadCache; feeds dt_rad substepping (not ported)
    ) -> MoistPhysicsResult:
        cfg, C = self.config, self.C
        if cfg.dt_rad > dt_real:
            raise NotImplementedError(
                "radiation substepping (dt_rad > dt) is not ported to "
                "isca_tpu_torch yet")
        for name in ("sst_series", "ice_series", "qflux_series", "o3_series"):
            if getattr(self, name) is not None:
                raise NotImplementedError(
                    f"MoistPhysics.{name} is not ported to isca_tpu_torch yet "
                    "(ROADMAP A.5b)")
        if self.co2_series is not None and self.co2_series.times.device != t_prev.device:
            # at() would move the model time to the series' device every step
            raise ValueError(
                f"MoistPhysics.co2_series lies on {self.co2_series.times.device}, the "
                f"model on {t_prev.device}: build the series on the model's device")
        shape2d = t_prev.shape[:-1]
        zero2 = torch.zeros(shape2d, dtype=t_prev.dtype, device=t_prev.device)
        full2 = lambda x: torch.full(shape2d, x, dtype=t_prev.dtype, device=t_prev.device)
        dt_u = torch.zeros_like(u_prev)
        dt_v = torch.zeros_like(v_prev)
        dt_t = torch.zeros_like(t_prev)
        dt_q = torch.zeros_like(q_prev)
        diag = {}

        # ---- convection ----
        depth_change_conv = zero2
        if cfg.convection_scheme == "SIMPLE_BETTS_MILLER":
            conv = self.convection(delta_t, t_prev, q_prev, p_full_prev, p_half_prev)
            tg_tmp = t_prev + conv.deltaT
            qg_tmp = q_prev + conv.deltaq
            dt_t = dt_t + conv.deltaT / delta_t
            dt_q = dt_q + conv.deltaq / delta_t
            conv_rain = conv.rain / delta_t
            depth_change_conv = conv.rain / C.dens_h2o
            diag.update(convection_rain=conv_rain, cape=conv.cape, cin=conv.cin)
        elif cfg.convection_scheme == "DRY":
            dc = dry_convection(cfg.dry_convection, t_prev, p_full_prev, p_half_prev)
            dt_t = dt_t + dc.dt_tg
            conv_rain = zero2
            diag.update(cape=dc.cape, cin=dc.cin)
        else:
            tg_tmp, qg_tmp = t_prev, q_prev
            conv_rain = zero2

        # ---- large-scale condensation (none with dry convection) ----
        depth_change_cond = zero2
        if cfg.convection_scheme != "DRY":
            cond = self.condensation(tg_tmp, qg_tmp, p_full_prev, p_half_prev)
            dt_t = dt_t + cond.tdel / delta_t
            dt_q = dt_q + cond.qdel / delta_t
            cond_rain = (cond.rain + cond.snow) / delta_t
            depth_change_cond = cond.rain / C.dens_h2o
            diag.update(condensation_rain=cond_rain)
        else:
            cond_rain = zero2
        diag["precipitation"] = conv_rain + cond_rain

        # ---- radiation: downward pass ----
        albedo = surface_albedo(cfg.mixed_layer, self.lat2d, self.land_mask).expand(
            shape2d).to(t_prev.dtype)
        dt_rad_avg = cfg.radiation.dt_rad_avg if cfg.radiation.dt_rad_avg > 0 else dt_real
        dt_rad_radians = dt_rad_avg / C.seconds_per_day * 2.0 * math.pi
        co2 = self.co2_series.at(time_seconds) if self.co2_series is not None else None
        rad_kw = {} if co2 is None else {"carbon_conc": co2}
        rad_down = self.radiation.down(
            self.lat2d, self.lon2d, p_half_curr, t_prev, q_prev, albedo,
            gmt=gmt, time_since_ae=time_since_ae, dt_rad_avg=dt_rad_radians, **rad_kw)
        rad_up = self.radiation.up(rad_down, p_half_curr, t_surf, albedo)
        rad = RadCache(
            tdt_rad=rad_up.tdt_rad, tdt_solar=rad_up.tdt_solar, olr=rad_up.olr,
            net_surf_sw_down=rad_down.net_surf_sw_down,
            surf_lw_down=rad_down.surf_lw_down, coszen=rad_down.coszen,
            net_lw_surf=rad_up.net_lw_surf,
            age=torch.ones((), dtype=torch.int32, device=t_prev.device))

        # ---- surface fluxes (lowest level, previous); none on a giant planet ----
        z_surf = z_half_curr[..., -1]
        sf = None
        if not cfg.gp_surface:
            land = self.land_mask > 0.5 if self.land_mask is not None else None
            rough_mom = full2(cfg.roughness_mom)
            rough_heat = full2(cfg.roughness_heat)
            rough_moist = full2(cfg.roughness_moist)
            if land is not None and cfg.land_roughness_prefactor != 1.0:
                # rougher (or smoother) land (idealized_moist_phys.F90:601-609)
                pf = cfg.land_roughness_prefactor
                rough_mom = torch.where(land, pf * rough_mom, rough_mom)
                rough_heat = torch.where(land, pf * rough_heat, rough_heat)
                rough_moist = torch.where(land, pf * rough_moist, rough_moist)
            sf = surface_flux(
                cfg.surface, self.svp,
                t_prev[..., -1], q_prev[..., -1], u_prev[..., -1], v_prev[..., -1],
                p_full_curr[..., -1], z_full_curr[..., -1] - z_surf,
                p_half_curr[..., -1], t_surf,
                rough_mom, rough_heat, rough_moist,
                full2(cfg.gust_const),
                land=land,
                bucket_depth=bucket_depth if cfg.bucket else None,
                max_bucket_depth_land=cfg.max_bucket_depth_land,
                dt=delta_t,
            )
            diag.update(flux_t=sf.flux_t, flux_lhe=C.hlv * sf.flux_q, u_star=sf.u_star)

        # ---- radiation heating added to dt_t ----
        dt_t = dt_t + rad.tdt_rad
        diag.update(olr=rad.olr, swdn_sfc=rad.net_surf_sw_down,
                    lwdn_sfc=rad.surf_lw_down, tdt_rad=rad.tdt_rad,
                    coszen=rad.coszen)

        # ---- giant-planet lower boundary: interior heat flux + bottom drag ----
        if cfg.gp_surface:
            dt_t = gp_surface_flux(cfg.giant, dt_t, p_half_curr)
            bd = rayleigh_bottom_drag(
                cfg.giant, delta_t, self.lat2d, u_prev, v_prev,
                p_half_prev, p_full_prev, dt_u, dt_v, dt_t)
            dt_u, dt_v, dt_t = bd.dt_u, bd.dt_v, bd.dt_t

        # ---- upper-atmosphere damping (Rayleigh sponge, constant drag) ----
        if cfg.do_damping:
            dmp = damping_driver(
                cfg.damping, delta_t, p_full_curr, u_prev, v_prev,
                dt_u, dt_v, dt_t, lat2d=self.lat2d,
                day_of_year=time_seconds / C.seconds_per_day,
                days_per_year=C.orbital_period / C.seconds_per_day,
            )
            dt_u, dt_v, dt_t = dmp.dt_u, dmp.dt_v, dmp.dt_t
            diag.update(dmp.diagnostics)

        if not cfg.turb:
            return MoistPhysicsResult(dt_u, dt_v, dt_t, dt_q, t_surf, diag,
                                      rad_cache=rad)

        # ---- boundary-layer diffusivities ----
        u_star, b_star = (sf.u_star, sf.b_star) if sf is not None else (zero2, zero2)
        bl = diffusivity(
            cfg.bl, t_prev, q_prev, u_prev, v_prev,
            p_full_curr, p_half_curr, z_full_curr - z_surf[..., None],
            z_half_curr - z_surf[..., None], u_star, b_star)
        diag["z_pbl"] = bl.h_pbl

        # ---- vertical diffusion down / mixed layer / up ----
        down = gcm_vert_diff_down(
            C, delta_t,
            u_prev, v_prev, t_prev, q_prev,
            bl.k_m, bl.k_t,
            p_half_curr, p_full_curr, z_full_curr,
            sf.flux_u if sf is not None else zero2,
            sf.flux_v if sf is not None else zero2,
            sf.dtaudu_atm if sf is not None else zero2,
            sf.dtaudv_atm if sf is not None else zero2,
            dt_u, dt_v, dt_t, dt_q,
            do_conserve_energy=cfg.do_conserve_energy_diff,
        )
        dt_u, dt_v = down.dt_u, down.dt_v

        if cfg.mixed_layer_bc and sf is not None:
            heat_capacity = heat_capacity_field(cfg.mixed_layer, self.lon2d, self.lat2d,
                                                land_mask=self.land_mask, zsurf=self.zsurf)
            ml = mixed_layer_step(
                cfg.mixed_layer, dt_real, t_surf, down.tri,
                sf.flux_t, sf.flux_q, sf.flux_r,
                rad.net_surf_sw_down, rad.surf_lw_down,
                sf.dhdt_surf, sf.dedt_surf, sf.dedq_surf, sf.drdt_surf,
                sf.dhdt_atm, sf.dedq_atm,
                ocean_qflux=self.ocean_qflux,
                heat_capacity=heat_capacity,
                land_mask=self.land_mask,
                lats=self.lat2d,
            )
            tri = down.tri._replace(delta_t=ml.delta_t, delta_q=ml.delta_q)
            t_surf_out = ml.t_surf
            diag["t_surf"] = ml.t_surf
        else:
            # giant-planet / no-slab: zero-exchange closure
            tri = down.tri
            t_surf_out = t_surf
        dt_t, dt_q = gcm_vert_diff_up(delta_t, tri)
        if cfg.bucket and sf is not None:
            depth_change_lh = sf.flux_q * delta_t / C.dens_h2o
            diag["dt_bucket"] = depth_change_cond + depth_change_conv - depth_change_lh
        return MoistPhysicsResult(dt_u, dt_v, dt_t, dt_q, t_surf_out, diag,
                                  rad_cache=rad)
