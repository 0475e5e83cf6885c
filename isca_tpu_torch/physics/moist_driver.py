"""Idealized moist physics driver (Frierson grey-radiation tier and beyond).

Port of isca_tpu/physics/moist_driver.py (reference:
src/atmos_spectral/driver/solo/idealized_moist_phys.F90:819-1395).
Sequencing: convection -> large-scale condensation -> radiation down-sweep
-> surface fluxes -> radiation up-sweep -> boundary-layer diffusivities ->
vertical-diffusion down-sweep -> mixed-layer implicit surface energy balance
-> vertical-diffusion up-sweep.

Every branch of isca_tpu's driver is ported: simple and full Betts-Miller,
relaxed Arakawa-Schubert (RAS), dry or no convection, large-scale
condensation, SimCloud or SPOOKIE diagnostic clouds, grey two-stream, RRTM
(RRTMG-SW with RRTMG-LW or grey LW) or SOCRATES radiation (the clouds feed
RRTM's and SOCRATES' cloud optics), every step or every `dt_rad` seconds
(substepping), bulk surface fluxes over ocean and land (with the Manabe
bucket's evaporation limit, `bucket=True`, whose depth the GCM leapfrogs
from `dt_bucket`), the giant-planet lower boundary (interior heat flux and
Rayleigh bottom drag, no surface fluxes), the upper-atmosphere damping
(Rayleigh sponge, orographic and convective gravity-wave drags, constant
drag), the K-profile diffusivity or the MY2.5, EDT, entrain and stable-BL
schemes with optional shallow convection, vertical diffusion and the slab
mixed layer with its land options. A land mask, surface height and
subgrid-orography height (`hprime`) are attached by the model, the
convective-drag tables by `init_cg_drag`, and time series by the user:
`co2_series`, `sst_series` (prescribed SSTs, `do_sc_sst`), `ice_series`
(sea-ice albedo, `update_albedo_from_ice`), `qflux_series` (ocean q-flux)
and `o3_series` (an ozone PressureTimeSeries for RRTM or SOCRATES). A
series must lie on the model's device. Only `do_topo_drag` raises
NotImplementedError, as the reference's FATAL stub does. MY2.5's TKE is
model state, passed in as `tke` and returned in the diagnostics.

Prognostic fields are taken at the `previous` time level, pressures/heights
at `current`. The mixed layer advances with dt_real (not the leapfrog 2*dt).
All physics tensors are level-LAST (..., L) columns.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch
from torch.profiler import record_function

from isca_tpu_torch.constants import Constants, EARTH
from isca_tpu_torch.physics.betts_miller import BettsMiller, BettsMillerConfig
from isca_tpu_torch.physics.bl_schemes import (
    ShallowConvConfig,
    StableBLConfig,
    shallow_conv,
    stable_bl_turb,
)
from isca_tpu_torch.physics.cloud_simple import (
    CloudSimple,
    CloudSimpleConfig,
    CloudSimpleResult,
    CloudSpookieConfig,
    cloud_spookie,
)
from isca_tpu_torch.physics.damping_driver import (
    DampingDriverConfig,
    check_ported as check_damping_ported,
    damping_driver,
)
from isca_tpu_torch.physics.diffusivity import DiffusivityConfig, diffusivity
from isca_tpu_torch.physics.dry_convection import DryConvectionConfig, dry_convection
from isca_tpu_torch.physics.edt import EDTConfig, edt
from isca_tpu_torch.physics.entrain import EntrainConfig, entrain
from isca_tpu_torch.physics.gravity_wave_drag import CgDrag
from isca_tpu_torch.physics.giant_planet import (
    GiantPlanetConfig,
    gp_surface_flux,
    rayleigh_bottom_drag,
)
from isca_tpu_torch.physics.lscale_cond import LscaleCond, LscaleCondConfig
from isca_tpu_torch.physics.mixed_layer import (
    MixedLayerConfig,
    albedo_with_ice,
    analytic_qflux,
    heat_capacity_field,
    mixed_layer_step,
    surface_albedo,
    warmpool_qflux,
)
from isca_tpu_torch.physics.my25_turb import MY25Config, my25_turb
from isca_tpu_torch.physics.qe_moist_convection import (
    QEMoistConvection,
    QEMoistConvectionConfig,
)
from isca_tpu_torch.physics.ras import RAS, RASConfig
from isca_tpu_torch.physics.sat_vapor_pres import SatVaporPres
from isca_tpu_torch.physics.surface_flux import SurfaceFluxConfig, surface_flux
from isca_tpu_torch.physics.two_stream_gray import TwoStreamConfig, TwoStreamGray
from isca_tpu_torch.physics.vert_diff import gcm_vert_diff_down, gcm_vert_diff_up


@dataclasses.dataclass(frozen=True)
class MoistPhysicsConfig:
    convection_scheme: str = "SIMPLE_BETTS_MILLER"   # | FULL_BETTS_MILLER | RAS | NONE | DRY
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
    radiation_scheme: str = "two_stream"   # | "rrtm" (RRTMG-SW + RRTMG-LW or grey LW)
    #                                      | "socrates"
    do_cloud_simple: bool = False    # SimCloud diagnostic clouds (idealized_moist_phys.F90:120)
    do_cloud_spookie: bool = False   # SPOOKIE-protocol clouds (mutually exclusive)
    do_simple_sat: bool = True          # sat_vapor_pres do_simple (Frierson)
    roughness_mom: float = 0.05
    roughness_heat: float = 0.05
    roughness_moist: float = 0.05
    land_roughness_prefactor: float = 1.0
    gust_const: float = 1.0
    do_conserve_energy_diff: bool = True
    # radiation timestep [s]; <= dt means every step (rrtm_radiation_nml
    # dt_rad). When larger, heating rates and surface radiative fluxes are
    # stored and reused between radiation calls.
    dt_rad: float = 0.0
    convection: QEMoistConvectionConfig = QEMoistConvectionConfig()
    condensation: LscaleCondConfig = LscaleCondConfig(do_simple=False, do_evap=False)
    radiation: TwoStreamConfig = TwoStreamConfig()
    surface: SurfaceFluxConfig = SurfaceFluxConfig()
    # vert_turb_driver.F90:103-122 scheme selection: do_diffusivity /
    # do_mellor_yamada / do_entrain / do_edt / do_stable_bl (+shallow_conv)
    bl_scheme: str = "diffusivity"   # | "mellor_yamada" (or "my25") | "entrain"
    #                                | "edt" | "stable_bl"
    bl: DiffusivityConfig = DiffusivityConfig(do_simple=True, frac_inner=0.1)
    my25: "MY25Config | None" = None
    entrain: "EntrainConfig | None" = None
    edt: "EDTConfig | None" = None
    stable_bl: "StableBLConfig | None" = None
    do_shallow_conv: bool = False    # add shallow-convection K to diff_t
    shallow_conv: "ShallowConvConfig | None" = None
    mixed_layer: MixedLayerConfig = MixedLayerConfig()
    dry_convection: DryConvectionConfig = DryConvectionConfig()
    betts_miller: BettsMillerConfig = BettsMillerConfig()
    ras: RASConfig = RASConfig()
    damping: DampingDriverConfig = DampingDriverConfig()
    giant: GiantPlanetConfig = GiantPlanetConfig()
    cloud: CloudSimpleConfig = CloudSimpleConfig()
    spookie: "CloudSpookieConfig | None" = None
    rrtm: "RRTMConfig | None" = None       # used when radiation_scheme="rrtm"
    socrates: "SocratesConfig | None" = None   # radiation_scheme="socrates"
    constants: Constants = EARTH


class RadCache(NamedTuple):
    """Stored radiation results for dt_rad substepping (the reference
    rrtm adapter's stored intermediate fluxes, rrtm_radiation.F90:150-205:
    radiation is recomputed every `dt_rad` seconds and the heating rates and
    surface fluxes reused in between).

    `age` is a 0-d int32 tensor on the host, wherever the fields lie: the
    driver decides from it whether to compute radiation, and so reads
    nothing from the device. A restart stores it as isca_tpu's does."""
    tdt_rad: torch.Tensor          # (..., L)
    tdt_solar: torch.Tensor        # (..., L)
    olr: torch.Tensor              # (...)
    net_surf_sw_down: torch.Tensor
    surf_lw_down: torch.Tensor
    coszen: torch.Tensor
    net_lw_surf: torch.Tensor
    age: torch.Tensor              # int32 steps since last radiation call (host)


def rad_age(n) -> torch.Tensor:
    """RadCache.age: a 0-d int32 tensor on the host."""
    return torch.tensor(n, dtype=torch.int32)


def zero_rad_cache(shape2d, L, dtype, device=None):
    z2 = torch.zeros(shape2d, dtype=dtype, device=device)
    z3 = torch.zeros(tuple(shape2d) + (L,), dtype=dtype, device=device)
    return RadCache(tdt_rad=z3, tdt_solar=z3, olr=z2, net_surf_sw_down=z2,
                    surf_lw_down=z2, coszen=z2, net_lw_surf=z2, age=rad_age(0))


def rad_due(cfg, dt_real, rad_cache) -> bool:
    """Whether this step computes radiation: every step unless dt_rad > dt,
    then every n_rad = round(dt_rad / dt) steps, when the cache's age is a
    multiple of n_rad (isca_tpu's `rad_cache.age % n_rad == 0`). A cold
    start's age 0 computes; a computed step sets age 1, a reused one adds 1.
    Reads the host's age only."""
    if not (cfg.dt_rad > dt_real and rad_cache is not None):
        return True
    if rad_cache.age.device.type != "cpu":
        raise ValueError("RadCache.age must lie on the host (rad_age), not on "
                         f"{rad_cache.age.device}: the step would wait for the device")
    n_rad = max(1, int(round(cfg.dt_rad / dt_real)))
    return int(rad_cache.age) % n_rad == 0


class MoistPhysicsResult(NamedTuple):
    dt_u: torch.Tensor
    dt_v: torch.Tensor
    dt_t: torch.Tensor
    dt_q: torch.Tensor
    t_surf: torch.Tensor
    diagnostics: dict
    rad_cache: RadCache | None = None


def _check_ported(cfg: MoistPhysicsConfig):
    if cfg.radiation_scheme.lower() not in ("two_stream", "rrtm", "socrates"):
        raise NotImplementedError(
            f"MoistPhysicsConfig(radiation_scheme={cfg.radiation_scheme!r}) is "
            "not a radiation scheme of isca_tpu_torch")
    if cfg.do_damping:
        check_damping_ported(cfg.damping)


def _series_device(series):
    """The device of a TimeSeries or PressureTimeSeries."""
    return getattr(series, "series", series).times.device


class MoistPhysics:
    def __init__(self, config: MoistPhysicsConfig, lats, lons):
        """lats (nlat,), lons (nlon,) in radians, on the device the physics
        runs on."""
        _check_ported(config)
        self.config = config
        self.C = config.constants
        self.svp = SatVaporPres(constants=self.C, do_simple=config.do_simple_sat)
        self.convection = QEMoistConvection(config.convection, self.svp)
        self.betts_miller = BettsMiller(config.betts_miller, self.svp)
        self.ras = RAS(config.ras, self.svp)
        self.condensation = LscaleCond(config.condensation, self.svp)
        if config.radiation_scheme.lower() == "rrtm":
            from isca_tpu_torch.physics.rrtm_radiation import RRTMConfig, RRTMRadiation
            self.radiation = RRTMRadiation(config.rrtm or RRTMConfig(),
                                           device=lats.device)
        elif config.radiation_scheme.lower() == "socrates":
            # built without a dtype, as isca_tpu's driver builds it: SOCRATES
            # runs in float32 whatever the model's dtype
            from isca_tpu_torch.physics.socrates import SocratesConfig, SocratesRadiation
            self.radiation = SocratesRadiation(config.socrates or SocratesConfig(),
                                               device=lats.device)
        else:
            self.radiation = TwoStreamGray(config.radiation)
        self.cloud = CloudSimple(config.cloud, self.svp) if config.do_cloud_simple else None
        self.spookie_cfg = (config.spookie or CloudSpookieConfig()
                            if config.do_cloud_spookie else None)
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
        self.sst_series = None   # optional TimeSeries of prescribed SSTs (lat, lon)
        self.ice_series = None   # optional TimeSeries of sea-ice concentration
        self.qflux_series = None  # optional TimeSeries of ocean q-flux (load_qflux)
        self.o3_series = None    # optional PressureTimeSeries of ozone mmr
        self.hprime = torch.zeros_like(self.lat2d)  # subgrid-orography stdev (mg_drag)
        self.cg_drag = None      # CgDrag instance; see init_cg_drag

    def init_cg_drag(self, pref):
        """Build the convective-GWD source tables from reference full-level
        pressures (cg_drag_init needs pref; called by the model after the
        vertical coordinate exists)."""
        self.cg_drag = CgDrag(self.config.damping.cg, self.lat2d, pref)

    def _clouds(self, p_half, p_full, t, q, z_full, wg_full) -> CloudSimpleResult:
        """SimCloud (ocean where the land mask is at most 0.5) or SPOOKIE."""
        if self.cloud is not None:
            ocean = (self.land_mask <= 0.5) if self.land_mask is not None else None
            return self.cloud(p_half, p_full, t, q, z_full,
                              wg_full if wg_full is not None else torch.zeros_like(t),
                              p_half[..., -1], ocean=ocean)
        cf, _, reff, qcl, diag = cloud_spookie(self.spookie_cfg, self.svp, p_full, t, q)
        return CloudSimpleResult(cf=cf, reff_rad=reff, qcl_rad=qcl,
                                 frac_liq=diag["frac_liq"], diagnostics=diag)

    def _boundary_layer(self, diag, rad, dt_real, u, v, t, q, p_full, p_half,
                        z_full, z_half, u_star, b_star, tke):
        """The boundary-layer diffusivities (k_m, k_t) of cfg.bl_scheme
        (vert_turb_driver.F90:103-142), plus shallow convection's heat K;
        their diagnostics (z_pbl and the scheme's own) go into `diag`."""
        cfg, C = self.config, self.C
        scheme = cfg.bl_scheme.lower()
        z_surf = z_half[..., -1:]
        zf_ag, zh_ag = z_full - z_surf, z_half - z_surf
        if scheme in ("mellor_yamada", "my25"):
            # MY2.5 branch: prognostic-TKE closure
            my_cfg = cfg.my25 or MY25Config(grav=C.grav)
            shape2d = t.shape[:-1]
            fracland = (self.land_mask if self.land_mask is not None
                        else torch.zeros(shape2d, dtype=t.dtype, device=t.device))
            theta = t * (1.0e5 / p_full) ** C.kappa
            z0 = torch.full(shape2d, cfg.roughness_mom, dtype=t.dtype, device=t.device)
            if tke is None:
                tke = torch.zeros(tuple(shape2d) + (t.shape[-1] + 1,), dtype=t.dtype,
                                  device=t.device)
            with record_function("my25"):
                my = my25_turb(my_cfg, dt_real, fracland, p_half, p_full, theta,
                               u, v, zh_ag, zf_ag, z0, tke, u_star=u_star)
            km, kt = my.akm, my.akh
            diag["tke"] = my.tke
            diag["el0"] = my.el0
            # PBL top: highest level with TKE above threshold
            active = my.tke[..., 1:] > 1.0e-3
            diag["z_pbl"] = torch.amax(torch.where(active, zh_ag[..., 1:], 0.0), dim=-1)
        elif scheme == "edt":
            # EDT branch (Grenier-Bretherton TKE)
            zeros3 = torch.zeros_like(t)
            with record_function("edt"):
                r = edt(cfg.edt or EDTConfig(constants=C), rad.tdt_rad - rad.tdt_solar,
                        u_star, b_star, t, q, zeros3, zeros3, diag.get("cf", zeros3),
                        u, v, z_full, p_full, z_half, p_half)
            km, kt = r.k_m, r.k_t
            diag["z_pbl"] = r.pblh
            diag["tke_edt"] = r.tke
        elif scheme == "entrain":
            # entrain branch (Bretherton closure): base diffusivities from the
            # K-profile scheme, overwritten inside detected mixed layers
            base = diffusivity(cfg.bl, t, q, u, v, p_full, p_half, zf_ag, zh_ag,
                               u_star, b_star)
            zeros3 = torch.zeros_like(t)
            with record_function("entrain"):
                r = entrain(cfg.entrain or EntrainConfig(constants=C),
                            rad.tdt_rad - rad.tdt_solar,
                            torch.zeros_like(u_star, dtype=torch.bool),
                            u_star, b_star, t, q, zeros3, zeros3, diag.get("cf", zeros3),
                            u, v, z_full, p_full, z_half, p_half, base.k_m, base.k_t)
            km, kt = r.k_m, r.k_t
            diag["z_pbl"] = torch.maximum(r.zsml, r.zradtop)
            diag["wentr_pbl"] = r.wentr_pbl
        elif scheme == "stable_bl":
            # stable-BL branch (Louis/MO local K)
            with record_function("stable_bl"):
                r = stable_bl_turb(cfg.stable_bl or StableBLConfig(constants=C), self.lat2d,
                                   t, q, u, v, zf_ag, zh_ag, u_star, b_star)
            km, kt = r.akm, r.akh
            diag["z_pbl"] = r.z_sbl
        else:
            bl = diffusivity(cfg.bl, t, q, u, v, p_full, p_half, zf_ag, zh_ag,
                             u_star, b_star)
            km, kt = bl.k_m, bl.k_t
            diag["z_pbl"] = bl.h_pbl

        if cfg.do_shallow_conv:
            # shallow_conv adds to the heat K (vert_turb_driver.F90:103)
            with record_function("shallow_conv"):
                akhsc, _ = shallow_conv(cfg.shallow_conv or ShallowConvConfig(constants=C),
                                        self.svp, t, q, p_full, p_half)
            kt = kt + akhsc
            diag["akhsc"] = akhsc
        return km, kt

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
        time_seconds=0.0,       # model time for time-varying inputs
        wg_full=None,           # (..., L) pressure velocity for SimCloud
        tke=None,               # (..., L+1) MY2.5 TKE state when bl_scheme
        rad_cache=None,         # RadCache for dt_rad substepping
    ) -> MoistPhysicsResult:
        cfg, C = self.config, self.C
        for name in ("co2_series", "sst_series", "ice_series", "qflux_series", "o3_series"):
            series = getattr(self, name)
            if series is not None and _series_device(series) != t_prev.device:
                # at() would move the model time to the series' device every step
                raise ValueError(
                    f"MoistPhysics.{name} lies on {_series_device(series)}, the model "
                    f"on {t_prev.device}: build the series on the model's device")
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
        if cfg.convection_scheme in ("SIMPLE_BETTS_MILLER", "FULL_BETTS_MILLER"):
            scheme = (self.convection if cfg.convection_scheme == "SIMPLE_BETTS_MILLER"
                      else self.betts_miller)
            conv = scheme(delta_t, t_prev, q_prev, p_full_prev, p_half_prev)
            tg_tmp = t_prev + conv.deltaT
            qg_tmp = q_prev + conv.deltaq
            dt_t = dt_t + conv.deltaT / delta_t
            dt_q = dt_q + conv.deltaq / delta_t
            conv_rain = conv.rain / delta_t
            depth_change_conv = conv.rain / C.dens_h2o
            diag.update(convection_rain=conv_rain, cape=conv.cape, cin=conv.cin)
        elif cfg.convection_scheme == "RAS":
            # Relaxed Arakawa-Schubert (idealized_moist_phys.F90:932)
            with record_function("ras"):
                rr = self.ras(delta_t, t_prev, q_prev, u_prev, v_prev,
                              p_full_prev, p_half_prev,
                              z_half_curr - z_half_curr[..., -1:])
            tg_tmp = t_prev + rr.dt_t
            qg_tmp = q_prev + rr.dt_q
            dt_t = dt_t + rr.dt_t / delta_t
            dt_q = dt_q + rr.dt_q / delta_t
            dt_u = dt_u + rr.dt_u / delta_t
            dt_v = dt_v + rr.dt_v / delta_t
            conv_rain = (rr.rain + rr.snow) / delta_t
            depth_change_conv = rr.rain / C.dens_h2o
            diag.update(convection_rain=conv_rain, klcl=rr.klcl,
                        ras_precip_ev=rr.precip_ev / delta_t)
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

        # ---- SimCloud or SPOOKIE diagnostic clouds (idealized_moist_phys.F90:1016-1033) ----
        clouds = None
        if self.cloud is not None or self.spookie_cfg is not None:
            with record_function("cloud_simple"):
                clouds = self._clouds(p_half_curr, p_full_curr, t_prev, q_prev,
                                      z_full_curr, wg_full)
            diag.update(clouds.diagnostics)

        # ---- radiation: downward pass ----
        albedo = surface_albedo(cfg.mixed_layer, self.lat2d, self.land_mask).expand(
            shape2d).to(t_prev.dtype)
        if cfg.mixed_layer.update_albedo_from_ice and self.ice_series is not None:
            albedo = albedo_with_ice(cfg.mixed_layer, albedo,
                                     self.ice_series.at(time_seconds))
            diag["albedo"] = albedo
        if self.o3_series is not None and hasattr(self.radiation, "o3_field"):
            # time-varying ozone climatology interpolated onto the current
            # model pressures (rrtm_radiation.F90 o3 input via interpolator)
            self.radiation.o3_field = self.o3_series.at(time_seconds, p_full_curr)
        dt_rad_avg = cfg.radiation.dt_rad_avg if cfg.radiation.dt_rad_avg > 0 else dt_real
        dt_rad_radians = dt_rad_avg / C.seconds_per_day * 2.0 * math.pi
        co2 = self.co2_series.at(time_seconds) if self.co2_series is not None else None
        rad_kw = {} if co2 is None else {"carbon_conc": co2}
        if clouds is not None and cfg.radiation_scheme.lower() in ("rrtm", "socrates"):
            # SimCloud -> RRTMG-SW / SOCRATES cloud optics (set_cld staging;
            # for RRTM a coupling the reference leaves commented out); the
            # grey two-stream scheme takes no clouds
            rad_kw["cloud_fields"] = (clouds.cf, clouds.reff_rad,
                                      clouds.qcl_rad, clouds.frac_liq)
        if rad_due(cfg, dt_real, rad_cache):
            rad_down = self.radiation.down(
                self.lat2d, self.lon2d, p_half_curr, t_prev, q_prev, albedo,
                gmt=gmt, time_since_ae=time_since_ae, dt_rad_avg=dt_rad_radians, **rad_kw)
            rad_up = self.radiation.up(rad_down, p_half_curr, t_surf, albedo)
            rad = RadCache(
                tdt_rad=rad_up.tdt_rad, tdt_solar=rad_up.tdt_solar, olr=rad_up.olr,
                net_surf_sw_down=rad_down.net_surf_sw_down,
                surf_lw_down=rad_down.surf_lw_down, coszen=rad_down.coszen,
                net_lw_surf=rad_up.net_lw_surf, age=rad_age(1))
        else:
            # dt_rad substepping: reuse the stored heating and fluxes
            rad = rad_cache._replace(age=rad_cache.age + 1)

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

        # ---- upper-atmosphere damping (sponge + mg/cg gravity-wave drag) ----
        if cfg.do_damping:
            dmp = damping_driver(
                cfg.damping, delta_t, p_full_curr, u_prev, v_prev,
                dt_u, dt_v, dt_t,
                temp=t_prev, p_half=p_half_curr,
                z_full=z_full_curr, z_half=z_half_curr,
                hprime=self.hprime, cg=self.cg_drag, lat2d=self.lat2d,
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
        bl_km, bl_kt = self._boundary_layer(
            diag, rad, dt_real, u_prev, v_prev, t_prev, q_prev, p_full_curr, p_half_curr,
            z_full_curr, z_half_curr, u_star, b_star, tke)

        # ---- vertical diffusion down / mixed layer / up ----
        down = gcm_vert_diff_down(
            C, delta_t,
            u_prev, v_prev, t_prev, q_prev,
            bl_km, bl_kt,
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
            C_ml = cfg.mixed_layer
            heat_capacity = heat_capacity_field(C_ml, self.lon2d, self.lat2d,
                                                land_mask=self.land_mask, zsurf=self.zsurf)
            ocean_qflux = (self.qflux_series.at(time_seconds)
                           if self.qflux_series is not None else self.ocean_qflux)
            if (C_ml.update_albedo_from_ice and self.qflux_series is not None
                    and self.land_mask is not None):
                # time-varying q-flux is zeroed over land/ice points
                # (mixed_layer.F90:659-666)
                ocean_qflux = torch.where(self.land_mask > 0.5, 0.0, ocean_qflux)
            ml = mixed_layer_step(
                cfg.mixed_layer, dt_real, t_surf, down.tri,
                sf.flux_t, sf.flux_q, sf.flux_r,
                rad.net_surf_sw_down, rad.surf_lw_down,
                sf.dhdt_surf, sf.dedt_surf, sf.dedq_surf, sf.drdt_surf,
                sf.dhdt_atm, sf.dedq_atm,
                ocean_qflux=ocean_qflux,
                heat_capacity=heat_capacity,
                land_mask=self.land_mask,
                sst_prescribed=(self.sst_series.at(time_seconds)
                                if self.sst_series is not None else None),
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
