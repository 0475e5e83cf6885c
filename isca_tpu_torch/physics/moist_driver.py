"""Idealized moist physics driver (Frierson grey-radiation tier, RRTM radiation).

Port of isca_tpu/physics/moist_driver.py (reference:
src/atmos_spectral/driver/solo/idealized_moist_phys.F90:819-1395) for the
branches the single-column RRTM configuration takes. Sequencing: convection
-> large-scale condensation -> radiation down-sweep -> surface fluxes ->
radiation up-sweep -> boundary-layer diffusivities -> vertical-diffusion
down-sweep -> mixed-layer implicit surface energy balance -> vertical-diffusion
up-sweep.

Ported: simple Betts-Miller convection (or none), large-scale condensation,
grey two-stream or RRTM (RRTMG-SW + grey LW) radiation every step, bulk
surface fluxes, the K-profile diffusivity, vertical diffusion and the slab
mixed layer. Every other scheme and option raises NotImplementedError when
the driver is built: RAS, full Betts-Miller and dry convection, SOCRATES,
clouds, damping, the giant-planet surface, bucket hydrology, the other
boundary-layer schemes, shallow convection and radiation substepping
(dt_rad > dt).

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
from isca_tpu_torch.physics.diffusivity import DiffusivityConfig, diffusivity
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
    convection_scheme: str = "SIMPLE_BETTS_MILLER"   # | NONE (others not ported)
    turb: bool = True
    do_damping: bool = False
    mixed_layer_bc: bool = True
    gp_surface: bool = False         # giant-planet lower boundary
    bucket: bool = False             # Manabe bucket hydrology
    radiation_scheme: str = "two_stream"   # | "rrtm" (RRTMG-SW + grey LW)
    do_cloud_simple: bool = False
    do_cloud_spookie: bool = False
    do_simple_sat: bool = True          # sat_vapor_pres do_simple (Frierson)
    roughness_mom: float = 0.05
    roughness_heat: float = 0.05
    roughness_moist: float = 0.05
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
    rrtm: "RRTMConfig | None" = None       # used when radiation_scheme="rrtm"
    constants: Constants = EARTH


class MoistPhysicsResult(NamedTuple):
    dt_u: torch.Tensor
    dt_v: torch.Tensor
    dt_t: torch.Tensor
    dt_q: torch.Tensor
    t_surf: torch.Tensor
    diagnostics: dict


def _check_ported(cfg: MoistPhysicsConfig):
    later = {
        "convection_scheme": cfg.convection_scheme not in ("SIMPLE_BETTS_MILLER", "NONE"),
        "radiation_scheme": cfg.radiation_scheme.lower() not in ("two_stream", "rrtm"),
        "do_damping": cfg.do_damping,
        "gp_surface": cfg.gp_surface,
        "bucket": cfg.bucket,
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
    ) -> MoistPhysicsResult:
        cfg, C = self.config, self.C
        if cfg.dt_rad > dt_real:
            raise NotImplementedError(
                "radiation substepping (dt_rad > dt) is not ported to "
                "isca_tpu_torch yet")
        shape2d = t_prev.shape[:-1]
        zero2 = torch.zeros(shape2d, dtype=t_prev.dtype, device=t_prev.device)
        full2 = lambda x: torch.full(shape2d, x, dtype=t_prev.dtype, device=t_prev.device)
        dt_u = torch.zeros_like(u_prev)
        dt_v = torch.zeros_like(v_prev)
        dt_t = torch.zeros_like(t_prev)
        dt_q = torch.zeros_like(q_prev)
        diag = {}

        # ---- convection ----
        if cfg.convection_scheme == "SIMPLE_BETTS_MILLER":
            conv = self.convection(delta_t, t_prev, q_prev, p_full_prev, p_half_prev)
            tg_tmp = t_prev + conv.deltaT
            qg_tmp = q_prev + conv.deltaq
            dt_t = dt_t + conv.deltaT / delta_t
            dt_q = dt_q + conv.deltaq / delta_t
            conv_rain = conv.rain / delta_t
            diag.update(convection_rain=conv_rain, cape=conv.cape, cin=conv.cin)
        else:
            tg_tmp, qg_tmp = t_prev, q_prev
            conv_rain = zero2

        # ---- large-scale condensation ----
        cond = self.condensation(tg_tmp, qg_tmp, p_full_prev, p_half_prev)
        dt_t = dt_t + cond.tdel / delta_t
        dt_q = dt_q + cond.qdel / delta_t
        cond_rain = (cond.rain + cond.snow) / delta_t
        diag.update(condensation_rain=cond_rain)
        diag["precipitation"] = conv_rain + cond_rain

        # ---- radiation: downward pass ----
        albedo = surface_albedo(cfg.mixed_layer, self.lat2d).expand(shape2d).to(t_prev.dtype)
        dt_rad_avg = cfg.radiation.dt_rad_avg if cfg.radiation.dt_rad_avg > 0 else dt_real
        dt_rad_radians = dt_rad_avg / C.seconds_per_day * 2.0 * math.pi
        rad_down = self.radiation.down(
            self.lat2d, self.lon2d, p_half_curr, t_prev, q_prev, albedo,
            gmt=gmt, time_since_ae=time_since_ae, dt_rad_avg=dt_rad_radians)
        rad = self.radiation.up(rad_down, p_half_curr, t_surf, albedo)

        # ---- surface fluxes (lowest level, previous) ----
        z_surf = z_half_curr[..., -1]
        rough_mom = full2(cfg.roughness_mom)
        rough_heat = full2(cfg.roughness_heat)
        rough_moist = full2(cfg.roughness_moist)
        sf = surface_flux(
            cfg.surface, self.svp,
            t_prev[..., -1], q_prev[..., -1], u_prev[..., -1], v_prev[..., -1],
            p_full_curr[..., -1], z_full_curr[..., -1] - z_surf,
            p_half_curr[..., -1], t_surf,
            rough_mom, rough_heat, rough_moist,
            full2(cfg.gust_const),
            dt=delta_t,
        )
        diag.update(flux_t=sf.flux_t, flux_lhe=C.hlv * sf.flux_q, u_star=sf.u_star)

        # ---- radiation heating added to dt_t ----
        dt_t = dt_t + rad.tdt_rad
        diag.update(olr=rad.olr, swdn_sfc=rad_down.net_surf_sw_down,
                    lwdn_sfc=rad_down.surf_lw_down, tdt_rad=rad.tdt_rad,
                    coszen=rad_down.coszen)

        if not cfg.turb:
            return MoistPhysicsResult(dt_u, dt_v, dt_t, dt_q, t_surf, diag)

        # ---- boundary-layer diffusivities ----
        bl = diffusivity(
            cfg.bl, t_prev, q_prev, u_prev, v_prev,
            p_full_curr, p_half_curr, z_full_curr - z_surf[..., None],
            z_half_curr - z_surf[..., None], sf.u_star, sf.b_star)
        diag["z_pbl"] = bl.h_pbl

        # ---- vertical diffusion down / mixed layer / up ----
        down = gcm_vert_diff_down(
            C, delta_t,
            u_prev, v_prev, t_prev, q_prev,
            bl.k_m, bl.k_t,
            p_half_curr, p_full_curr, z_full_curr,
            sf.flux_u, sf.flux_v, sf.dtaudu_atm, sf.dtaudv_atm,
            dt_u, dt_v, dt_t, dt_q,
            do_conserve_energy=cfg.do_conserve_energy_diff,
        )
        dt_u, dt_v = down.dt_u, down.dt_v

        if cfg.mixed_layer_bc:
            heat_capacity = heat_capacity_field(cfg.mixed_layer, self.lon2d, self.lat2d)
            ml = mixed_layer_step(
                cfg.mixed_layer, dt_real, t_surf, down.tri,
                sf.flux_t, sf.flux_q, sf.flux_r,
                rad_down.net_surf_sw_down, rad_down.surf_lw_down,
                sf.dhdt_surf, sf.dedt_surf, sf.dedq_surf, sf.drdt_surf,
                sf.dhdt_atm, sf.dedq_atm,
                ocean_qflux=self.ocean_qflux,
                heat_capacity=heat_capacity,
                lats=self.lat2d,
            )
            tri = down.tri._replace(delta_t=ml.delta_t, delta_q=ml.delta_q)
            t_surf_out = ml.t_surf
            diag["t_surf"] = ml.t_surf
        else:
            # no slab: zero-exchange closure
            tri = down.tri
            t_surf_out = t_surf
        dt_t, dt_q = gcm_vert_diff_up(delta_t, tri)
        return MoistPhysicsResult(dt_u, dt_v, dt_t, dt_q, t_surf_out, diag)
