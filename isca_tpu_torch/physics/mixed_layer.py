"""Slab-ocean mixed layer with implicit surface energy balance.

Port of the parts of isca_tpu/physics/mixed_layer.py that the moist physics
driver calls (reference: src/atmos_spectral/driver/solo/mixed_layer.F90,
:568-747 step, + atmos_param/qflux/qflux.f90 analytic Q-flux). Closes the
implicit surface chain between the vertical-diffusion down and up sweeps:

  gamma_t = 1/(1 - dtmass (dflux_t + dhdt_atm/cp))
  gamma_q = 1/(1 - dtmass (dflux_q + dedq_atm))
  fn = gamma (delta + dtmass flux);  en = gamma dtmass dflux/dT_surf
  corrected_flux = -SW_net - LW_down + cp alpha_t + alpha_lw [+ L alpha_q] - Qflux
  C_eff = C + dt dF/dT_surf ; dT_surf = -corrected_flux dt / C_eff
  delta_t = fn_t + en_t dT_surf ; delta_q = fn_q + en_q dT_surf

SST modes: interactive energy balance (default), prescribed APE analytic
profile 27(1 - sin^2(3 lat/2)), or externally provided SSTs.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from isca_tpu_torch.constants import Constants, EARTH
from isca_tpu_torch.physics.vert_diff import TriSurf

RHO_CP_WATER = 3989.24495292815   # J/kg/K, times dens_h2o per metre of depth


@dataclasses.dataclass(frozen=True)
class MixedLayerConfig:
    depth: float = 40.0
    albedo_value: float = 0.06
    evaporation: bool = True
    qflux_amp: float = 0.0
    qflux_width: float = 16.0
    do_qflux: bool = False
    do_ape_sst: bool = False
    do_sc_sst: bool = False
    tconst: float = 305.0
    land_h_capacity_prefactor: float = 1.0
    land_albedo_prefactor: float = 1.0
    # initial SST distribution (mixed_layer.F90:90-91, 347):
    # t_surf = tconst - delta_T*(3 sin^2(lat) - 1)/3
    prescribe_initial_dist: bool = False
    delta_T: float = 40.0
    # MiMA heat-capacity profile options (mixed_layer.F90:95-106, 510-556):
    # negative land_depth/trop_depth mean "use `depth`"
    land_depth: float = -1.0
    trop_depth: float = -1.0
    trop_cap_limit: float = 15.0     # degrees: tropical capacity inside here
    heat_cap_limit: float = 60.0     # ramp to extratropical capacity by here
    np_cap_factor: float = 1.0       # northern-hemisphere capacity factor
    # land mask source for capacity/albedo: 'none' | 'input' | 'zsurf' | 'lonlat'
    land_option: str = "none"
    slandlon: tuple = ()
    slandlat: tuple = ()
    elandlon: tuple = ()
    elandlat: tuple = ()
    # MiMA albedo profiles (mixed_layer.F90:112, 442-481):
    # 1 constant/land-prefactor, 2 one-hemisphere step at lat_glacier,
    # 3 symmetric step, 4 (lat/90)^albedo_exp ramp, 5 tanh around albedo_cntr
    albedo_choice: int = 1
    higher_albedo: float = 0.10
    albedo_exp: float = 2.0
    albedo_cntr: float = 45.0
    albedo_wdth: float = 10.0
    lat_glacier: float = 60.0
    # ice albedo from a sea-ice concentration field (mixed_layer.F90:130-134)
    update_albedo_from_ice: bool = False
    ice_albedo_value: float = 0.7
    ice_concentration_threshold: float = 0.5
    ice_albedo_method: str = "step_function"   # or 'ramp_function'
    do_warmpool: bool = False
    warmpool_amp: float = 5.0
    warmpool_width: float = 20.0
    warmpool_k: int = 1
    specify_sst_over_ocean_only: bool = False
    constants: Constants = EARTH


class MixedLayerResult(NamedTuple):
    t_surf: torch.Tensor
    delta_t: torch.Tensor    # closed bottom-level increments for gcm_vert_diff_up
    delta_q: torch.Tensor
    delta_t_surf: torch.Tensor


def analytic_qflux(cfg: MixedLayerConfig, lats):
    """Merlis analytic ocean heat transport divergence (qflux.f90:48-62)."""
    lat_deg = torch.rad2deg(lats)
    w = cfg.qflux_width
    return -cfg.qflux_amp * (1.0 - 2.0 * lat_deg**2 / w**2) * torch.exp(
        -(lat_deg**2) / w**2) / torch.cos(lats)


def warmpool_qflux(cfg: MixedLayerConfig, lons, lats):
    """Analytic warm-pool heating (qflux.f90:73-93): a (1 - (lat/w)^2)
    meridional envelope times cos(k*lon), added to the ocean q-flux."""
    lat_scaled = torch.rad2deg(lats) / cfg.warmpool_width
    pool = (1.0 - lat_scaled**2) * cfg.warmpool_amp * torch.cos(cfg.warmpool_k * lons)
    return torch.where(torch.abs(lat_scaled) <= 1.0, pool, 0.0)


def initial_t_surf(cfg: MixedLayerConfig, lats):
    """Prescribed initial SST distribution (mixed_layer.F90:347):
    tconst - delta_T*(3 sin^2(lat) - 1)/3."""
    return cfg.tconst - cfg.delta_T * (3.0 * torch.sin(lats) ** 2 - 1.0) / 3.0


def ape_sst(lats):
    """Aquaplanet Experiment analytic SST: 273.15 + 27(1-sin^2(3 lat/2)), |lat|<60."""
    sst = 273.15 + 27.0 * (1.0 - torch.sin(1.5 * lats) ** 2)
    return torch.where(torch.abs(lats) < math.pi / 3.0, sst, 273.15)


def _lonlat_land(cfg: MixedLayerConfig, lon_deg, lat_deg):
    """land_option='lonlat': union of [slandlon,elandlon]x[slandlat,elandlat]
    rectangles (degrees) (mixed_layer.F90:539-551)."""
    mask = torch.zeros_like(lon_deg, dtype=torch.bool)
    for lo0, la0, lo1, la1 in zip(cfg.slandlon, cfg.slandlat,
                                  cfg.elandlon, cfg.elandlat):
        mask = mask | ((lon_deg >= lo0) & (lon_deg <= lo1)
                       & (lat_deg >= la0) & (lat_deg <= la1))
    return mask


def surface_albedo(cfg: MixedLayerConfig, lats, land_mask=None):
    """Static surface albedo field (mixed_layer.F90:433-481).

    albedo_choice selects the MiMA meridional profiles; with
    land_option='input' the land points get land_albedo_prefactor applied
    first (choices 2-5 then overwrite the whole field, as in the reference).
    """
    lat_deg = torch.rad2deg(lats)
    a0, a1 = cfg.albedo_value, cfg.higher_albedo
    albedo = torch.full_like(lat_deg, a0)
    if cfg.land_option == "input" and land_mask is not None:
        albedo = torch.where(land_mask > 0.5, cfg.land_albedo_prefactor * albedo, albedo)
    full = lambda a: torch.full_like(lat_deg, a)
    if cfg.albedo_choice == 2:
        if cfg.lat_glacier >= 0.0:
            albedo = torch.where(lat_deg > cfg.lat_glacier, full(a1), a0)
        else:
            albedo = torch.where(lat_deg < cfg.lat_glacier, full(a1), a0)
    elif cfg.albedo_choice == 3:
        albedo = torch.where(torch.abs(lat_deg) > cfg.lat_glacier, full(a1), a0)
    elif cfg.albedo_choice == 4:
        albedo = a0 + (a1 - a0) * (torch.abs(lat_deg) / 90.0) ** cfg.albedo_exp
    elif cfg.albedo_choice == 5:
        albedo = a0 + (a1 - a0) * 0.5 * (
            1.0 + torch.tanh((torch.abs(lat_deg) - cfg.albedo_cntr) / cfg.albedo_wdth))
    return albedo


def albedo_with_ice(cfg: MixedLayerConfig, albedo_initial, ice_concentration):
    """Ice-modified albedo (mixed_layer.F90 albedo_calc): step_function sets
    ice_albedo_value where concentration > threshold; ramp_function blends."""
    if cfg.ice_albedo_method == "ramp_function":
        return (albedo_initial * (1.0 - ice_concentration)
                + cfg.ice_albedo_value * ice_concentration)
    if cfg.ice_albedo_method != "step_function":
        raise ValueError(f"invalid ice_albedo_method {cfg.ice_albedo_method!r}")
    return torch.where(ice_concentration > cfg.ice_concentration_threshold,
                       torch.full_like(albedo_initial, cfg.ice_albedo_value), albedo_initial)


def heat_capacity_field(cfg: MixedLayerConfig, lons, lats, land_mask=None, zsurf=None):
    """Mixed-layer heat capacity (J/m^2/K) (mixed_layer.F90:508-556).

    Base = depth*RHO_CP. Without land_option='input': optional tropical /
    extratropical profile (trop_depth inside trop_cap_limit, linear ramp to
    heat_cap_limit, np_cap_factor scaling the NH extratropics), then land
    overrides from zsurf (>10 m) or lonlat rectangles at land_depth. With
    'input', land points just get land_h_capacity_prefactor.
    """
    C = cfg.constants
    rho_cp = C.dens_h2o * RHO_CP_WATER
    lat_deg = torch.rad2deg(lats)
    lon_deg = torch.rad2deg(lons)
    base = cfg.depth * rho_cp
    trop_cap = (cfg.trop_depth if cfg.trop_depth > 0 else cfg.depth) * rho_cp
    land_cap = (cfg.land_depth if cfg.land_depth > 0 else cfg.depth) * rho_cp
    hc = torch.full_like(lat_deg, base)
    if cfg.land_option == "input":
        if land_mask is not None:
            hc = torch.where(land_mask > 0.5, cfg.land_h_capacity_prefactor * hc, hc)
        return hc
    if trop_cap != base or cfg.np_cap_factor != 1.0:
        loc_cap = torch.where(lat_deg > 0.0, torch.full_like(lat_deg, base * cfg.np_cap_factor),
                              base)
        ramp = ((torch.abs(lat_deg) - cfg.trop_cap_limit)
                / (cfg.heat_cap_limit - cfg.trop_cap_limit))
        ramp = torch.clamp(ramp, 0.0, 1.0)
        hc = trop_cap * (1.0 - ramp) + ramp * loc_cap
    if cfg.land_option == "zsurf" and zsurf is not None:
        hc = torch.where(zsurf > 10.0, land_cap, hc)
    elif cfg.land_option == "lonlat":
        hc = torch.where(_lonlat_land(cfg, lon_deg, lat_deg), land_cap, hc)
    return hc


def mixed_layer_step(
    cfg: MixedLayerConfig,
    dt,
    t_surf,
    tri: TriSurf,
    flux_t, flux_q, flux_r,
    net_surf_sw_down, surf_lw_down,
    dhdt_surf, dedt_surf, dedq_surf, drdt_surf, dhdt_atm, dedq_atm,
    ocean_qflux=0.0,
    heat_capacity=None,
    land_mask=None,
    sst_prescribed=None,
    lats=None,
) -> MixedLayerResult:
    C = cfg.constants
    inv_cp = 1.0 / C.cp_air
    if heat_capacity is None:
        heat_capacity = C.dens_h2o * RHO_CP_WATER * cfg.depth
        if land_mask is not None:
            heat_capacity = torch.where(
                land_mask, cfg.land_h_capacity_prefactor * heat_capacity,
                heat_capacity)

    gamma_t = 1.0 / (1.0 - tri.dtmass * (tri.dflux_t + dhdt_atm * inv_cp))
    gamma_q = 1.0 / (1.0 - tri.dtmass * (tri.dflux_q + dedq_atm))
    fn_t = gamma_t * (tri.delta_t + tri.dtmass * flux_t * inv_cp)
    fn_q = gamma_q * (tri.delta_q + tri.dtmass * flux_q)
    en_t = gamma_t * tri.dtmass * dhdt_surf * inv_cp
    en_q = gamma_q * tri.dtmass * dedt_surf

    alpha_t = flux_t * inv_cp + dhdt_atm * inv_cp * fn_t
    alpha_q = flux_q + dedq_atm * fn_q
    alpha_lw = flux_r
    beta_t = dhdt_surf * inv_cp + dhdt_atm * inv_cp * en_t
    beta_q = dedt_surf + dedq_atm * en_q
    beta_lw = drdt_surf

    corrected_flux = (
        -net_surf_sw_down - surf_lw_down + alpha_t * C.cp_air + alpha_lw - ocean_qflux)
    t_surf_dependence = beta_t * C.cp_air + beta_lw
    if cfg.evaporation:
        corrected_flux = corrected_flux + alpha_q * C.hlv
        t_surf_dependence = t_surf_dependence + beta_q * C.hlv

    if cfg.do_ape_sst or cfg.do_sc_sst:
        sst_new = ape_sst(lats) if cfg.do_ape_sst else sst_prescribed
        if (cfg.do_sc_sst and cfg.specify_sst_over_ocean_only
                and land_mask is not None):
            # SSTs pin the ocean; land still solves the implicit energy balance
            eff_heat_capacity = heat_capacity + t_surf_dependence * dt
            delta_t_surf = torch.where(
                land_mask > 0.5, -corrected_flux * dt / eff_heat_capacity,
                sst_new - t_surf)
            t_surf = t_surf + delta_t_surf
        else:
            delta_t_surf = sst_new - t_surf
            t_surf = sst_new
    else:
        eff_heat_capacity = heat_capacity + t_surf_dependence * dt
        delta_t_surf = -corrected_flux * dt / eff_heat_capacity
        t_surf = t_surf + delta_t_surf

    delta_t = fn_t + en_t * delta_t_surf
    delta_q = fn_q + en_q * delta_t_surf if cfg.evaporation else tri.delta_q
    return MixedLayerResult(
        t_surf=t_surf, delta_t=delta_t, delta_q=delta_q, delta_t_surf=delta_t_surf)
