"""Bulk aerodynamic surface fluxes with implicit-coupling derivatives.

Port of isca_tpu/physics/surface_flux.py (reference:
src/coupler/surface_flux.F90:338-697, surface_flux_1d). Momentum, sensible,
latent and longwave fluxes from bulk formulae with Monin-Obukhov drag
coefficients, plus the derivatives the implicit surface chain needs
(dhdt_surf, dedt_surf, dedq_atm, drdt_surf, dtaudu/v_atm), which thread
through gcm_vert_diff -> mixed_layer -> back-substitution.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from isca_tpu_torch.constants import Constants, EARTH
from isca_tpu_torch.physics.monin_obukhov import MOConfig, mo_drag


@dataclasses.dataclass(frozen=True)
class SurfaceFluxConfig:
    no_neg_q: bool = False
    use_virtual_temp: bool = True
    alt_gustiness: bool = False
    use_mixing_ratio: bool = False
    do_simple: bool = False
    gust_const: float = 1.0
    gust_min: float = 0.0
    raoult_sat_vap: bool = False
    land_humidity_prefactor: float = 1.0
    land_evap_prefactor: float = 1.0
    mo: MOConfig = MOConfig()
    constants: Constants = EARTH


class SurfaceFluxes(NamedTuple):
    flux_t: torch.Tensor       # sensible heat (W/m^2), positive upward
    flux_q: torch.Tensor       # evaporation (kg/m^2/s)
    flux_r: torch.Tensor       # upward surface longwave (W/m^2)
    flux_u: torch.Tensor       # zonal stress
    flux_v: torch.Tensor
    dhdt_surf: torch.Tensor
    dedt_surf: torch.Tensor
    dedq_surf: torch.Tensor
    drdt_surf: torch.Tensor
    dhdt_atm: torch.Tensor
    dedq_atm: torch.Tensor
    dtaudu_atm: torch.Tensor
    dtaudv_atm: torch.Tensor
    w_atm: torch.Tensor
    u_star: torch.Tensor
    b_star: torch.Tensor
    q_star: torch.Tensor
    q_surf: torch.Tensor
    cd_m: torch.Tensor
    cd_t: torch.Tensor
    cd_q: torch.Tensor
    rho: torch.Tensor


def surface_flux(
    cfg: SurfaceFluxConfig,
    svp,
    t_atm, q_atm_in, u_atm, v_atm, p_atm, z_atm,
    p_surf, t_surf,
    rough_mom, rough_heat, rough_moist,
    gust,
    land=None,
    bucket_depth=None,
    max_bucket_depth_land: float = 0.15,
    dt: float = 0.0,
) -> SurfaceFluxes:
    """All inputs are 2-D surface fields (lowest model level / surface).

    With `bucket_depth` (m of water, land points), evaporation follows the
    Manabe bucket model: scaled by depth/(0.75 max_depth) below 75% capacity,
    zero from an empty bucket, and capped at the available water over dt."""
    C = cfg.constants
    kappa = C.rdgas / C.cp_air
    d622 = C.rdgas / C.rvgas
    d378 = 1.0 - d622
    d608 = C.rvgas / C.rdgas - 1.0
    del_temp = 0.1

    e_sat = svp.es(t_surf)
    e_sat1 = svp.es(t_surf + del_temp)
    if cfg.use_mixing_ratio:
        q_sat = d622 * e_sat / (p_surf - e_sat)
        q_sat1 = d622 * e_sat1 / (p_surf - e_sat1)
    elif cfg.do_simple:
        q_sat = d622 * e_sat / p_surf
        q_sat1 = d622 * e_sat1 / p_surf
    else:
        q_sat = d622 * e_sat / (p_surf - d378 * e_sat)
        q_sat1 = d622 * e_sat1 / (p_surf - d378 * e_sat1)
    q_surf0 = q_sat

    q_atm = torch.clamp(q_atm_in, min=0.0) if cfg.no_neg_q else q_atm_in

    p_ratio = (p_surf / p_atm) ** kappa
    tv_atm = t_atm * (1.0 + d608 * q_atm)
    th_atm = t_atm * p_ratio
    thv_atm = tv_atm * p_ratio
    thv_surf = t_surf * (1.0 + d608 * q_surf0)

    u_dif = -u_atm
    v_dif = -v_atm
    if cfg.alt_gustiness:
        w_atm = torch.clamp(torch.sqrt(u_dif**2 + v_dif**2), min=cfg.gust_const)
        strong = w_atm > cfg.gust_const
        dw_atmdu = torch.where(strong, u_dif / w_atm, 0.0)
        dw_atmdv = torch.where(strong, v_dif / w_atm, 0.0)
    else:
        w_gust = torch.clamp(gust, min=cfg.gust_min) if cfg.gust_min > 0 else gust
        w_atm = torch.sqrt(u_dif**2 + v_dif**2 + w_gust**2)
        dw_atmdu = u_dif / w_atm
        dw_atmdv = v_dif / w_atm

    cd_m, cd_t, cd_q, u_star, b_star = mo_drag(
        cfg.mo, thv_atm, thv_surf, z_atm, rough_mom, rough_heat, rough_moist, w_atm)

    drag_t = cd_t * w_atm
    drag_q = cd_q * w_atm
    drag_m = cd_m * w_atm
    rho = p_atm / (C.rdgas * tv_atm)

    rho_drag_t = C.cp_air * drag_t * rho
    flux_t = rho_drag_t * (t_surf - th_atm)
    dhdt_surf = rho_drag_t
    dhdt_atm = -rho_drag_t * p_ratio

    rho_drag_q = drag_q * rho
    if bucket_depth is not None:
        land_b = land if land is not None else torch.zeros_like(t_surf, dtype=torch.bool)
        q_surf_b = torch.where(bucket_depth <= 0.0, q_atm, q_surf0)
        cap = max_bucket_depth_land * 0.75
        scale = torch.where(land_b & (bucket_depth < cap), bucket_depth / cap, 1.0)
        flux_q = scale * rho_drag_q * (q_surf_b - q_atm)
        # cap evaporation at the available bucket water over dt
        avail = bucket_depth * C.dens_h2o / max(dt, 1e-30)
        over = (flux_q > 0.0) & (flux_q * dt / C.dens_h2o > bucket_depth)
        flux_q = torch.where(over, avail, flux_q)
        dedt_surf = torch.where(
            bucket_depth <= 0.0, 0.0,
            scale * rho_drag_q * (q_sat1 - q_sat) / del_temp)
        dedq_atm = torch.where(bucket_depth <= 0.0, 0.0, -rho_drag_q)
        dedq_surf = torch.zeros_like(flux_q)
    elif land is None:
        flux_q = rho_drag_q * (q_surf0 - q_atm)
        dedt_surf = rho_drag_q * (q_sat1 - q_sat) / del_temp
        dedq_surf = torch.zeros_like(flux_q)
        dedq_atm = -rho_drag_q
    else:
        le, lh = cfg.land_evap_prefactor, cfg.land_humidity_prefactor
        flux_q = torch.where(
            land,
            rho_drag_q * le * (lh * q_surf0 - q_atm),
            rho_drag_q * (q_surf0 - q_atm))
        dedt_surf = torch.where(
            land,
            rho_drag_q * le * (lh * q_sat1 - q_sat) / del_temp,
            rho_drag_q * (q_sat1 - q_sat) / del_temp)
        dedq_surf = torch.zeros_like(flux_q)
        dedq_atm = -rho_drag_q

    q_star = flux_q / (u_star * rho)
    q_surf_out = q_atm + flux_q / (rho * cd_q * w_atm)
    flux_r = C.stefan * t_surf**4
    drdt_surf = 4.0 * C.stefan * t_surf**3

    rho_drag_m = drag_m * rho
    flux_u = rho_drag_m * u_dif
    flux_v = rho_drag_m * v_dif
    # stress derivatives (reference :641-650): diagonal approximation
    dtaudu_atm = -cd_m * rho * (dw_atmdu * u_dif + w_atm)
    dtaudv_atm = -cd_m * rho * (dw_atmdv * v_dif + w_atm)

    return SurfaceFluxes(
        flux_t=flux_t, flux_q=flux_q, flux_r=flux_r, flux_u=flux_u, flux_v=flux_v,
        dhdt_surf=dhdt_surf, dedt_surf=dedt_surf, dedq_surf=dedq_surf,
        drdt_surf=drdt_surf, dhdt_atm=dhdt_atm, dedq_atm=dedq_atm,
        dtaudu_atm=dtaudu_atm, dtaudv_atm=dtaudv_atm,
        w_atm=w_atm, u_star=u_star, b_star=b_star, q_star=q_star,
        q_surf=q_surf_out, cd_m=cd_m, cd_t=cd_t, cd_q=cd_q, rho=rho,
    )
