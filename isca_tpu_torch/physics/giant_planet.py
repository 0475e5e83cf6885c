"""Giant-planet surface physics: interior heat flux + Rayleigh bottom drag.

Port of isca_tpu/physics/giant_planet.py (reference:
src/coupler/surface_flux.F90:1076-1089, gp_surface_flux: uniform interior
heating deposited in the bottom layer; and
src/atmos_param/rayleigh_bottom_drag/rayleigh_bottom_drag.F90: Schneider &
Liu 2009 drag near sigma=1, optionally latitude-dependent, with dissipative
heating). Used by the gp_surface (giant planet) configuration together with
the 'schneider' two-stream radiation scheme.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from isca_tpu_torch.constants import Constants, EARTH


@dataclasses.dataclass(frozen=True)
class GiantPlanetConfig:
    flux_heat_gp: float = 5.7           # interior heat flux (W/m^2)
    diabatic_acce: float = 1.0
    kf_days: float = 10.0               # bottom-drag timescale
    sigma_b: float = 0.85               # drag below this sigma (module default,
    #                                     rayleigh_bottom_drag.F90:23)
    variable_drag: bool = False
    rc: float = 0.84                    # cos(lat) cutoff for variable drag
    h_lambda: float = 100.0e3           # e-folding length (m) for variable drag
    do_energy_conserv_ray: bool = True
    constants: Constants = EARTH


def gp_surface_flux(cfg: GiantPlanetConfig, dt_tg, p_half):
    """Add the interior heat flux to the bottom-layer T tendency (level-last);
    out of place."""
    C = cfg.constants
    dp_bot = p_half[..., -1] - p_half[..., -2]
    heat = cfg.diabatic_acce * C.grav * cfg.flux_heat_gp / (C.cp_air * dp_bot)
    return torch.cat([dt_tg[..., :-1], (dt_tg[..., -1] + heat)[..., None]], dim=-1)


class BottomDragResult(NamedTuple):
    dt_u: torch.Tensor
    dt_v: torch.Tensor
    dt_t: torch.Tensor
    dissipative_heat: torch.Tensor


def rayleigh_bottom_drag(
    cfg: GiantPlanetConfig, delta_t, lat, u, v, p_half, p_full,
    dt_u, dt_v, dt_t,
) -> BottomDragResult:
    """Schneider-Liu bottom drag (surface_drag variant); level-last tensors."""
    C = cfg.constants
    kf = 1.0 / (cfg.kf_days * 86400.0)
    if cfg.variable_drag:
        coslat = torch.cos(lat)
        coeff = torch.where(
            coslat <= cfg.rc, kf,
            kf * torch.exp(-(coslat - cfg.rc) * C.radius / cfg.h_lambda),
        )[..., None]
    else:
        coeff = kf

    sigma = p_full / p_half[..., -1:]
    sfac = torch.clamp_min((sigma - cfg.sigma_b) / (1.0 - cfg.sigma_b), 0.0)
    du = -coeff * sfac * u
    dv = -coeff * sfac * v
    if cfg.do_energy_conserv_ray:
        diss = -((u + 0.5 * delta_t * du) * du + (v + 0.5 * delta_t * dv) * dv) / C.cp_air
        dt_t2 = dt_t + diss
    else:
        diss = torch.zeros_like(dt_t)
        dt_t2 = dt_t
    return BottomDragResult(dt_u=dt_u + du, dt_v=dt_v + dv, dt_t=dt_t2,
                            dissipative_heat=diss)
