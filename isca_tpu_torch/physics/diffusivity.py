"""K-profile boundary-layer diffusivity (Troen-Mahrt style, Frierson simple option).

Port of isca_tpu/physics/diffusivity.py (reference:
src/atmos_param/diffusivity/diffusivity.F90:263-524). PBL depth from the
first level where the bulk Richardson number (stable / do_simple) exceeds
rich_crit_pbl, or where a buoyant-parcel virtual static energy is exceeded
(unstable), linearly interpolated; K(z) = vonkarm u* z / phi(z/L) in the inner
layer (z < frac_inner*h) and the cubic profile k_ref*(z/h_i)(1-(z-h_i)/(h-h_i))^2
above, zero above h.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from isca_tpu_torch.constants import Constants, EARTH
from isca_tpu_torch.physics.monin_obukhov import MOConfig, _phi_m, _phi_t


@dataclasses.dataclass(frozen=True)
class DiffusivityConfig:
    fixed_depth: bool = False
    depth_0: float = 5000.0
    frac_inner: float = 0.1
    rich_crit_pbl: float = 1.0
    znom: float = 1000.0
    do_simple: bool = False
    parcel_buoy: float = 8.5
    free_atm_diff: bool = False
    background_m: float = 0.0
    background_t: float = 0.0
    mo: MOConfig = MOConfig()
    constants: Constants = EARTH


def _mo_diff(cfg: MOConfig, z, u_star, b_star):
    """(k_m, k_t) = vonkarm u* z / phi_{m,t}(z/L)."""
    mo_inv = torch.where(u_star > 0, -cfg.vonkarm * b_star / (u_star**2), 0.0)
    zeta = z * mo_inv
    k_m = cfg.vonkarm * u_star * z / _phi_m(cfg, zeta)
    k_t = cfg.vonkarm * u_star * z / _phi_t(cfg, zeta)
    return k_m, k_t


class DiffusivityResult(NamedTuple):
    k_m: torch.Tensor     # (..., L) at half levels below layer k (index k = interface k)
    k_t: torch.Tensor
    h_pbl: torch.Tensor


def _crossing_height(above, z, x, x_crit):
    """Height where x crosses x_crit at the first level (from the bottom,
    above the lowest) flagged in `above`, linearly interpolated; the top
    full level where no level is flagged."""
    L = above.shape[-1]
    rev = torch.flip(above, (-1,))[..., 1:]        # index 0 = second-lowest level
    found = torch.any(rev, dim=-1)
    k_hit = L - 2 - torch.argmax(rev.to(torch.uint8), dim=-1)
    k_below = torch.clamp(k_hit + 1, max=L - 1)
    take = lambda a, k: torch.gather(a, -1, k[..., None])[..., 0]
    z2, x2 = take(z, k_hit), take(x, k_hit)
    z1, x1 = take(z, k_below), take(x, k_below)
    h = z2 + (z1 - z2) * (x2 - x_crit) / torch.where(x2 != x1, x2 - x1, 1.0)
    return torch.where(found, h, z[..., 0])


def diffusivity(
    cfg: DiffusivityConfig,
    t, q, u, v, p_full, p_half, z_full, z_half,
    u_star, b_star,
) -> DiffusivityResult:
    """Level-last (..., L); z_half (..., L+1). Returns K at half levels 0..L-1
    (K[...,k] sits at interface k, matching vert_diff's nu indexing)."""
    C = cfg.constants
    gcp = C.grav / C.cp_air
    d608 = C.rvgas / C.rdgas - 1.0
    small = 1.0e-4

    z_surf = z_half[..., -1:]
    z_full_ag = z_full - z_surf
    z_half_ag = z_half - z_surf
    if cfg.do_simple:
        svcp = t + gcp * z_full_ag
    else:
        svcp = t * (1.0 + d608 * q) + gcp * z_full_ag

    tbot = svcp[..., -1:]
    rich = z_full_ag * C.grav * (svcp - tbot) / tbot / (u * u + v * v + small)

    if cfg.fixed_depth:
        h = torch.full(t.shape[:-1], cfg.depth_0, dtype=t.dtype, device=t.device)
    else:
        # stable / do_simple branch: first level above with rich > crit
        rc = cfg.rich_crit_pbl
        h_stable = _crossing_height(rich > rc, z_full_ag, rich, rc)

        # unstable branch: parcel virtual static energy exceedance
        h_inner_nom = cfg.frac_inner * cfg.znom
        ws_m, _ = _mo_diff(cfg.mo, torch.full_like(u_star, h_inner_nom), u_star, b_star)
        ws = torch.clamp(ws_m / cfg.mo.vonkarm / h_inner_nom, min=small)
        svp = tbot[..., 0] * (1.0 + cfg.parcel_buoy * u_star * b_star / (C.grav * ws))
        h_unstable = _crossing_height(svcp > svp[..., None], z_full_ag, svcp, svp)

        use_stable = (b_star <= 0.0) | cfg.do_simple
        h = torch.where(use_stable, h_stable, h_unstable)

    h_inner = cfg.frac_inner * h
    zm = z_half_ag[..., :-1]   # interfaces 0..L-1 (interface L = surface, K unused)
    k_m_ref, k_t_ref = _mo_diff(cfg.mo, h_inner, u_star, b_star)
    k_m_in, k_t_in = _mo_diff(cfg.mo, zm, u_star[..., None], b_star[..., None])

    hx = h[..., None]
    hi = h_inner[..., None]
    factor = (zm / hi) * (1.0 - (zm - hi) / torch.where(hx > hi, hx - hi, 1.0)) ** 2
    outer = (zm >= hi) & (zm < hx)
    k_m = torch.where(outer, k_m_ref[..., None] * factor, k_m_in)
    k_t = torch.where(outer, k_t_ref[..., None] * factor, k_t_in)
    k_m = torch.where(zm >= hx, 0.0, k_m)
    k_t = torch.where(zm >= hx, 0.0, k_t)
    k_m = torch.clamp(k_m, min=0.0) + cfg.background_m
    k_t = torch.clamp(k_t, min=0.0) + cfg.background_t
    return DiffusivityResult(k_m=k_m, k_t=k_t, h_pbl=h)
