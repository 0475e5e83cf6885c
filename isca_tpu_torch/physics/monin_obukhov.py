"""Monin-Obukhov surface-layer similarity: drag coefficients and profiles.

Port of isca_tpu/physics/monin_obukhov.py (reference:
src/atmos_param/monin_obukhov/monin_obukhov_kernel.F90). Businger-Dyer
unstable functions; two stable options (1: smooth blend, default; 2:
piecewise linear/log). The reference's masked Newton iteration on zeta is a
fixed-count vectorized Newton (converged points stop moving).
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class MOConfig:
    rich_crit: float = 2.0
    drag_min: float = 1.0e-5
    neutral: bool = False
    stable_option: int = 1
    zeta_trans: float = 0.5
    vonkarm: float = 0.40
    grav: float = 9.80
    small: float = 1.0e-4
    zeta_min: float = 1.0e-6
    max_iter: int = 20


def _stable_phi(cfg, zeta):
    b = 1.0 / cfg.rich_crit
    if cfg.stable_option == 1:
        return 1.0 + zeta * (5.0 + b * zeta) / (1.0 + zeta)
    lam = 1.0 + (5.0 - b) * cfg.zeta_trans
    return torch.where(zeta < cfg.zeta_trans, 1.0 + 5.0 * zeta, lam + b * zeta)


def _phi_m(cfg, zeta):
    unstable = (1.0 - 16.0 * torch.clamp(zeta, max=0.0)) ** (-0.25)
    return torch.where(zeta < 0, unstable, _stable_phi(cfg, zeta))


def _phi_t(cfg, zeta):
    unstable = (1.0 - 16.0 * torch.clamp(zeta, max=0.0)) ** (-0.5)
    return torch.where(zeta < 0, unstable, _stable_phi(cfg, zeta))


def _stable_psi(cfg, zeta, zeta_0, ln_z_z0):
    b = 1.0 / cfg.rich_crit
    if cfg.stable_option == 1:
        return (ln_z_z0
                + (5.0 - b) * torch.log((1.0 + zeta) / (1.0 + zeta_0))
                + b * (zeta - zeta_0))
    lam = 1.0 + (5.0 - b) * cfg.zeta_trans
    xst = (lam - 1.0) * torch.log(torch.clamp(zeta, min=1e-30) / cfg.zeta_trans) + b * (
        zeta - cfg.zeta_trans)
    weak = ln_z_z0 + 5.0 * (zeta - zeta_0)
    strong = torch.where(
        zeta_0 <= cfg.zeta_trans,
        ln_z_z0 + xst + 5.0 * (cfg.zeta_trans - zeta_0),
        lam * ln_z_z0 + b * (zeta - zeta_0))
    return torch.where(zeta <= cfg.zeta_trans, weak, strong)


def _psi_m_integral(cfg, zeta, zeta_0, ln_z_z0):
    zu = torch.clamp(zeta, max=0.0)
    zu0 = torch.clamp(zeta_0, max=0.0)
    x = (1.0 - 16.0 * zu) ** 0.25
    x0 = (1.0 - 16.0 * zu0) ** 0.25
    num = (1 + x) ** 2 * (1 + x * x)
    den = (1 + x0) ** 2 * (1 + x0 * x0)
    unstable = ln_z_z0 - torch.log(num / den) + 2.0 * (torch.atan(x) - torch.atan(x0))
    return torch.where(zeta < 0, unstable, _stable_psi(cfg, zeta, zeta_0, ln_z_z0))


def _psi_t_integral(cfg, zeta, zeta_t, ln_z_zt):
    zu = torch.clamp(zeta, max=0.0)
    zut = torch.clamp(zeta_t, max=0.0)
    x = torch.sqrt(1.0 - 16.0 * zu)
    xt = torch.sqrt(1.0 - 16.0 * zut)
    unstable = ln_z_zt - 2.0 * torch.log((1.0 + x) / (1.0 + xt))
    return torch.where(zeta < 0, unstable, _stable_psi(cfg, zeta, zeta_t, ln_z_zt))


def mo_drag(cfg: MOConfig, pt, pt0, z, z0, zt, zq, speed):
    """Drag coefficients (cd_m, cd_t, cd_q) and scales (u_star, b_star).

    pt: atmospheric virtual potential T; pt0: surface virtual potential T.
    """
    delta_b = cfg.grav * (pt0 - pt) / pt0
    rich = -z * delta_b / (speed * speed + cfg.small)
    zz = torch.maximum(torch.maximum(z, z0), torch.maximum(zt, zq))
    ln_z_z0 = torch.log(zz / z0)
    ln_z_zt = torch.log(zz / zt)
    ln_z_zq = torch.log(zz / zq)

    if cfg.neutral:
        fm, ft, fq = ln_z_z0, ln_z_zt, ln_z_zq
    else:
        r_crit = 0.95 * cfg.rich_crit
        rich_c = torch.clamp(rich, max=r_crit * 0.999)
        zeta0 = rich_c * ln_z_z0 * ln_z_z0 / ln_z_zt
        zeta = torch.where(rich_c >= 0.0, zeta0 / (1.0 - rich_c / cfg.rich_crit), zeta0)
        for _ in range(cfg.max_iter):
            zeta = torch.where(torch.abs(zeta) < cfg.zeta_min, 0.0, zeta)
            safe = torch.where(zeta == 0.0, 1.0, zeta)
            z_0 = safe / (zz / z0)
            z_t = safe / (zz / zt)
            phim = _phi_m(cfg, safe)
            phim0 = _phi_m(cfg, z_0)
            phit = _phi_t(cfg, safe)
            phit0 = _phi_t(cfg, z_t)
            f_m = _psi_m_integral(cfg, safe, z_0, ln_z_z0)
            f_t = _psi_t_integral(cfg, safe, z_t, ln_z_zt)
            rz = 1.0 / safe
            df_m = (phim - phim0) * rz
            df_t = (phit - phit0) * rz
            rich_1 = safe * f_t / (f_m * f_m)
            d_rich = rich_1 * (rz + df_t / f_t - 2.0 * df_m / f_m)
            corr = (rich_c - rich_1) / torch.where(d_rich != 0, d_rich, 1.0)
            bound = 10 * torch.abs(safe) + 1
            zeta = torch.where(zeta == 0.0, 0.0,
                               zeta + torch.clamp(corr, -bound, bound))
        safe = torch.where(zeta == 0.0, 1.0, zeta)
        neutral = torch.abs(zeta) < cfg.zeta_min
        fm = torch.where(neutral, ln_z_z0,
                         _psi_m_integral(cfg, safe, safe / (zz / z0), ln_z_z0))
        ft = torch.where(neutral, ln_z_zt,
                         _psi_t_integral(cfg, safe, safe / (zz / zt), ln_z_zt))
        fq = torch.where(neutral, ln_z_zq,
                         _psi_t_integral(cfg, safe, safe / (zz / zq), ln_z_zq))

    sq_min = math.sqrt(cfg.drag_min)
    us = torch.clamp(cfg.vonkarm / fm, min=sq_min)
    bs = torch.clamp(cfg.vonkarm / ft, min=sq_min)
    qs = torch.clamp(cfg.vonkarm / fq, min=sq_min)
    if not cfg.neutral:
        supercrit = rich >= 0.95 * cfg.rich_crit
        us = torch.where(supercrit, sq_min, us)
        bs = torch.where(supercrit, sq_min, bs)
        qs = torch.where(supercrit, sq_min, qs)
    cd_m = us * us
    cd_t = us * bs
    cd_q = us * qs
    return cd_m, cd_t, cd_q, us * speed, bs * delta_b


def mo_profile(cfg: MOConfig, zref_m, zref_t, z, z0, zt, zq, u_star, b_star):
    """Interpolation factors (del_m, del_t, del_q) for 10m/2m diagnostics."""
    ln_z_z0 = torch.log(z / z0)
    ln_z_zt = torch.log(z / zt)
    ln_z_zq = torch.log(z / zq)
    ln_z_zrm = torch.log(z / zref_m)
    ln_z_zrt = torch.log(z / zref_t)
    if cfg.neutral:
        return (
            1.0 - ln_z_zrm / ln_z_z0,
            1.0 - ln_z_zrt / ln_z_zt,
            1.0 - ln_z_zrt / ln_z_zq,
        )
    mo_inv = torch.where(u_star > 0, -cfg.vonkarm * b_star / (u_star * u_star), 0.0)
    zeta = z * mo_inv
    f_m = _psi_m_integral(cfg, zeta, z0 * mo_inv, ln_z_z0)
    f_m_ref = _psi_m_integral(cfg, zeta, zref_m * mo_inv, ln_z_zrm)
    f_t = _psi_t_integral(cfg, zeta, zt * mo_inv, ln_z_zt)
    f_t_ref = _psi_t_integral(cfg, zeta, zref_t * mo_inv, ln_z_zrt)
    f_q = _psi_t_integral(cfg, zeta, zq * mo_inv, ln_z_zq)
    f_q_ref = _psi_t_integral(cfg, zeta, zref_t * mo_inv, ln_z_zrt)
    return (
        1.0 - f_m_ref / f_m,
        1.0 - f_t_ref / f_t,
        1.0 - f_q_ref / f_q,
    )
