"""Mellor-Yamada level-2.5 turbulence closure (prognostic TKE).

Port of isca_tpu/physics/my25_turb.py (reference:
src/atmos_param/my25_turb/my25_turb.F90): `MY25_TURB` (diffusion
coefficients akm/akh from the level-2.5 closure with master length scale
el0, and the implicit TKE prognostic update) and `TKE_SURF` (surface TKE
from u*). Everything is batched over columns; the reference's per-column
tridiagonal (FMS tri_invert, convention c*x(k-1) + b*x(k) + a*x(k+1) = d)
is a Thomas solve whose two sweeps are Python loops over the small
interior-half-level axis.

TKE lives on half levels (..., L+1), index 0 = top (el0 slot), index L =
surface; it is model STATE threaded through the step by the caller (the
reference keeps it in a module-global restart array).

Closure constants are the "new" set (use_old_cons=.false. default,
my25_turb.F90:41-52 and the derived ckm/ckh in MY25_TURB_INIT).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class MY25Config:
    """my25_turb_nml (my25_turb.F90:56-68)."""
    tkemax: float = 5.0
    tkemin: float = 0.0
    el0max: float = 1.0e6
    el0min: float = 0.0
    alpha_land: float = 0.10
    alpha_sea: float = 0.10
    akmax: float = 1.0e4
    akmin_land: float = 5.0
    akmin_sea: float = 0.0
    nk_lim: int = 2
    init_iters: int = 20
    do_thv_stab: bool = True
    use_old_cons: bool = False
    vonkarm: float = 0.4
    grav: float = 9.80


def _constants(cfg: MY25Config):
    if cfg.use_old_cons:
        aa1, aa2, bb1, bb2, ccc = 0.78, 0.79, 15.0, 8.0, 0.056
    else:
        aa1, aa2, bb1, bb2, ccc = 0.92, 0.74, 16.0, 10.0, 0.08
    cc1 = 0.27
    ckm1 = (1.0 - 3.0 * ccc) * aa1
    ckm3 = 3.0 * aa1 * aa2 * (bb2 - 3.0 * aa2)
    ckm4 = 9.0 * aa1 * aa2 * ccc * (bb2 + 4.0 * aa1)
    ckm5 = 6.0 * aa1 * aa1
    ckm6 = 18.0 * aa1 * aa1 * aa2 * (bb2 - 3.0 * aa2)
    ckm7 = 3.0 * aa2 * (bb2 + 7.0 * aa1)
    ckm8 = 27.0 * aa1 * aa2 * aa2 * (bb2 + 4.0 * aa1)
    ckm2 = ckm3 - ckm4
    ckh1 = aa2
    ckh2 = 6.0 * aa1 * aa2
    ckh3 = 3.0 * aa2 * (bb2 + 4.0 * aa1)
    ckh4 = 2.0e-6 * aa2
    cvfq1 = 5.0 * cc1 / 3.0
    cvfq2 = 1.0 / bb1
    bcq = 0.5 * bb1 ** (2.0 / 3.0)
    return dict(ckm1=ckm1, ckm2=ckm2, ckm5=ckm5, ckm6=ckm6, ckm7=ckm7,
                ckm8=ckm8, ckh1=ckh1, ckh2=ckh2, ckh3=ckh3, ckh4=ckh4,
                cvfq1=cvfq1, cvfq2=cvfq2, bcq=bcq)


def tke_surf(cfg: MY25Config, tke, u_star):
    """Surface TKE boundary condition (TKE_SURF, my25_turb.F90)."""
    bcq = _constants(cfg)["bcq"]
    return torch.cat([tke[..., :-1], (bcq * u_star * u_star)[..., None]], dim=-1)


def _thomas(c, b, a, d):
    """Solve c*x(k-1) + b*x(k) + a*x(k+1) = d along the last axis (FMS
    tri_invert convention, tridiagonal.F90:7-45); a's last entry is taken as
    0."""
    n = d.shape[-1]
    e = [-a[..., 0] / b[..., 0]]
    f = [d[..., 0] / b[..., 0]]
    for k in range(1, n):
        g = 1.0 / (b[..., k] + c[..., k] * e[-1])
        e.append(-(a[..., k] if k < n - 1 else torch.zeros_like(g)) * g)
        f.append((d[..., k] - c[..., k] * f[-1]) * g)
    x = [f[-1]]
    for k in range(n - 2, -1, -1):
        x.append(e[k] * x[-1] + f[k])
    return torch.stack(x[::-1], dim=-1)


class MY25Result(NamedTuple):
    akm: torch.Tensor     # (..., L) momentum diffusivity on half levels 1..L
    akh: torch.Tensor     # (..., L) heat diffusivity
    el0: torch.Tensor     # (...,) master length scale
    el: torch.Tensor      # (..., L+1) length-scale profile
    tke: torch.Tensor     # (..., L+1) updated TKE


def my25_turb(cfg: MY25Config, delt, fracland, p_half, p_full, theta,
              um, vm, z_half, z_full, z0, tke, u_star=None,
              iters: int = 1) -> MY25Result:
    """One MY2.5 update (or `iters` of them, the last one's outputs).
    Level-last tensors, index 0 = top.

    tke: (..., L+1) half-level TKE state (surface slot set from u_star if
    given). Returns diffusivities on half levels (akm[..., 0] = 0 at the
    model top, akm[..., k] at half level k for k=1..L-1; index L-1 is the
    lowest interior half level, the layout the K-profile scheme feeds
    gcm_vert_diff).
    """
    con = _constants(cfg)
    L = um.shape[-1]
    if u_star is not None:
        tke = tke_surf(cfg, tke, u_star)

    zsfc = z_half[..., -1]
    # zero-thickness guard: with a p_top=0 coordinate the top half-level
    # height is clamped, so treat a degenerate interface as impermeable
    dzh = z_half[..., 1:] - z_half[..., :-1]
    dzf = z_full[..., 1:] - z_full[..., :-1]
    dsdz = torch.where(dzh != 0.0, 1.0 / torch.where(dzh != 0.0, dzh, 1.0), 0.0)
    dsdzh = torch.where(dzf != 0.0, 1.0 / torch.where(dzf != 0.0, dzf, 1.0), 0.0)

    du = dsdzh * (um[..., 1:] - um[..., :-1])
    dv = dsdzh * (vm[..., 1:] - vm[..., :-1])
    shear = du * du + dv * dv
    dth = theta[..., 1:] - theta[..., :-1]
    tbar = (0.5 * (theta[..., 1:] + theta[..., :-1])
            if cfg.do_thv_stab else 272.48)
    buoync = cfg.grav * dsdzh * dth / tbar

    akmin = cfg.akmin_land * fracland + cfg.akmin_sea * (1.0 - fracland)
    low = torch.arange(L - 1, device=um.device) >= (L - 1 - cfg.nk_lim)
    karg = torch.cat([cfg.vonkarm * (z_half[..., 1:L] - zsfc[..., None]),
                      cfg.vonkarm * z0[..., None]], dim=-1)             # (..., L)
    xx1_dp = torch.cat([p_full[..., 1:] - p_full[..., :-1],
                        p_half[..., -1:] - p_full[..., -1:]], dim=-1)
    xx2_z = torch.cat([z_half[..., 1:L] - zsfc[..., None], z0[..., None]], dim=-1)
    cvfqdt = con["cvfq1"] * delt
    dvfqdt = con["cvfq2"] * delt * 2.0

    def one_iter(tke):
        qm = torch.sqrt(torch.clamp(2.0 * tke[..., 1:], min=0.0))    # (..., L)
        qm2 = 2.0 * tke[..., 1:L]                                   # interior
        qm_i = qm[..., :L - 1]
        qm3 = qm_i * qm2
        qm4 = qm2 * qm2

        # master length scale el0 (integral of q dp weighted by height)
        xx1 = qm * xx1_dp
        xx2 = xx1 * xx2_z
        el0 = torch.sum(xx2, dim=-1) / torch.clamp(torch.sum(xx1, dim=-1), min=1e-30)
        el0 = el0 * (cfg.alpha_land * fracland + cfg.alpha_sea * (1.0 - fracland))
        el0 = torch.clamp(el0, cfg.el0min, cfg.el0max)

        # blended length-scale profile el on half levels
        el_lower = karg / (1.0 + karg / el0[..., None])
        el = torch.cat([el0[..., None], el_lower], dim=-1)          # (..., L+1)

        el_i = el[..., 1:L]
        el2 = el_i * el_i
        gh = el2 * buoync
        gm = el2 * shear
        eq3 = el_i * qm3

        num_m = eq3 * (con["ckm1"] * qm2 + con["ckm2"] * gh)
        den_m = qm4 + con["ckm5"] * qm2 * gm + gh * (
            con["ckm6"] * gm + con["ckm7"] * qm2 + con["ckm8"] * gh)
        den_m = torch.clamp(torch.maximum(den_m, 0.2 * qm4), min=1e-10)
        akm_i = torch.clamp(num_m / den_m, min=0.0)

        num_h = torch.maximum(con["ckh1"] * eq3 - con["ckh2"] * gm * akm_i,
                              con["ckh4"] * eq3)
        den_h = torch.clamp(torch.maximum(qm2 + con["ckh3"] * gh, 0.4 * qm2), min=1e-10)
        akh_i = num_h / den_h

        akm_i = torch.clamp(akm_i, max=cfg.akmax)
        akh_i = torch.clamp(akh_i, max=cfg.akmax)
        akm_i = torch.where(low, torch.maximum(akm_i, akmin[..., None]), akm_i)
        akh_i = torch.where(low, torch.maximum(akh_i, akmin[..., None]), akh_i)

        # --- implicit TKE update (vertical diffusion of q^2) ---
        damp = dvfqdt * qm_i / el_i
        kq_full = el[..., 1:] * qm                                  # (..., L)
        kq_mid = torch.cat([
            0.5 * kq_full[..., :1],
            0.5 * (kq_full[..., 1:] + kq_full[..., :-1])], dim=-1) * dsdz
        a = -cvfqdt * kq_mid[..., 1:] * dsdzh                      # x(k+1) coeff
        cl = -cvfqdt * kq_mid[..., :-1] * dsdzh                    # x(k-1) coeff
        b = 1.0 - a - cl + damp
        d = tke[..., 1:L]
        d = torch.cat([d[..., :-1], d[..., -1:] - a[..., -1:] * tke[..., -1:]],
                      dim=-1)                                       # surface BC
        x = _thomas(cl, b, a, d)

        prod = delt * (akm_i * shear - akh_i * buoync)
        new_int = x + prod
        tke_new = torch.cat(
            [torch.zeros_like(tke[..., :1]), new_int, tke[..., -1:]], dim=-1)
        tke_new = torch.clamp(tke_new, cfg.tkemin, cfg.tkemax)
        zero = torch.zeros_like(akm_i[..., :1])
        akm = torch.cat([zero, akm_i], dim=-1)
        akh = torch.cat([zero, akh_i], dim=-1)
        return tke_new, (akm, akh, el0, el)

    for _ in range(iters):
        tke, (akm, akh, el0, el) = one_iter(tke)
    return MY25Result(akm=akm, akh=akh, el0=el0, el=el, tke=tke)
