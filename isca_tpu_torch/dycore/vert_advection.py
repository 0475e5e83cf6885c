"""Vertical advection operators on the hybrid-coordinate mass flux.

Port of isca_tpu/dycore/vert_advection.py (reference:
src/atmos_shared/vert_advection/vert_advection.F90). Operates on level-last
tensors (..., L) with the downward mass flux w at half levels (..., L+1)
(w[0] = w[L] = 0 in the dycore) and layer thickness dp (..., L).

Schemes: SECOND_CENTERED, SECOND_CENTERED_WTS, FOURTH_CENTERED,
FOURTH_CENTERED_WTS, VAN_LEER_LINEAR (flux-limited, for tracers),
FINITE_VOLUME_PARABOLIC (PPM, CFL<1).
Advective or flux form:
    flux_k = w_k * r_interp(k)                       (half levels 1..L-1)
    flux_0 = w_0 r_0 ; flux_L = w_L r_{L-1}
    FLUX_FORM:      dr/dt = -(flux[k+1] - flux[k]) / dp
    ADVECTIVE_FORM: dr/dt = -(flux[k+1] - flux[k] - r (w[k+1]-w[k])) / dp
"""

from __future__ import annotations

import torch

SECOND_CENTERED = "second_centered"
SECOND_CENTERED_WTS = "second_centered_wts"
FOURTH_CENTERED = "fourth_centered"
FOURTH_CENTERED_WTS = "fourth_centered_wts"
VAN_LEER_LINEAR = "van_leer_linear"
FINITE_VOLUME_PARABOLIC = "finite_volume_parabolic"


def _positive_or_one(x):
    return torch.where(x > 0, x, torch.ones_like(x))


def _interior_mask(n_if, like):
    """True on interior interfaces 1..n_if-2, where the 4th-order stencil fits."""
    idx = torch.arange(n_if, device=like.device)
    return (idx >= 1) & (idx <= n_if - 2)


def _interface_value(scheme: str, r, dp, w, delta_t):
    """Interpolated r at interior half levels (..., L-1)."""
    r_dn, r_up = r[..., 1:], r[..., :-1]   # below / above each interior interface
    if scheme == SECOND_CENTERED:
        return 0.5 * (r_dn + r_up)
    if scheme == SECOND_CENTERED_WTS:
        wt = dp[..., :-1] / (dp[..., :-1] + dp[..., 1:])
        return r_up + wt * (r_dn - r_up)
    if scheme == FOURTH_CENTERED:
        # 7/12(r_k + r_{k-1}) - 1/12(r_{k+1} + r_{k-2}), second order at the
        # first/last interior interface (vert_advection.F90:239-273)
        second = 0.5 * (r_dn + r_up)
        r_upup = torch.cat([r[..., :1], r[..., :-2]], dim=-1)
        r_dndn = torch.cat([r[..., 2:], r[..., -1:]], dim=-1)
        fourth = (7.0 / 12.0) * (r_up + r_dn) - (1.0 / 12.0) * (r_upup + r_dndn)
        return torch.where(_interior_mask(r.shape[-1] - 1, r), fourth, second)
    if scheme == FOURTH_CENTERED_WTS:
        # variable-spacing 4th order via interface weights + unlimited
        # nonlinear slopes (vert_advection.F90:196-236, compute_weights,
        # slope_z(limit=.false., linear=.false.))
        slp = _slope_nonlinear(r, dp)
        a = torch.cat([dp[..., :1], dp[..., :-2]], dim=-1)   # dz_{k-2}
        b, c = dp[..., :-1], dp[..., 1:]                     # dz_{k-1}, dz_k
        d = torch.cat([dp[..., 2:], dp[..., -1:]], dim=-1)   # dz_{k+1}
        denom1 = 1.0 / (b + c)
        denom2 = 1.0 / (a + b + c + d)
        denom3 = 1.0 / (2.0 * b + c)
        denom4 = 1.0 / (b + 2.0 * c)
        num3, num4 = a + b, c + d
        x = num3 * denom3 - num4 * denom4
        y = 2.0 * b * c
        zwt1 = b * denom1 + x * y * denom1 * denom2
        zwt2 = b * num3 * denom3 * denom2
        zwt3 = c * num4 * denom4 * denom2
        fourth = r_up + zwt1 * (r_dn - r_up) - zwt2 * slp[..., 1:] + zwt3 * slp[..., :-1]
        wt = b * denom1
        second = r_up + wt * (r_dn - r_up)
        return torch.where(_interior_mask(r.shape[-1] - 1, r), fourth, second)
    if scheme == VAN_LEER_LINEAR:
        # upwind + limited linear slope (van Leer 1977); courant-number corrected
        slope = _vl_slope(r, dp)  # (..., L)
        w_in = w[..., 1:-1]
        # downward flux (w > 0): donor cell is the one above (index k-1 -> r_up)
        cn = delta_t * torch.abs(w_in) / _positive_or_one(dp[..., :-1])
        cn_dn = delta_t * torch.abs(w_in) / _positive_or_one(dp[..., 1:])
        up_val = r_up + 0.5 * slope[..., :-1] * (1.0 - cn)
        dn_val = r_dn - 0.5 * slope[..., 1:] * (1.0 - cn_dn)
        return torch.where(w_in >= 0.0, up_val, dn_val)
    if scheme == FINITE_VOLUME_PARABOLIC:
        rl, rr = _ppm_edges(r, dp)
        w_in = w[..., 1:-1]
        cn_up = delta_t * torch.abs(w_in) / _positive_or_one(dp[..., :-1])
        cn_dn = delta_t * torch.abs(w_in) / _positive_or_one(dp[..., 1:])
        # donor above (w>0): right (lower) edge of cell k-1
        rm_u = rr[..., :-1] - rl[..., :-1]
        r6_u = 6.0 * (r[..., :-1] - 0.5 * (rr[..., :-1] + rl[..., :-1]))
        val_u = rr[..., :-1] - 0.5 * cn_up * (rm_u - (1.0 - (2.0 / 3.0) * cn_up) * r6_u)
        # donor below (w<0): left (upper) edge of cell k
        rm_d = rr[..., 1:] - rl[..., 1:]
        r6_d = 6.0 * (r[..., 1:] - 0.5 * (rr[..., 1:] + rl[..., 1:]))
        val_d = rl[..., 1:] + 0.5 * cn_dn * (rm_d + (1.0 - (2.0 / 3.0) * cn_dn) * r6_d)
        return torch.where(w_in >= 0.0, val_u, val_d)
    raise ValueError(f"unknown vertical advection scheme: {scheme}")


def _slope_nonlinear(r, dp):
    """Unlimited nonlinear slope per cell (slope_z limit=.false. linear=.false.)."""
    grad = torch.diff(r, dim=-1) / (dp[..., 1:] + dp[..., :-1])   # (..., L-1)
    dzm = dp[..., :-2]
    dz0 = dp[..., 1:-1]
    dzp = dp[..., 2:]
    mid = ((grad[..., 1:] * (2.0 * dzm + dz0) + grad[..., :-1] * (2.0 * dzp + dz0))
           * dz0 / (dzm + dz0 + dzp))
    top = 2.0 * grad[..., :1] * dp[..., :1]
    bot = 2.0 * grad[..., -1:] * dp[..., -1:]
    return torch.cat([top, mid, bot], dim=-1)


def _vl_slope(r, dp):
    """Monotonicity-limited slope per cell (van Leer)."""
    d = torch.diff(r, dim=-1)
    d_up = torch.cat([torch.zeros_like(d[..., :1]), d], dim=-1)
    d_dn = torch.cat([d, torch.zeros_like(d[..., :1])], dim=-1)
    avg = 0.5 * (d_up + d_dn)
    smin = 2.0 * torch.minimum(torch.abs(d_up), torch.abs(d_dn))
    same_sign = d_up * d_dn > 0.0
    limited = torch.sign(avg) * torch.minimum(torch.abs(avg), smin)
    return torch.where(same_sign, limited, torch.zeros_like(limited))


def _ppm_edges(r, dp):
    """PPM cell-edge values with monotonicity limiting (Colella & Woodward 1984).

    Returns (r_left, r_right) per cell, 'left' = upper interface (smaller k).
    """
    slope = _vl_slope(r, dp)
    # 4th-order interface estimate on uniform-ish spacing
    ri = 0.5 * (r[..., 1:] + r[..., :-1]) + (slope[..., :-1] - slope[..., 1:]) / 6.0
    rl = torch.cat([r[..., :1], ri], dim=-1)
    rr = torch.cat([ri, r[..., -1:]], dim=-1)
    # limiters
    cond_flat = (rr - r) * (r - rl) <= 0.0
    rl = torch.where(cond_flat, r, rl)
    rr = torch.where(cond_flat, r, rr)
    rm = rr - rl
    r6 = 6.0 * (r - 0.5 * (rr + rl))
    rl = torch.where(rm * r6 > rm * rm, 3.0 * r - 2.0 * rr, rl)
    rr = torch.where(-rm * rm > rm * r6, 3.0 * r - 2.0 * rl, rr)
    return rl, rr


def vert_advection(
    delta_t,
    w,    # (..., L+1) downward mass flux at half levels
    dp,   # (..., L)
    r,    # (..., L)
    scheme: str = SECOND_CENTERED,
    form: str = "advective",
):
    """Vertical advective tendency of r (same discretization as the reference)."""
    r_half = _interface_value(scheme, r, dp, w, delta_t)
    flux_in = w[..., 1:-1] * r_half
    flux = torch.cat([w[..., :1] * r[..., :1], flux_in, w[..., -1:] * r[..., -1:]], dim=-1)
    dflux = flux[..., 1:] - flux[..., :-1]
    if form == "advective":
        dw = w[..., 1:] - w[..., :-1]
        return -(dflux - r * dw) / dp
    return -dflux / dp
