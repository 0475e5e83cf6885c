"""Implicit vertical diffusion with the two-phase surface coupling split.

Port of isca_tpu/physics/vert_diff.py (reference:
src/atmos_param/vert_diff/vert_diff.F90). The tridiagonal solve for (T, q) is
split around the surface energy balance: `gcm_vert_diff_down` does the
downward elimination and stores partial solutions + sensitivities in a
`TriSurf`; the mixed layer solves the surface balance implicitly using them;
`gcm_vert_diff_up` completes the back-substitution. Momentum is solved fully
inside down() with the surface-stress derivative.

Level-last tensors (..., L), index 0 = top. The recurrences loop over levels.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from isca_tpu_torch.constants import Constants


class TriSurf(NamedTuple):
    dtmass: torch.Tensor     # mu(L-1) * delt = delt*g/dp_bottom
    dflux_t: torch.Tensor    # -nu_n (1 - e_{n-1})
    dflux_q: torch.Tensor
    delta_t: torch.Tensor    # partial bottom-level increments
    delta_q: torch.Tensor
    delta_u: torch.Tensor
    delta_v: torch.Tensor
    e: torch.Tensor          # (.., L-1) stored elimination coefficients
    f_t: torch.Tensor
    f_q: torch.Tensor


class VertDiffDownResult(NamedTuple):
    tri: TriSurf
    dt_u: torch.Tensor
    dt_v: torch.Tensor
    dt_t: torch.Tensor       # includes dissipative heating (tendencies so far)
    dissipative_heat: torch.Tensor


def _compute_mu(C, p_half):
    return C.grav / (p_half[..., 1:] - p_half[..., :-1])


def _compute_nu(C, diff, p_half, z_full, t, q, use_virtual=True):
    """nu at half levels (..., L); nu[...,0] = 0."""
    d608 = C.rvgas / C.rdgas - 1.0
    tt = t * (1.0 + d608 * q) if use_virtual else t
    rho_half = 2.0 * p_half[..., 1:-1] / (C.rdgas * (tt[..., 1:] + tt[..., :-1]))
    nu_in = rho_half * diff[..., 1:] / (z_full[..., :-1] - z_full[..., 1:])
    return torch.cat([torch.zeros_like(nu_in[..., :1]), nu_in], dim=-1)


def _explicit_tend(mu, nu, xi):
    flux = nu[..., 1:] * (xi[..., 1:] - xi[..., :-1])   # interior interfaces (L-1)
    upper = mu[..., :-1] * (flux - torch.cat(
        [torch.zeros_like(flux[..., :1]), flux[..., :-1]], dim=-1))
    bottom = -mu[..., -1:] * flux[..., -1:]
    return torch.cat([upper, bottom], dim=-1)


def _compute_e(delt, mu, nu):
    """Elimination coefficients e (.., L-1) plus (b, c, g) for compute_f."""
    a = torch.cat([-mu[..., :-1] * nu[..., 1:] * delt, torch.zeros_like(mu[..., :1])],
                  dim=-1)
    c = torch.cat([torch.zeros_like(mu[..., :1]), -mu[..., 1:] * nu[..., 1:] * delt],
                  dim=-1)
    b = 1.0 - a - c
    e = [-a[..., 0] / b[..., 0]]
    g = [torch.zeros_like(e[0])]                       # g[0] unused
    for k in range(1, mu.shape[-1] - 1):
        gk = 1.0 / (b[..., k] + c[..., k] * e[-1])
        e.append(-a[..., k] * gk)
        g.append(gk)
    return torch.stack(e, dim=-1), a, b, c, torch.stack(g, dim=-1)


def _compute_f(dt_xi, b, c, g):
    f = [dt_xi[..., 0] / b[..., 0]]
    for k in range(1, b.shape[-1] - 1):
        f.append((dt_xi[..., k] - c[..., k] * f[-1]) * g[..., k])
    return torch.stack(f, dim=-1)


def _diff_surface(mu_delt, nu_n, e_n1, f_delt_n1, dflux_datmos, flux, factor, delta_xi):
    dflux = -nu_n * (1.0 - e_n1)
    delta_xi = delta_xi + mu_delt * nu_n * f_delt_n1
    delta_xi = (delta_xi + mu_delt * flux / factor) / (
        1.0 - mu_delt * (dflux + dflux_datmos / factor))
    flux = flux + dflux_datmos * delta_xi
    return flux, delta_xi


def _vert_diff_up(delt, e, f, delta_xi_n):
    """Back-substitution; returns the full tendency profile (..., L)."""
    out = [delta_xi_n / delt]
    for k in range(e.shape[-1] - 1, -1, -1):
        out.append(e[..., k] * out[-1] + f[..., k])
    return torch.stack(out[::-1], dim=-1)


def gcm_vert_diff_down(
    C: Constants,
    delt,
    u, v, t, q,
    diff_m, diff_t,
    p_half, p_full, z_full,
    tau_u, tau_v, dtau_du, dtau_dv,
    dt_u, dt_v, dt_t, dt_q,
    do_conserve_energy: bool = True,
    use_virtual: bool = True,
) -> VertDiffDownResult:
    """Momentum solve + downward (T, q) sweep (gcm_vert_diff_down)."""
    gcp = C.grav / C.cp_air
    mu = _compute_mu(C, p_half)
    nu_m = _compute_nu(C, diff_m, p_half, z_full, t, q, use_virtual)

    # ---- momentum: full implicit solve with surface-stress derivative ----
    dt_u0, dt_v0 = dt_u, dt_v
    dt_u = dt_u + _explicit_tend(mu, nu_m, u)
    dt_v = dt_v + _explicit_tend(mu, nu_m, v)
    e_m, a, b, c, g = _compute_e(delt, mu, nu_m)
    f_u = _compute_f(dt_u, b, c, g)
    f_v = _compute_f(dt_v, b, c, g)
    mu_delt_n = mu[..., -1] * delt
    nu_n = nu_m[..., -1]
    e_n1 = e_m[..., -1]
    tau_u2, delta_u_n = _diff_surface(
        mu_delt_n, nu_n, e_n1, f_u[..., -1] * delt, dtau_du, tau_u, 1.0,
        dt_u[..., -1] * delt)
    tau_v2, delta_v_n = _diff_surface(
        mu_delt_n, nu_n, e_n1, f_v[..., -1] * delt, dtau_dv, tau_v, 1.0,
        dt_v[..., -1] * delt)
    dt_u = _vert_diff_up(delt, e_m, f_u, delta_u_n)
    dt_v = _vert_diff_up(delt, e_m, f_v, delta_v_n)
    if do_conserve_energy:
        du = dt_u - dt_u0
        dv = dt_v - dt_v0
        diss = -((u + 0.5 * delt * du) * du + (v + 0.5 * delt * dv) * dv) / C.cp_air
        dt_t = dt_t + diss
    else:
        diss = torch.zeros_like(dt_t)

    # ---- heat/moisture downward sweep ----
    nu_t = _compute_nu(C, diff_t, p_half, z_full, t, q, use_virtual)
    tt = t + z_full * gcp
    dt_t = dt_t + _explicit_tend(mu, nu_t, tt)
    dt_q = dt_q + _explicit_tend(mu, nu_t, q)
    e_t, a, b, c, g = _compute_e(delt, mu, nu_t)
    f_t = _compute_f(dt_t, b, c, g)
    f_q = _compute_f(dt_q, b, c, g)
    nu_n = nu_t[..., -1]
    e_n1 = e_t[..., -1]
    tri = TriSurf(
        dtmass=mu_delt_n,
        dflux_t=-nu_n * (1.0 - e_n1),
        dflux_q=-nu_n * (1.0 - e_n1),
        delta_t=dt_t[..., -1] * delt + mu_delt_n * nu_n * f_t[..., -1] * delt,
        delta_q=dt_q[..., -1] * delt + mu_delt_n * nu_n * f_q[..., -1] * delt,
        delta_u=delta_u_n, delta_v=delta_v_n,
        e=e_t, f_t=f_t, f_q=f_q,
    )
    return VertDiffDownResult(tri=tri, dt_u=dt_u, dt_v=dt_v, dt_t=dt_t,
                              dissipative_heat=diss)


def gcm_vert_diff_up(delt, tri: TriSurf):
    """Complete the (T, q) back-substitution after the surface balance.

    tri.delta_t / delta_q must contain the closed increments from mixed_layer.
    Returns (dt_t, dt_q) FULL tendencies (the reference overwrites dt_t/dt_q).
    """
    dt_t = _vert_diff_up(delt, tri.e, tri.f_t, tri.delta_t)
    dt_q = _vert_diff_up(delt, tri.e, tri.f_q, tri.delta_q)
    return dt_t, dt_q
