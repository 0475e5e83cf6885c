"""Semi-implicit gravity-wave treatment for the primitive-equation core.

Port of isca_tpu/dycore/implicit.py (reference:
src/atmos_spectral/model/implicit.F90). The column operators are linearized
about an isothermal reference state (T_ref, ps_ref):

  nu      (L,)   : -d(ps)/dt from unit divergence  -> nu_k = dp_ref_k
  DT      (L,L)  : dT/dt from divergence (energy-conversion + vertical advection
                   of the reference T profile), dt_T = DT @ div
  GG      (L,L)  : geopotential from temperature (linearized hydrostatic),
                   geopot = GG @ del_T
  h       (L,)   : R T_ref d(ln p) pressure-gradient coefficients + geopotential
                   response to a ln(ps) perturbation
  G = h (x) nu - GG @ DT      : the gravity-wave operator ("div_mat")
  M_n = (I + xi^2 n(n+1)/a^2 G)^(-1), xi = alpha * delta_t    ("wave_matrix")

The matrices are built in float64 numpy at init for each distinct delta_t
(dt and 2*dt) and cast to the run dtype. The per-mode dense solves
(implicit.F90:241-286 loops) are one batched real matrix product over total
wavenumber n, on the split real/imaginary parts of the spectral fields, at
exact FP32 or FP64 (the solve feeds back into the divergence every step).
The correction runs inside a profiler range named "implicit" (as isca_tpu's
named scope), so a torch.profiler trace gives its device time.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.profiler import record_function

from isca_tpu_torch.dycore import press_geopot as pg
from isca_tpu_torch.dycore.time_integration import TwoLevel


def _pressure_variables_np(pk, bk, ps, top_is_zero, option):
    """press_geopot.pressure_variables on one float64 column, as numpy."""
    f = lambda a: torch.as_tensor(np.asarray(a, np.float64))
    return tuple(a.numpy() for a in pg.pressure_variables(
        f(pk), f(bk), f(ps), top_is_zero, option=option))


def _linear_tp_tendency_matrices(pk, bk, t_ref, ps_ref, kappa, top_is_zero,
                                 option="simmons_and_burridge"):
    """Matrices (nu, DT) of the linearized continuity/thermodynamic response.

    dt_ps = -nu . div ;  dt_T = DT @ div   (implicit.F90 linear_tp_tendency,
    :434-457 for the simmons_and_burridge / mcm energy-conversion branches).
    """
    L = len(t_ref)
    dpk = np.diff(pk)
    dbk = np.diff(bk)
    dp = dpk + dbk * ps_ref
    _, ln_p_half, p_full_ref, ln_p_full = _pressure_variables_np(
        pk, bk, ps_ref, top_is_zero, option)
    dlog_1 = ln_p_half[1:] - ln_p_full          # (L,)
    dlog_3 = ln_p_half[1:] - ln_p_half[:-1]

    DT = np.zeros((L, L))
    # energy-conversion part, column kk = response to unit div at level kk
    for kk in range(L):
        div = np.zeros(L)
        div[kk] = 1.0
        dmean = div * dp
        dmean_tot_before = np.concatenate([[0.0], np.cumsum(dmean)[:-1]])
        if option == "mcm":
            DT[:, kk] = -(kappa * t_ref / p_full_ref) * (
                dmean_tot_before + 0.5 * dmean)
        else:
            DT[:, kk] = -kappa * t_ref * (dmean_tot_before * dlog_3 + dmean * dlog_1) / dp
        # hybrid vertical mass flux at half levels (L+1,)
        dmean_tot = np.cumsum(dmean)
        wv = np.zeros(L + 1)
        wv[1:] = -dmean_tot
        wv[1:L] += dmean_tot[-1] * bk[1:L]
        wv[0] = 0.0
        wv[L] = 0.0
        # vertical advection of the reference T profile (centered)
        temp = np.zeros(L + 1)
        temp[1:L] = -wv[1:L] * (t_ref[1:] - t_ref[:-1])
        DT[:, kk] += 0.5 * (temp[1:] + temp[:-1]) / dp
    nu = dp.copy()  # dt_ps(div) = -sum_k dp_k div_k = -nu . div
    return nu, DT


def _linear_geopotential_matrix(pk, bk, t_ref, ps_ref, rdgas, top_is_zero,
                                option="simmons_and_burridge"):
    """GG with geopot = GG @ del_T, plus the h2 ln(ps)-response vector."""
    L = len(t_ref)
    _, ln_p_half, _, ln_p_full = _pressure_variables_np(pk, bk, ps_ref, top_is_zero, option)
    dlnp_half = ln_p_half[1:] - ln_p_half[:-1]   # (L,)
    GG = np.zeros((L, L))
    for kk in range(L):
        dT = np.zeros(L)
        dT[kk] = 1.0
        # geopot_half(k) = sum_{j >= k} rdgas dT_j dlnp_half_j   (j from k..L-1)
        incr = rdgas * dT * dlnp_half
        if top_is_zero:
            incr[0] = 0.0
        gh = np.concatenate([np.cumsum(incr[::-1])[::-1], [0.0]])
        GG[:, kk] = gh[1:] + rdgas * dT * (ln_p_half[1:] - ln_p_full)

    # h2: geopotential response to ln(ps) perturbation via del_ln_p arrays
    del_ln_p_half = np.zeros(L + 1)
    del_ln_p_half[1:] = bk[1:] / (pk[1:] + bk[1:] * ps_ref)
    if top_is_zero:
        del_ln_p_half[0] = 1.0 / ps_ref
    else:
        del_ln_p_half[0] = bk[0] / (pk[0] + bk[0] * ps_ref)
    eps = 1.0e-5
    _, _, _, lnpf1 = _pressure_variables_np(pk, bk, ps_ref * (1 - 0.5 * eps),
                                            top_is_zero, option)
    _, _, _, lnpf2 = _pressure_variables_np(pk, bk, ps_ref * (1 + 0.5 * eps),
                                            top_is_zero, option)
    del_ln_p_full = (lnpf2 - lnpf1) / (eps * ps_ref)

    incr = rdgas * t_ref * (del_ln_p_half[1:] - del_ln_p_half[:-1])
    if top_is_zero:
        incr[0] = 0.0
    gh = np.concatenate([np.cumsum(incr[::-1])[::-1], [0.0]])
    h2 = gh[1:] + rdgas * t_ref * (del_ln_p_half[1:] - del_ln_p_full)
    return GG, h2


@dataclasses.dataclass(frozen=True)
class Implicit:
    nu: torch.Tensor             # (L,)
    DT: torch.Tensor             # (L, L)
    GG: torch.Tensor             # (L, L)
    h: torch.Tensor              # (L,)
    lam_n: torch.Tensor          # (N2,) n(n+1)/a^2 (positive)
    wave_matrices: torch.Tensor  # (num_dts, N2, L, L) inverse matrices per n
    ps_ref: float
    alpha: float
    dts: tuple                   # distinct delta_t values matching wave_matrices axis 0


def build_implicit(
    pk: np.ndarray,
    bk: np.ndarray,
    num_spherical: int,     # N+1: total wavenumber rows (matrices for n=0..N+1)
    radius: float,
    delta_ts: tuple,        # distinct delta_t values to precompute (dt, 2 dt, ...)
    t_ref: float | np.ndarray = 300.0,
    ps_ref: float = 101325.0,
    alpha: float = 0.5,
    rdgas: float = 287.04,
    cp_air: float = 1004.64,
    dtype=torch.float32,
    vert_difference_option: str = "simmons_and_burridge",
    device=None,
) -> Implicit:
    """device: where the matrices live (a torch device; None is the CPU)."""
    L = len(pk) - 1
    t_ref = np.full(L, t_ref, dtype=np.float64) if np.isscalar(t_ref) else np.asarray(t_ref, np.float64)
    pk = np.asarray(pk, np.float64)
    bk = np.asarray(bk, np.float64)
    top_is_zero = pk[0] == 0.0 and bk[0] == 0.0
    kappa = rdgas / cp_air
    opt = vert_difference_option

    nu, DT = _linear_tp_tendency_matrices(pk, bk, t_ref, ps_ref, kappa,
                                          top_is_zero, option=opt)
    GG, h2 = _linear_geopotential_matrix(pk, bk, t_ref, ps_ref, rdgas,
                                         top_is_zero, option=opt)

    _, ln_p_half, _, ln_p_full = _pressure_variables_np(pk, bk, ps_ref, top_is_zero, opt)
    if opt == "mcm":
        # pres_grad_funct mcm branch (implicit.F90:404-408)
        h1 = rdgas * t_ref / ps_ref
    else:
        dlog_1 = ln_p_half[1:] - ln_p_full
        dlog_2 = ln_p_full - ln_p_half[:-1]
        dp = np.diff(pk) + np.diff(bk) * ps_ref
        h1 = rdgas * t_ref * (bk[1:] * dlog_1 + bk[:-1] * dlog_2) / dp
    h = h1 + h2

    # gravity-wave operator: G(k,kk) = h_k nu_kk + sum_j GG(k,j) tau(j,kk), tau = -DT
    G = np.outer(h, nu) - GG @ DT

    nvals = np.arange(num_spherical + 1, dtype=np.float64)
    lam = nvals * (nvals + 1.0) / (radius * radius)
    wms = np.zeros((len(delta_ts), num_spherical + 1, L, L))
    eye = np.eye(L)
    for i, dt in enumerate(delta_ts):
        xi = alpha * dt
        for n in range(num_spherical + 1):
            wms[i, n] = np.linalg.inv(eye + (xi * xi * lam[n]) * G)

    f = lambda x: torch.as_tensor(x).to(device=device, dtype=dtype)
    return Implicit(
        nu=f(nu), DT=f(DT), GG=f(GG), h=f(h), lam_n=f(lam),
        wave_matrices=f(wms), ps_ref=float(ps_ref), alpha=float(alpha),
        dts=tuple(float(d) for d in delta_ts),
    )


def _levels_matmul(A, x):
    """A (K, L) applied along the level axis of complex x (L, m, n): one real
    matrix product over the split (re, im) parts."""
    xr = torch.view_as_real(x.contiguous())
    out = torch.matmul(A, xr.reshape(xr.shape[0], -1))
    return torch.view_as_complex(out.reshape((A.shape[0],) + xr.shape[1:]))


def _levels_dot(v, x):
    """sum_l v[l] x[l] over the level axis of complex x (L, m, n)."""
    xr = torch.view_as_real(x.contiguous())
    out = torch.matmul(v, xr.reshape(xr.shape[0], -1))
    return torch.view_as_complex(out.reshape(xr.shape[1:]))


def implicit_correction(
    imp: Implicit,
    dt_divs: torch.Tensor,   # (L, m, n) complex
    dt_ts: torch.Tensor,     # (L, m, n)
    dt_lnps: torch.Tensor,   # (m, n)
    divs: TwoLevel,
    ts: TwoLevel,
    lnps: TwoLevel,
    delta_t: float,
):
    """Apply the semi-implicit correction to the spectral tendencies.

    delta_t must be one of imp.dts: its wave matrices are picked by value.
    """
    i_dt = imp.dts.index(float(delta_t))
    with record_function("implicit"):
        WM = imp.wave_matrices[i_dt]          # (N2, L, L)
        xi = imp.alpha * delta_t

        # replace linear terms evaluated at `current` by `previous` (adjust_dt_divs)
        div_diff = divs.prev - divs.curr
        dt_ts = dt_ts + _levels_matmul(imp.DT, div_diff)
        dt_lnps = dt_lnps - _levels_dot(imp.nu, div_diff) / imp.ps_ref

        ts_temp = ts.prev - ts.curr + xi * dt_ts
        ps_temp = lnps.prev - lnps.curr + xi * dt_lnps
        geopot = _levels_matmul(imp.GG, ts_temp)
        dt_divs = dt_divs + imp.lam_n * (
            geopot + imp.h[:, None, None] * ps_temp[None, :, :] * imp.ps_ref)

        # batched dense solve per total wavenumber n: (n, L, L) @ (n, L, m x re/im)
        xr = torch.view_as_real(dt_divs.contiguous())            # (L, m, n, 2)
        solved = torch.einsum("nkl,lmnr->kmnr", WM, xr)
        dt_divs = torch.view_as_complex(solved.contiguous())

        # back-substitution
        dt_ts = dt_ts + xi * _levels_matmul(imp.DT, dt_divs)
        dt_lnps = dt_lnps - xi * _levels_dot(imp.nu, dt_divs) / imp.ps_ref
        return dt_divs, dt_ts, dt_lnps
