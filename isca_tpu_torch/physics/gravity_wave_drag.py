"""Gravity-wave drag: orographic (mg_drag) and convective (cg_drag).

Port of isca_tpu/physics/gravity_wave_drag.py (reference:
src/atmos_param/mg_drag/mg_drag.f90:85-943, the Stern/Pierrehumbert
mountain gravity-wave drag, and src/atmos_param/cg_drag/cg_drag.f90:259-871,
the Alexander & Dunkerton (1999) spectral convective gravity-wave drag), and
`const_drag` (damping_driver.f90:283).

mg_drag is closed-form tensor arithmetic over all columns; the monotone taup
profile is a reversed cumulative max (`torch.cummax` on the flipped
profile). cg_drag's upward walk is a Python loop over the L+1 extended
levels carrying the (columns x phase-speeds) propagation mask, with the
deposition sums as masked reductions over the phase-speed axis; the zonal
and meridional walks run as one, stacked on a leading axis of 2. The
reference's two-pass in-place smoothing of the forcing profile telescopes to
wv[k] = 0.5*(raw[k]+raw[k-1]) (with the documented asymmetric top
treatment), applied after the walk.

All arrays are level-last (..., L), index 0 = model top.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from isca_tpu_torch.constants import Constants, EARTH


def _take(a, k):
    """a[..., k[...]]: one level per column (k in range by construction)."""
    return torch.gather(a, -1, k[..., None]).squeeze(-1)


# ---------------------------------------------------------------------------
# mg_drag: orographic gravity-wave drag
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MgDragConfig:
    """mg_drag_nml (mg_drag.f90:74-78)."""
    xl_mtn: float = 1.0e5        # mountain wavelength scale [m]
    gmax: float = 2.0
    acoef: float = 1.0
    rho: float = 1.13            # low-level air density [kg/m^3]
    low_lev_frac: float = 0.23   # fraction of ps defining the low layer
    flux_cut_level: float = 0.0  # Pa; >0 freezes flux above this level
    do_conserve_energy: bool = False
    constants: Constants = EARTH


class MgDragResult(NamedTuple):
    dt_u: torch.Tensor      # (..., L) zonal drag tendency [m/s^2]
    dt_v: torch.Tensor
    dt_t: torch.Tensor      # dissipative heating [K/s]
    taubx: torch.Tensor     # (...) base-flux components
    tauby: torch.Tensor
    tausf: torch.Tensor     # (..., L) saturation flux profile diag


def mg_drag(cfg: MgDragConfig, delta_t, u, v, temp, p_full, p_half,
            z_full, z_half, hprime) -> MgDragResult:
    """Mountain GWD (mg_drag.f90:85-468 non-MCM path).

    hprime: (...,) subgrid-orography standard deviation [m].
    """
    C = cfg.constants
    L = u.shape[-1]
    dev = u.device
    kidx = torch.arange(L, device=dev)
    small = 1e-20
    xli = 1.0 / cfg.xl_mtn
    p00 = 1.0e5

    psurf = p_half[..., -1]
    ptop = (1.0 - cfg.low_lev_frac) * psurf
    # first (highest) level with pfull >= ptop, capped at L-2 (argmax of a
    # mask: the first hit, 0 when there is none)
    ktop = torch.clamp(torch.argmax((p_full >= ptop[..., None]).to(torch.uint8), dim=-1),
                       max=L - 2)

    # --- base flux (mgwd_base_flux, mg_drag.f90:473-597) ---
    in_low = kidx >= ktop[..., None]          # [ktop, L-1]
    delp = p_half[..., 1:] - p_half[..., :-1]
    w = torch.where(in_low, delp, 0.0)
    sumw = torch.sum(w, dim=-1)
    ubar = torch.sum(w * u, dim=-1) / sumw
    vbar = torch.sum(w * v, dim=-1) / sumw
    ulow = torch.sqrt(ubar**2 + vbar**2)
    xn = ubar / (ulow + small)
    yn = vbar / (ulow + small)

    theta = temp * (p_full / p00) ** (-C.kappa)
    th_t, th_b = _take(theta, ktop), theta[..., -1]
    pf_t, pf_b = _take(p_full, ktop), p_full[..., -1]
    t_t, t_b = _take(temp, ktop), temp[..., -1]
    bnv2 = (C.grav**2 * (pf_t + pf_b) * (th_t - th_b)
            / (C.rdgas * (th_t + th_b) * (pf_b - pf_t) * 0.5 * (t_t + t_b)))
    stable = bnv2 > 0.0
    bnv = torch.sqrt(torch.where(stable, bnv2, 1.0))
    fr = bnv * hprime / (ulow + 1e-12)
    g = cfg.gmax * fr**2 / (fr**2 + cfg.acoef**2)
    taub = torch.where(stable, -cfg.rho * xli * ulow**3 / bnv * g, 0.0)
    taubx, tauby = taub * xn, taub * yn

    # --- saturation flux (mgwd_satur_flux, mg_drag.f90:601-872) ---
    # half-level arrays of length L+1
    umag_top = torch.abs(u[..., :1] * xn[..., None] + v[..., :1] * yn[..., None])
    umag_int = torch.abs(0.5 * (u[..., :-1] + u[..., 1:]) * xn[..., None]
                         + 0.5 * (v[..., :-1] + v[..., 1:]) * yn[..., None])
    umag = torch.cat([umag_top, umag_int, torch.zeros_like(umag_top)], dim=-1)
    umag = torch.where(umag < 1e-12, 0.0, umag)

    dudz0 = (umag[..., :1] - umag[..., 1:2]) / (z_full[..., :1] - z_half[..., 1:2])
    dudz_int = (umag[..., 1:L] - umag[..., 2:L + 1]) / (
        z_half[..., 1:L] - z_half[..., 2:L + 1])
    dudz = torch.cat([dudz0, dudz_int], dim=-1)     # length L

    d2_int = (dudz[..., 1:] - dudz[..., :-1]) / (z_full[..., 1:] - z_full[..., :-1])
    d2udz2 = torch.cat(
        [d2_int[..., :1], d2_int,
         (dudz[..., -1:] / (z_full[..., -1:] - z_half[..., -1:]))], dim=-1)

    bn_int = (C.grav**2 * (p_full[..., :-1] + p_full[..., 1:])
              * (theta[..., :-1] - theta[..., 1:])
              / (C.rdgas * (theta[..., :-1] + theta[..., 1:])
                 * (p_full[..., 1:] - p_full[..., :-1])
                 * 0.5 * (temp[..., :-1] + temp[..., 1:])))
    bnvk2 = torch.cat([bn_int[..., :1], bn_int, bn_int[..., -1:]], dim=-1)   # length L+1

    umag_pos = umag > 0.0
    umag_safe = torch.where(umag_pos, umag, 1.0)
    extend = torch.where(umag_pos, d2udz2 / umag_safe, 0.0)
    d2i = torch.where(umag_pos, bnvk2 / umag_safe ** 2 - extend, 1.0e30)
    d = torch.where(d2i < 1e-30, 1.0e30, 1.0 / torch.sqrt(torch.clamp(d2i, min=1e-30)))
    d = torch.where(umag_pos, d, 0.0)

    t_half_mid = 0.5 * (temp[..., :-1] + temp[..., 1:])   # Fortran k=2..kdim
    taus_mid = (-p_half[..., 1:L] * umag[..., 1:L] ** 2 * d[..., 1:L]
                * xli * cfg.gmax / (t_half_mid * C.rdgas))
    kh = torch.arange(L + 1, device=dev)
    taus = torch.where(kh >= ktop[..., None], taub[..., None],
                       torch.cat([taus_mid[..., :1], taus_mid, taub[..., None]], dim=-1))
    taus = torch.cat([taus[..., 1:2], taus[..., 1:]], dim=-1)
    taus = torch.where(bnvk2 < 0.0, taub[..., None], taus)

    if cfg.flux_cut_level > 0.0:
        kcut = torch.argmax((p_half >= cfg.flux_cut_level).to(torch.uint8), dim=-1)
        taus_at_cut = torch.gather(taus, -1, kcut[..., None])
        taus = torch.where(kh < kcut[..., None], taus_at_cut, taus)

    # --- tendency (mgwd_tend, mg_drag.f90:876-943) ---
    # taup[k] = max over j>=k of seq[j], with the bottom entry forced to taub.
    seq = torch.cat([taus[..., :L], taub[..., None]], dim=-1)
    taup = torch.flip(torch.cummax(torch.flip(seq, (-1,)), dim=-1).values, (-1,))
    tausf = taup[..., 1:]
    dterm = C.grav * (taup[..., 1:] - taup[..., :-1]) / delp
    dt_u = xn[..., None] * dterm
    dt_v = yn[..., None] * dterm
    if cfg.do_conserve_energy:
        dt_t = -((u + 0.5 * delta_t * dt_u) * dt_u
                 + (v + 0.5 * delta_t * dt_v) * dt_v) / C.cp_air
    else:
        dt_t = torch.zeros_like(dt_u)
    return MgDragResult(dt_u, dt_v, dt_t, taubx, tauby, tausf)


# ---------------------------------------------------------------------------
# cg_drag: Alexander-Dunkerton convective gravity-wave drag
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CgDragConfig:
    """cg_drag_nml (cg_drag.f90:50-95)."""
    source_level_pressure: float = 315.0e2   # Pa
    nk: int = 1                              # number of wavelengths
    cmax: float = 99.6                       # max phase speed [m/s]
    dc: float = 1.2                          # spectral resolution [m/s]
    Bt_0: float = 0.004                      # total source stress / density
    Bt_nh: float = 0.001
    Bt_sh: float = -0.001
    phi0n: float = 30.0
    phi0s: float = -30.0
    dphin: float = 5.0
    dphis: float = -5.0
    Bw: float = 0.4                          # wide-spectrum amplitude
    Bn: float = 0.0                          # narrow-spectrum amplitude
    cw: float = 40.0                         # wide half-width [m/s]
    cn: float = 2.0                          # narrow half-width [m/s]
    flag: int = 1                            # 1: peak flux at c=0
    bflim: float = 2.5e-5                    # buoyancy-frequency floor [1/s^2]
    calculate_ked: bool = False
    constants: Constants = EARTH


class CgDragResult(NamedTuple):
    gwfcng_x: torch.Tensor   # (..., L) [m/s^2]
    gwfcng_y: torch.Tensor
    ked_x: torch.Tensor
    ked_y: torch.Tensor


class CgDrag:
    """Precomputes the phase-speed spectrum, source levels and amplitudes.

    cg_drag_init (cg_drag.f90:259-534): source level descends toward the
    surface away from the equator; source amplitude has tanh-shaped
    hemispheric augmentations. The tables are computed in numpy at the
    latitudes' dtype, as isca_tpu computes them, and put on their device.
    """

    def __init__(self, cfg: CgDragConfig, lat2d, pref):
        """lat2d: (...,) radians (a tensor); pref: (L,) reference full
        pressures [Pa]."""
        self.cfg = cfg
        kmax = len(pref)
        self.kmax = kmax
        dtype, dev = lat2d.dtype, lat2d.device
        on = lambda x, dt=dtype: torch.as_tensor(np.asarray(x)).to(device=dev, dtype=dt)
        nc = int(2.0 * cfg.cmax / cfg.dc + 1)
        self.c0 = on(np.arange(nc) * cfg.dc - cfg.cmax)
        # wavelengths 300, 3000, ... km (cg_drag.f90:231-236)
        self.kwv = on([2.0 * np.pi / ((30.0 * 10.0 ** (n + 1)) * 1.0e3)
                       for n in range(cfg.nk)])
        lat = lat2d.detach().cpu().numpy()
        # first level (1-based from top) below the source pressure
        klevel = int(np.argmax(np.asarray(pref) > cfg.source_level_pressure)) + 1
        src = (kmax + 1) - ((kmax + 1 - klevel) * np.cos(lat) + 0.5)
        self.source_level = on(np.minimum(src.astype(np.int32), kmax - 1),
                               torch.int64)    # 1-based (ext index)
        latdeg = lat / (np.pi / 180.0)
        self.source_amp = on(
            cfg.Bt_0
            + cfg.Bt_nh * 0.5 * (1.0 + np.tanh((latdeg - cfg.phi0n) / cfg.dphin))
            + cfg.Bt_sh * 0.5 * (1.0 + np.tanh((latdeg - cfg.phi0s) / cfg.dphis)))

    def __call__(self, p_full, z_full, temp, u, v) -> CgDragResult:
        """cg_drag_calc (cg_drag.f90:571-871). Level-last (..., L)."""
        cfg = self.cfg
        C = cfg.constants

        # centered dT/dz (one-sided at top), density, buoyancy frequency
        dtdz_top = (temp[..., :1] - temp[..., 1:2]) / (z_full[..., :1] - z_full[..., 1:2])
        dtdz_mid = (temp[..., :-2] - temp[..., 2:]) / (z_full[..., :-2] - z_full[..., 2:])
        dtdz = torch.cat([dtdz_top, dtdz_mid, dtdz_top * 0], dim=-1)
        rho = p_full / (temp * C.rdgas)
        bf2 = (C.grav / temp) * (dtdz + C.grav / C.cp_air)
        bf = torch.sqrt(torch.clamp(bf2, min=cfg.bflim))

        # extended arrays, index 0 = extrapolated level above model top; the
        # zonal and meridional winds walk together on a leading axis of 2
        ext = lambda a0, rest: torch.cat([a0, rest], dim=-1)
        z_e = ext(2.0 * z_full[..., :1] - z_full[..., 1:2], z_full)
        uv = torch.stack([u, v])
        uv_e = ext(2.0 * uv[..., :1] - uv[..., 1:2], uv)
        rho_e = ext(rho[..., :1] ** 2 / rho[..., 1:2], rho)
        bf_e = ext(bf[..., :1], bf)

        g, k = self._gwfc(rho_e, uv_e, bf_e, z_e)
        return CgDragResult(g[0, ..., 1:], g[1, ..., 1:], k[0, ..., 1:], k[1, ..., 1:])

    def _gwfc(self, rho, u, bf, z):
        """AD99 wave-breaking walk (gwfc, cg_drag.f90:497-650).

        rho, bf, z are extended (..., L+1) arrays (index 0 above the top),
        u is (2, ..., L+1). Returns (forcing, eddy diffusivity), (2, ...,
        L+1) on the same extended levels.
        """
        cfg = self.cfg
        c0 = self.c0
        iz0 = self.source_level                          # (...,) ext index
        Lp1 = u.shape[-1]

        u_src = _take(u, iz0.expand(u.shape[:-1]))       # (2, ...)
        rho_src = _take(rho, iz0)
        c0mu0 = c0 - u_src[..., None]                    # (2, ..., nc)
        c = c0 * cfg.flag + c0mu0 * (1 - cfg.flag)
        amp = (cfg.Bw * torch.exp(-math.log(2.0) * (c / cfg.cw) ** 2)
               + cfg.Bn * torch.exp(-math.log(2.0) * (c / cfg.cn) ** 2))
        B0 = torch.where(c0mu0 == 0.0, 0.0, torch.sign(c0mu0) * amp)
        Bsum = torch.sum(torch.abs(B0), dim=-1)
        eps = (self.source_amp / cfg.nk) / torch.clamp(Bsum, min=1e-30) / rho_src

        dz = z[..., :-1] - z[..., 1:]                    # (..., L)
        Hb = -dz / torch.log(rho[..., :-1] / rho[..., 1:])
        alp2 = 0.25 / Hb**2
        rbh = torch.sqrt(rho[..., :-1] * rho[..., 1:])

        gwf = torch.zeros_like(u)
        ked = torch.zeros_like(u)
        for ink in range(cfg.nk):
            kwv = self.kwv[ink]
            k2 = kwv * kwv
            fac = 0.5 * (rho / rho_src[..., None]) * kwv / bf
            omc = torch.sqrt((bf[..., :-1] ** 2 * k2) / (k2 + alp2))
            # omc, dz and rbh are defined on k=0..L-1 (they need level k+1):
            # at k = L the walk reads their last entry, as isca_tpu's clamped
            # dynamic index does, and masks it (iz0 <= L-1)
            msk = torch.ones(u.shape[:-1] + (c0.shape[0],), dtype=torch.bool, device=u.device)
            raw_f = [None] * Lp1
            raw_k = [None] * Lp1
            for k in range(Lp1 - 1, -1, -1):             # L .. 0 upward walk
                c0mu = c0 - u[..., k, None]
                consider = msk & (k <= iz0)[..., None]
                crit = c0mu == 0.0
                kk = min(k, Lp1 - 2)
                turn = torch.abs(c0mu) * kwv - omc[..., kk, None] >= 0.0
                Foc = B0 / torch.where(crit, 1.0, c0mu) ** 3 - fac[..., k, None]
                brk = (Foc >= 0.0) | (c0mu0 * c0mu <= 0.0)
                if k == 0:
                    stops = torch.ones_like(crit)
                    deposit = consider & ~crit & ~turn
                else:
                    stops = crit | turn | brk
                    deposit = consider & ~crit & ~turn & brk
                deposit = deposit & (k < iz0)[..., None]
                fm = torch.sum(torch.where(deposit, B0, 0.0), dim=-1)
                fe = torch.sum(torch.where(deposit, c0mu * B0, 0.0), dim=-1)
                msk = msk & ~(consider & stops)
                below_src = k < iz0
                raw_f[k] = torch.where(
                    below_src, (rho_src / rbh[..., kk]) * fm * eps / dz[..., kk], 0.0)
                raw_k[k] = torch.where(
                    below_src, (rho_src / rbh[..., kk]) * fe * eps
                    / (dz[..., kk] * bf[..., k] ** 2), 0.0)
            gwf = gwf + self._smooth(torch.stack(raw_f, dim=-1))
            ked = ked + self._smooth(torch.stack(raw_k, dim=-1))
        return gwf, ked

    @staticmethod
    def _smooth(raw):
        """wv[0]=raw[0]; wv[1]=0.5*raw[1]+raw[0]; wv[k]=0.5*(raw[k]+raw[k-1]).
        raw is 0 at and below the source level, where wv[iz0] =
        0.5*raw[iz0-1] is the real deposition smoothing (kept, as in the
        reference)."""
        wv = 0.5 * (raw + torch.roll(raw, 1, dims=-1))
        return torch.cat([raw[..., :1], 0.5 * raw[..., 1:2] + raw[..., :1], wv[..., 2:]],
                         dim=-1)


# ---------------------------------------------------------------------------
# constant drag (damping_driver.f90:283-307, do_const_drag)
# ---------------------------------------------------------------------------

def const_drag(amp, offset, lat2d, p_full, day_of_year, days_per_year):
    """Empirical constant upper-level zonal drag with annual cycle."""
    phase = 2.0 * math.pi * day_of_year / days_per_year
    cosday = torch.cos(phase) if torch.is_tensor(phase) else math.cos(phase)
    phPa = p_full * 0.01
    minp = torch.log(torch.min(phPa)) - 1.0
    utnd = torch.where(phPa < math.e, -amp * ((torch.log(phPa) - 1.0) / minp), 0.0)
    lat = lat2d[..., None]
    shape = (-1.65 * torch.abs(lat) ** 3 + 2.5 * lat**2 + 0.17 * torch.abs(lat)
             + offset)
    return torch.where(phPa < math.e,
                       utnd * torch.sign(lat) * cosday * shape, 0.0)
