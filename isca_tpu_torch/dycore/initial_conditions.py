"""Published baroclinic-wave initial states, and an initial state from a file.

Port of isca_tpu/dycore/initial_conditions.py: the numpy constructors of the
published states are copied as they are; the `apply_*` functions band-limit
them through the port's transforms into a PrimitiveState on the core's
device. On a mesh they build the state on the whole globe (the balanced
states integrate over latitude) and return this rank's blocks of it.

Jablonowski & Williamson (2006, QJRMS 132: "A baroclinic instability test case
for atmospheric model dynamical cores") — a balanced zonal jet in sigma
coordinates plus a localized zonal-wind perturbation that triggers a growing
baroclinic wave with a documented evolution (reference implementation:
src/atmos_spectral/init/jablonowski_2006.F90).

Formulas (eta ~ sigma here):
  nv      = (sigma - n0) pi/2,  n0 = 0.252
  u(phi, k)   = U0 cos^{3/2}(nv) sin^2(2 phi) + perturbation
  Tbar(k)     = T0 sigma^{R lapse/g} (+ deltaT (nt - sigma)^5 above nt = 0.2)
  T(phi, k)   = Tbar + (3/4)(pi U0 sigma/R) sin(nv) cos^{1/2}(nv) *
                [ (10/63 - 2 sin^6(cos^2+1/3)) 2 U0 cos^{3/2}(nv)
                  + a Omega (1.6 cos^3 (sin^2+2/3) - pi/4) ]
  Phi_s(phi)  = U0 cos^{3/2}(nv_s) [ ... same bracket at sigma=1 ... ]
  ps = p0; perturbation u' = Up exp(-(10 r)^2), r = great-circle distance from
  (lonc, latc) in radians.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from isca_tpu_torch.dycore.time_integration import TwoLevel
from isca_tpu_torch.parallel.mesh import shard_pytree
from isca_tpu_torch.spectral import transforms as tr


@dataclasses.dataclass(frozen=True)
class Jablonowski2006Config:
    n0: float = 0.252
    U0: float = 35.0
    nt: float = 0.20
    lapse: float = 0.005
    T0: float = 288.0
    Up: float = 1.0
    lonc: float = 20.0
    latc: float = 40.0
    deltaT: float = 4.8e5


def jablonowski_2006_state(cfg: Jablonowski2006Config, lats, lons, sigma,
                           radius, omega, rdgas, grav, ps0=1.0e5):
    """Grid initial fields (u, t, surf_geopotential) as numpy, level-first.

    lats (nlat,), lons (nlon,) radians; sigma (L,) full-level sigma values.
    """
    lats = np.asarray(lats, np.float64)
    lons = np.asarray(lons, np.float64)
    sigma = np.asarray(sigma, np.float64)
    sin_lat = np.sin(lats)
    cos_lat = np.cos(lats)
    halfpi = 0.5 * np.pi

    nv = (sigma - cfg.n0) * halfpi
    xx = rdgas * cfg.lapse / grav
    z2 = cfg.U0 * np.cos(nv) ** 1.5                                # (L,)
    z3 = 0.75 * np.pi * cfg.U0 * sigma * np.sin(nv) * np.sqrt(np.cos(nv)) / rdgas
    z1 = cfg.T0 * sigma**xx + np.where(
        sigma <= cfg.nt, cfg.deltaT * np.maximum(cfg.nt - sigma, 0.0) ** 5, 0.0
    )

    lat1 = 10.0 / 63.0 - 2.0 * sin_lat**6 * (cos_lat**2 + 1.0 / 3.0)  # (nlat,)
    lat2 = radius * omega * (1.6 * cos_lat**3 * (sin_lat**2 + 2.0 / 3.0) - 0.25 * np.pi)

    basic_flow = z2[:, None] * np.sin(2.0 * lats)[None, :] ** 2        # (L, nlat)
    basic_temp = z1[:, None] + z3[:, None] * (lat1[None, :] * 2.0 * z2[:, None]
                                              + lat2[None, :])

    nv_s = (1.0 - cfg.n0) * halfpi
    u_s = cfg.U0 * np.cos(nv_s) ** 1.5
    surf_geopot_1d = u_s * (lat1 * u_s + lat2)                          # (nlat,)

    # perturbation: Up exp(-(10 r)^2), r = great-circle angle from (lonc, latc)
    latc = np.deg2rad(cfg.latc)
    lonc = np.deg2rad(cfg.lonc)
    cosr = (np.sin(latc) * sin_lat[:, None]
            + np.cos(latc) * cos_lat[:, None] * np.cos(lons[None, :] - lonc))
    r = 10.0 * np.arccos(np.clip(cosr, -1.0, 1.0))
    pert = cfg.Up * np.exp(-(r**2))                                     # (nlat, nlon)

    L, nlat, nlon = len(sigma), len(lats), len(lons)
    u = np.broadcast_to(basic_flow[:, :, None], (L, nlat, nlon)) + pert[None]
    t = np.broadcast_to(basic_temp[:, :, None], (L, nlat, nlon)).copy()
    surf_geopot = np.broadcast_to(surf_geopot_1d[:, None], (nlat, nlon)).copy()
    return u, t, surf_geopot


def _on_global_grid(build):
    """On a mesh: build (state, surf_geopotential) on the whole globe
    (core.unsharded()), then keep this rank's blocks."""
    @functools.wraps(build)
    def wrapped(core, *args, **kwargs):
        if core.T.mesh is None:
            return build(core, *args, **kwargs)
        state, surf = build(core.unsharded(), *args, **kwargs)
        return shard_pytree(core.T.mesh, state, nlat=core.T.nlat), core.T.local_lat(surf)
    return wrapped


def _as_grid(core, a):
    """An array or tensor as a tensor of the core's dtype on its device."""
    if not torch.is_tensor(a):
        a = torch.as_tensor(np.array(a, np.float64))
    return a.to(core.device, core.config.dtype)


def _state(core, u, v, t, ln_psg, tracers=None):
    """Band-limit grid (u, v, t, ln ps) through the transforms and assemble a
    PrimitiveState whose two time levels share each tensor (the reference's
    trans round trips + vor_div_from_uv_grid)."""
    from isca_tpu_torch.dycore.primitive import PrimitiveState

    T = core.T
    ts = tr.grid_to_spec(T, t)
    tg = tr.spec_to_grid(T, ts)
    vors, divs = tr.vor_div_from_uv_grid(T, u, v)
    ug, vg = tr.uv_grid_from_vor_div(T, vors, divs)
    vorg = tr.spec_to_grid(T, vors)
    divg = tr.spec_to_grid(T, divs)
    lnps = tr.grid_to_spec(T, ln_psg)
    psg = torch.exp(tr.spec_to_grid(T, lnps))
    two = lambda x: TwoLevel(x, x)
    tracers = tracers or {}
    spec_tracers = {a.name: two(tr.grid_to_spec(T, tracers[a.name].curr))
                    for a in core.tracer_attrs
                    if a.representation == "spectral" and a.name in tracers}
    return PrimitiveState(
        vors=two(vors), divs=two(divs), ts=two(ts), lnps=two(lnps),
        ug=two(ug), vg=two(vg), tg=two(tg), psg=two(psg),
        vorg=two(vorg), divg=two(divg), tracers=tracers, spec_tracers=spec_tracers,
        wg_full=torch.zeros_like(t),
    )


@_on_global_grid
def apply_jablonowski_2006(core, cfg: Jablonowski2006Config = Jablonowski2006Config(),
                           surf_geopotential_out=None):
    """Build a PrimitiveState from the J&W 2006 balanced state on `core`.

    Returns (state, surf_geopotential); pass the geopotential into
    dynamics_step (the state itself carries the band-limited grid fields).
    """
    T = core.T
    C = core.C
    c = core.config
    ps0 = c.reference_sea_level_press
    sigma = (np.asarray(core.pk_np[:-1] + core.pk_np[1:]) / 2.0
             + (core.bk_np[:-1] + core.bk_np[1:]) / 2.0 * ps0) / ps0
    u0, t0, zs = jablonowski_2006_state(
        cfg, T.lats.cpu().numpy(), T.lons.cpu().numpy(), sigma,
        C.radius, C.omega, C.rdgas, C.grav, ps0,
    )
    u = _as_grid(core, u0)
    ln_psg = torch.full(T.grid_shape, math.log(ps0), dtype=c.dtype, device=core.device)
    state = _state(core, u, torch.zeros_like(u), _as_grid(core, t0), ln_psg)
    return state, _as_grid(core, zs)


# ---------------------------------------------------------------------------
# Polvani & Esler (2007): LC1/LC2 baroclinic life-cycle initial states
# (reference: src/atmos_spectral/init/polvani_2007.F90)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Polvani2007Config:
    """polvani_2007_nml (polvani_2007.F90:88-103)."""
    type_of_init: str = "LC1"     # | "LC2"
    T_hat: float = 1.0            # K, perturbation amplitude
    m: int = 6                    # zonal wavenumber of perturbation
    theta_hat: float = 45.0       # deg, perturbation center latitude
    H: float = 7.5e3              # m, scale height
    U0: float = 45.0              # m/s
    sigma_top: float = 0.02
    zt: float = 13.0e3            # m
    lapse: float = -6.5e-3        # K/m
    T0: float = 300.0             # K
    alpha: float = 10.0
    Us: float = 45.0              # m/s
    zs: float = 1.0e4             # m
    theta_s: float = 35.0         # deg
    delta_s: float = 20.0         # deg
    num_iter: int = 10            # surface-pressure fixed-point iterations


def polvani_2007_vert_coord(num_levels, sigma_top=0.02):
    """The paper's log-spaced sigma coordinate (polvani_2007.F90:148-156).

    Returns (pk, bk) for PrimitiveConfig(vert_coord_option='input').
    """
    bk = np.zeros(num_levels + 1)
    bk[0] = sigma_top
    lst = np.log(sigma_top)
    for k in range(1, num_levels):
        bk[k] = np.exp((1.0 - k / num_levels) * lst)
    bk[num_levels] = 1.0
    return np.zeros(num_levels + 1), bk


def _lat_integrate(dTdy, rad_lat, latb):
    """South-to-north staggered integration (polvani_2007.F90:310-318):
    T(j) = T(j-1) + dTdy(j-1)(latb(j)-lat(j-1)) + dTdy(j)(lat(j)-latb(j)).
    dTdy (..., nlat) with latitude LAST; returns same shape."""
    nlat = rad_lat.shape[0]
    out = np.zeros_like(dTdy)
    out[..., 0] = dTdy[..., 0] * (rad_lat[0] - latb[0])
    for j in range(1, nlat):
        out[..., j] = (out[..., j - 1]
                       + dTdy[..., j - 1] * (latb[j] - rad_lat[j - 1])
                       + dTdy[..., j] * (rad_lat[j] - latb[j]))
    return out


def polvani_2007_state(cfg: Polvani2007Config, lats, latb, lons, p_full,
                       radius, omega, rdgas, p00=1.0e5):
    """(u, t, psurf, perturbation): u,t as (L, nlat); psurf (nlat,);
    perturbation (nlat, nlon). p_full (L,) from the paper's coordinate at
    ps=p00. Rows are built on L+1 heights (surface appended) exactly as the
    reference; only the first L feed the model. The 11 passive life-cycle
    tracers of the reference are not ported."""
    lats = np.asarray(lats, np.float64)
    latb = np.asarray(latb, np.float64)
    lons = np.asarray(lons, np.float64)
    sin_lat, cos_lat = np.sin(lats), np.cos(lats)
    tan_lat = sin_lat / cos_lat
    coriolis = 2.0 * omega * sin_lat
    af = radius * coriolis
    ln_slp = np.log(p00)
    L = len(p_full)

    # heights on L+1 rows, last row = surface z=0
    z = np.concatenate([cfg.H * (ln_slp - np.log(p_full)), [0.0]])
    zt, H = cfg.zt, cfg.H

    # --- LC1 jet (compute_LC1, polvani_2007.F90:287-346) ---
    ztmp = z / zt
    fz1 = ztmp * np.exp(-0.5 * (ztmp**2 - 1.0))
    dfz1 = ((1.0 - ztmp**2) / zt) * np.exp(-0.5 * (ztmp**2 - 1.0))
    fy1 = np.where(sin_lat > 0.0, np.sin(np.pi * sin_lat**2) ** 3, 0.0)

    u1 = cfg.U0 * fy1[None, :] * fz1[:, None]                  # (L+1, nlat)
    du1 = cfg.U0 * fy1[None, :] * dfz1[:, None]
    dTdy1 = -(H / rdgas) * (af[None, :] + 2.0 * u1 * tan_lat[None, :]) * du1
    t1_int = _lat_integrate(dTdy1, lats, latb)
    Tr = np.concatenate([
        cfg.T0 + cfg.lapse / (zt**-cfg.alpha + z[:-1]**-cfg.alpha) ** (1.0 / cfg.alpha),
        [cfg.T0]])
    t1 = Tr[:, None] + t1_int
    psurf1 = np.full(len(lats), p00)

    # --- perturbation (compute_perturbation) ---
    lon_factor = np.cos(cfg.m * lons)
    lat_factor = 1.0 / np.cosh(cfg.m * (lats - np.deg2rad(cfg.theta_hat))) ** 2
    perturbation = cfg.T_hat * lat_factor[:, None] * lon_factor[None, :]

    if cfg.type_of_init.upper() == "LC1":
        return u1[:L], t1[:L], psurf1, perturbation

    # --- LC2 surface shear addition (compute_LC2) ---
    deg_lat = np.rad2deg(lats)
    fz2 = np.exp(-z / cfg.zs)
    dfz2 = -fz2 / cfg.zs
    y2 = (deg_lat - cfg.theta_s) / cfg.delta_s
    fy2 = np.sin(2.0 * lats) ** 2 * y2 * np.exp(-y2**2)
    uss = -cfg.Us * fy2[None, :] * fz2[:, None]
    duss = -cfg.Us * fy2[None, :] * dfz2[:, None]
    dTdy2 = -(H / rdgas) * (af[None, :] + 2.0 * uss * tan_lat[None, :]) * duss
    tss = _lat_integrate(dTdy2, lats, latb)
    u2, t2 = u1 + uss, t1 + tss

    # --- surface pressure fixed point (compute_surf_press) ---
    e = np.e
    c1 = 2.0 * e * (cfg.U0 / zt) ** 2
    c2 = cfg.Us / cfg.zs**2
    dlapse = np.where(
        sin_lat > 0.0,
        c1 * tan_lat * fy1**2 - (af - 2.0 * cfg.Us * fy2 * tan_lat) * c2 * fy2,
        0.0)
    lapse00 = _lat_integrate(-(H / rdgas) * dlapse, lats, latb) + cfg.lapse
    zstar = np.zeros(len(lats))
    for _ in range(cfg.num_iter):
        tstar = t2[-1] + lapse00 * zstar
        u1star = cfg.U0 * np.sqrt(e) * fy1 * zstar / zt
        u2star = (zstar / cfg.zs - 1.0) * cfg.Us * fy2
        ustar = u1star + u2star
        dzdy = np.where(sin_lat > 0.0,
                        H * ustar * (af + ustar * tan_lat) / (rdgas * tstar),
                        0.0)
        zstar = _lat_integrate(dzdy, lats, latb)
    psurf2 = p00 * np.exp(-zstar / H)
    return u2[:L], t2[:L], psurf2, perturbation


# ---------------------------------------------------------------------------
# Polvani, Scott & Thomas (2004): dry dynamical-core test state
# (reference: src/atmos_spectral/init/polvani_2004.F90)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Polvani2004Config:
    """polvani_2004_nml (polvani_2004.F90:50-81)."""
    H: float = 7.340e3
    z0: float = 22.0e3
    delta_z0: float = 5.0e3
    z1: float = 30.0e3
    u0: float = 50.0
    perturb_amp: float = 1.0
    sea_level_press: float = 1.0e5


# US-standard-atmosphere breakpoints (polvani_2004.F90:38-41)
_Z_STANDARD = np.array([0.0, 11.0e3, 20.0e3, 32.0e3, 47.0e3, 51.0e3, 71.0e3, 80.0e3])
_LAPSE_STANDARD = np.array([-6.5e-3, 0.0, 1.0e-3, 2.8e-3, 0.0, -2.8e-3, -2.0e-3])


def polvani_2004_state(cfg: Polvani2004Config, lats, latb, lons, wts_lat,
                       p_full, radius, omega, rdgas):
    """(u, t, perturbation): u,t (L, nlat); perturbation (nlat, nlon).

    Designed for 20 even-sigma levels (the reference enforces this)."""
    lats = np.asarray(lats, np.float64)
    latb = np.asarray(latb, np.float64)
    lons = np.asarray(lons, np.float64)
    wts = np.asarray(wts_lat, np.float64)
    sin_lat, cos_lat = np.sin(lats), np.cos(lats)
    tan_lat = sin_lat / cos_lat
    coriolis = 2.0 * omega * sin_lat
    L = len(p_full)

    t_std = np.zeros(len(_Z_STANDARD))
    t_std[0] = 288.15
    for ks in range(1, len(_Z_STANDARD)):
        t_std[ks] = t_std[ks - 1] + _LAPSE_STANDARD[ks - 1] * (
            _Z_STANDARD[ks] - _Z_STANDARD[ks - 1])

    z = cfg.H * (np.log(cfg.sea_level_press) - np.log(p_full))
    T0 = np.interp(np.minimum(z, _Z_STANDARD[-1]), _Z_STANDARD, t_std)

    zz1 = (z - cfg.z0) / cfg.delta_z0
    zz2 = np.pi * z / cfg.z1
    ff1 = 1.0 - np.tanh(zz1) ** 3
    ff2 = np.sin(zz2)
    F = 0.5 * ff1 * ff2
    dff1 = -3.0 * (np.tanh(zz1) / np.cosh(zz1)) ** 2 / cfg.delta_z0
    dff2 = np.cos(zz2) * np.pi / cfg.z1
    dF = 0.5 * (ff1 * dff2 + dff1 * ff2)

    shape_y = np.where(sin_lat > 0.0, np.sin(np.pi * sin_lat**2) ** 3, 0.0)
    basic_flow = cfg.u0 * F[:, None] * shape_y[None, :]          # (L, nlat)
    du_dz = cfg.u0 * dF[:, None] * shape_y[None, :]
    dTdy = -(cfg.H / rdgas) * (radius * coriolis[None, :]
                               + 2.0 * basic_flow * tan_lat[None, :]) * du_dz

    # staggered integration with the reference's 1/cos factor on row 1 only
    # (polvani_2004.F90: term1_eq10 construction)
    term1 = np.zeros_like(dTdy)
    term1[:, 0] = (lats[0] - latb[0]) * dTdy[:, 0] / cos_lat[0]
    for j in range(1, len(lats)):
        term1[:, j] = (term1[:, j - 1]
                       + (latb[j] - lats[j - 1]) * dTdy[:, j - 1]
                       + (lats[j] - latb[j]) * dTdy[:, j])
    gmean = np.sum(0.5 * wts[None, :] * term1, axis=1)
    basic_temp = term1 - gmean[:, None] + T0[:, None]

    # localized perturbation at (0E, 45N) (polvani_2004.F90:236-250)
    lambda0, phi0 = 0.0, np.pi / 4.0
    alpha, beta = 1.0 / 3.0, 1.0 / 6.0
    xx = lons - lambda0
    xx = xx - 2.0 * np.pi * np.rint(xx / (2.0 * np.pi))
    lon_factor = 1.0 / np.cosh(xx / alpha) ** 2
    lat_factor = 1.0 / np.cosh((lats - phi0) / beta) ** 2
    perturbation = cfg.perturb_amp * lat_factor[:, None] * lon_factor[None, :]
    return basic_flow[:L], basic_temp[:L], perturbation


def _balanced_grid_state(core, u_latlev, t_latlev, psurf_lat, perturbation):
    """Shared tail of the Polvani constructors: broadcast zonal-mean (L, nlat)
    fields to the grid, add the temperature perturbation, band-limit through
    the transforms, and assemble a PrimitiveState (polvani_200x.F90 epilogue:
    trans round trips + vor_div_from_uv_grid)."""
    T = core.T
    L = core.config.num_levels
    nlat, nlon = T.grid_shape
    u0 = np.broadcast_to(u_latlev[:, :, None], (L, nlat, nlon))
    t0 = (np.broadcast_to(t_latlev[:, :, None], (L, nlat, nlon))
          + perturbation[None, :, :])
    ps0 = np.broadcast_to(psurf_lat[:, None], (nlat, nlon))
    u = _as_grid(core, u0)
    state = _state(core, u, torch.zeros_like(u), _as_grid(core, t0),
                   torch.log(_as_grid(core, ps0)))
    return state, torch.zeros(T.grid_shape, dtype=core.config.dtype, device=core.device)


@_on_global_grid
def apply_polvani_2007(core, cfg: Polvani2007Config = Polvani2007Config()):
    """Build a PrimitiveState from the Polvani-Esler 2007 life-cycle state.

    The core should use the paper's vertical coordinate
    (`polvani_2007_vert_coord`, vert_coord_option='input'); any coordinate
    works numerically. Returns (state, surf_geopotential)."""
    T = core.T
    C = core.C
    ps0 = core.config.reference_sea_level_press
    ph = core.pk_np + core.bk_np * ps0
    p_full = 0.5 * (ph[:-1] + ph[1:])
    lats = T.lats.cpu().numpy()
    latb = _lat_boundaries(lats)
    u, t, psurf, pert = polvani_2007_state(
        cfg, lats, latb, T.lons.cpu().numpy(), p_full,
        C.radius, C.omega, C.rdgas, ps0)
    return _balanced_grid_state(core, u, t, psurf, pert)


@_on_global_grid
def apply_polvani_2004(core, cfg: Polvani2004Config = Polvani2004Config()):
    """Build a PrimitiveState from the Polvani-Scott-Thomas 2004 test state
    (designed for 20 even-sigma levels). Returns (state, surf_geopot)."""
    T = core.T
    C = core.C
    ps0 = cfg.sea_level_press
    ph = core.pk_np + core.bk_np * ps0
    p_full = 0.5 * (ph[:-1] + ph[1:])
    lats = T.lats.cpu().numpy()
    latb = _lat_boundaries(lats)
    u, t, pert = polvani_2004_state(
        cfg, lats, latb, T.lons.cpu().numpy(),
        T.wts.cpu().numpy(), p_full, C.radius, C.omega, C.rdgas)
    psurf = np.full(len(lats), ps0)
    return _balanced_grid_state(core, u, t, psurf, pert)


def _lat_boundaries(lats):
    """Gaussian-latitude cell boundaries (south pole .. north pole)."""
    latb = np.zeros(len(lats) + 1)
    latb[0] = -np.pi / 2.0
    latb[-1] = np.pi / 2.0
    latb[1:-1] = 0.5 * (lats[:-1] + lats[1:])
    return latb


# ---------------------------------------------------------------------------
# Initial condition from an external NetCDF file
# (reference: src/atmos_spectral/init/ic_from_external_file.F90 —
# initial_state_option='input' in spectral_init_cond)
# ---------------------------------------------------------------------------

@_on_global_grid
def apply_external_file(core, file_name, u_name="u", v_name="v", t_name="t",
                        ps_name="ps", surf_geopotential=None):
    """Build a PrimitiveState from grid fields in a NetCDF file.

    Mirrors ic_from_external_file.F90:67-158: fields must already be on the
    model's Gaussian grid at the model's level count — a shape mismatch is an
    error, exactly as in the reference (:115-121). The grid fields are
    band-limited through one spectral round trip and the winds rebuilt from
    their truncated (vor, div), so the state is spectrally consistent.

    Arrays are accepted as (lev, lat, lon) [C order] or (lon, lat, lev)
    [the reference's Fortran storage order]; ps as (lat, lon) or (lon, lat).
    Tracers declared on the core are read by name (missing tracer = error,
    :138-146). Returns (state, surf_geopotential).
    """
    from isca_tpu_torch.utils.input_files import read_netcdf

    T = core.T
    L = core.config.num_levels
    nlat, nlon = T.grid_shape

    data = read_netcdf(file_name)

    def field3(name):
        if name not in data:
            raise ValueError(f"'{name}' does not exist in {file_name}")
        arr = np.asarray(data[name], np.float64)
        if arr.shape == (L, nlat, nlon):
            return arr
        if arr.shape == (nlon, nlat, L):
            return arr.transpose(2, 1, 0)
        raise ValueError(
            f"'{name}' in {file_name} has shape {arr.shape}; expected "
            f"(lev,lat,lon)={(L, nlat, nlon)} or (lon,lat,lev)")

    def field2(name):
        if name not in data:
            raise ValueError(f"'{name}' does not exist in {file_name}")
        arr = np.asarray(data[name], np.float64)
        if arr.shape == (nlat, nlon):
            return arr
        if arr.shape == (nlon, nlat):
            return arr.T
        raise ValueError(
            f"'{name}' in {file_name} has shape {arr.shape}; expected "
            f"(lat,lon)={(nlat, nlon)} or (lon,lat)")

    u0, v0, t0, ps0 = field3(u_name), field3(v_name), field3(t_name), field2(ps_name)

    tracers = {}
    for attr in core.tracer_attrs:
        if attr.name in data:
            q = _as_grid(core, field3(attr.name))
            tracers[attr.name] = TwoLevel(q, q)
        else:
            raise ValueError(
                f"tracer '{attr.name}' is declared on the model but does not "
                f"exist in {file_name}")
    state = _state(core, _as_grid(core, u0), _as_grid(core, v0), _as_grid(core, t0),
                   torch.log(_as_grid(core, ps0)), tracers)
    if surf_geopotential is None:
        surf_geopotential = np.zeros(T.grid_shape)
    return state, _as_grid(core, surf_geopotential)
