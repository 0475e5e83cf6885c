"""Finite-volume (van Leer) horizontal advection for grid tracers on the A-grid.

Port of isca_tpu/dycore/fv_advection.py (reference:
src/atmos_spectral/model/fv_advection.F90): a Lin-Rood-style
dimension-split scheme with half-step semi-Lagrangian cross-terms, C-grid
interpolated winds, monotone-limited van Leer fluxes, a semi-Lagrangian
integer-CFL extension in longitude near the poles, and antipodal polar halos.

The reference's yhalo=2 halo exchanges are rolls and slices; the per-point
integer-flux loops are a prefix sum and a gather along longitude
(`torch.gather`, exact on every device). Index arithmetic on negative
integers is floor-based (`torch.remainder`, `torch.div(..., "floor")`), as
`jnp.mod` and `jnp.floor_divide` are.

Arrays are (..., lat, lon), latitude south->north (index 0 = southernmost).
On a mesh the arrays are a rank's latitude band: the halo rows between two
bands come from the neighbouring ranks (`Mesh.exchange_rows`, where
isca_tpu relies on XLA inserting the permutes), the antipodal halo and the
zero flux stay at the true poles, on the polar bands' ranks, and the
geometry is the whole globe's, cut to the band.
Everything here is in the `advective` form used by update_tracers
(dq_dt from a_grid_horiz_advection includes +q*div so the tendency is -V.grad q).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from isca_tpu_torch.spectral import transforms as tr
from isca_tpu_torch.spectral.transforms import SphericalTransforms


@dataclasses.dataclass(frozen=True)
class FVGeometry:
    c: torch.Tensor         # (ny,) cos(lat) at box centers (midpoints of boundaries)
    cc: torch.Tensor        # (ny+1,) cos(lat) at box boundaries
    dy: torch.Tensor        # (ny+4,) box widths [m], indexed j-2..ny+1 (halo-extended)
    dyy: torch.Tensor       # (ny+1,) distance between full points [m]
    dy_plus: torch.Tensor   # (ny+2,) dy(j)/(dy(j)+dy(j+1)), rows j-1..ny
    dy_minus: torch.Tensor  # (ny+2,) dy(j)/(dy(j-1)+dy(j)), rows j-1..ny
    nx: int
    ny: int
    dx: float               # lon grid spacing at the equator [m]
    monotone: bool
    mesh: Any = None        # the transforms' mesh: rows are a latitude band
    south_pole: bool = True  # the band's first row is the southernmost
    north_pole: bool = True  # the band's last row is the northernmost


def make_fv_geometry(T: SphericalTransforms, monotone: bool = True) -> FVGeometry:
    """Gaussian-box boundaries: sin(yy_j) partitions [-1,1] by the weights.
    On a mesh: the whole globe's geometry, cut to the rank's band."""
    ny, nx = T.nlat, T.nlon
    w = tr.gaussian_weights(T).detach().cpu().numpy().astype(np.float64)
    mu_b = -1.0 + np.concatenate([[0.0], np.cumsum(w)])
    mu_b = np.clip(mu_b, -1.0, 1.0)
    yy = np.arcsin(mu_b)                      # (ny+1,) boundary latitudes
    y = 0.5 * (yy[1:] + yy[:-1])              # box centers (reference convention)
    c = np.cos(y)
    cc = np.cos(yy)
    a = T.radius
    dy_core = (yy[1:] - yy[:-1]) * a          # (ny,)
    # halo-extended dy, reference: dy(-1)=dy(2), dy(0)=dy(1), dy(ny+1)=dy(ny), dy(ny+2)=dy(ny-1)
    dy = np.concatenate([[dy_core[1], dy_core[0]], dy_core, [dy_core[-1], dy_core[-2]]])
    dyy = np.empty(ny + 1)
    dyy[1:ny] = (y[1:] - y[:-1]) * a
    dyy[0] = 2 * (y[0] - yy[0]) * a
    dyy[ny] = 2 * (yy[ny] - y[ny - 1]) * a
    # dy_plus/minus over rows j-1..ny (ny+2 values); dy index offset: dy[k+2] = dy_core[k]
    jj = np.arange(-1, ny + 1)
    dy_plus = dy[jj + 2] / (dy[jj + 2] + dy[jj + 3])
    dy_minus = dy[jj + 2] / (dy[jj + 1] + dy[jj + 2])
    # the band's rows j0..j1-1 (each table keeps its own halo extension)
    j0, j1 = T.lat_start, T.lat_start + T.grid_shape[0]
    f = lambda x, extra: torch.as_tensor(x[j0:j1 + extra]).to(device=T.device,
                                                              dtype=T.dtype)
    return FVGeometry(
        c=f(c, 0), cc=f(cc, 1), dy=f(dy, 4), dyy=f(dyy, 1),
        dy_plus=f(dy_plus, 2), dy_minus=f(dy_minus, 2),
        nx=nx, ny=j1 - j0, dx=float(2.0 * np.pi * a / nx), monotone=bool(monotone),
        mesh=T.mesh, south_pole=j0 == 0, north_pole=j1 == ny,
    )


def _antipode(x):
    """Value across the pole: shift longitude by 180 degrees."""
    return torch.roll(x, x.shape[-1] // 2, dims=-1)


def _halo_y(G, q, sign=1.0):
    """Append 2 halo rows on each side of the lat axis (axis -2): antipodal
    across a pole (times `sign`), the neighbouring band's rows elsewhere."""
    south = north = None
    if G.mesh is not None:
        south, north = G.mesh.exchange_rows(q, 2)
    if south is None:   # rows 1,0 -> j=-2,-1
        south = sign * _antipode(torch.flip(q[..., :2, :], dims=(-2,)))
    if north is None:   # rows ny-1, ny-2 -> j=ny, ny+1
        north = sign * _antipode(torch.flip(q[..., -2:, :], dims=(-2,)))
    return torch.cat([south, q, north], dim=-2)


def _limit_slope(slope, q, qm, qp, monotone):
    if monotone:
        q_min = torch.minimum(torch.minimum(qm, q), qp)
        q_max = torch.maximum(torch.maximum(qm, q), qp)
        lim = torch.minimum(2.0 * (q - q_min), 2.0 * (q_max - q))
    else:
        lim = 2.0 * q
    return torch.sign(slope) * torch.minimum(torch.abs(slope), lim)


def _slope_x(q, monotone):
    qm = torch.roll(q, 1, dims=-1)
    qp = torch.roll(q, -1, dims=-1)
    slope = 0.5 * (qp - qm)
    return _limit_slope(slope, q, qm, qp, monotone)


def _gather_x(q, idx):
    """q[..., idx] with idx (int64) of the same shape as q."""
    return torch.gather(q, -1, idx)


def _lon_index(like):
    """The longitude index of every point of `like`, as int64."""
    nx = like.shape[-1]
    return torch.arange(nx, device=like.device).expand(like.shape)


def a_grid_horiz_advection(G: FVGeometry, ua, va, q, dt, flux_form: bool = False):
    """dq_dt from one horizontal van Leer advection step (reference semantics).

    ua, va, q: (..., lat, lon) of one shape. Returns the tendency (advective
    form unless flux_form: the reference adds +q*div to convert flux->advective).
    """
    c = G.c[:, None]                 # (ny, 1)
    dy_c = G.dy[2:-2][:, None]       # (ny, 1) core box widths

    # ---- C-grid winds ----
    uc = 0.5 * (torch.roll(ua, 1, dims=-1) + ua)             # at left interfaces
    vx = _halo_y(G, va, sign=-1.0)[..., 1:-1, :]             # rows -1..ny
    vc = 0.5 * (vx[..., :-1, :] + vx[..., 1:, :])            # (.., ny+1, lon) interfaces

    out = torch.zeros_like(q)
    if not flux_form:
        ccb = G.cc[:, None]
        div = (vc[..., 1:, :] * ccb[1:] - vc[..., :-1, :] * ccb[:-1]) / (c * dy_c)
        div = div + (torch.roll(uc, -1, dims=-1) - uc) / (c * G.dx)
        out = out + q * div

    # ---- half-step cross terms ----
    qx = _halo_y(G, q)                                       # rows -2..ny+1
    q1 = q + _semi_x(G, ua, q, 0.5 * dt)                     # for the y fluxes
    q2 = q + _semi_y(G, va, qx, 0.5 * dt)                    # for the x fluxes
    q1x = _halo_y(G, q1)

    out = out + _vanleer_x(G, uc, q2, dt)
    out = out + _vanleer_y(G, vc, q1x, dt)
    return out


def _semi_x(G, ua, q, dt):
    """Half-step semi-Lagrangian displacement in longitude (fv_advection semi_x)."""
    b = ua * dt / (G.dx * G.c[:, None])
    fb = torch.floor(b)
    bb = b - fb
    left = torch.remainder(_lon_index(q) - 1 - fb.to(torch.int64), G.nx)
    # q[left+1 mod nx] == roll(q, -1)[left]
    q_left = _gather_x(q, left)
    q_right = _gather_x(torch.roll(q, -1, dims=-1), left)
    return bb * q_left + (1.0 - bb) * q_right - q


def _semi_y(G, va, qx, dt):
    """Half-step upwind displacement in latitude; qx has 2 halo rows each side."""
    qc = qx[..., 2:-2, :]
    qm = qx[..., 1:-3, :]
    qp = qx[..., 3:-1, :]
    dyy_j = G.dyy[:-1][:, None]     # dyy(j), rows 0..ny-1
    dyy_jp = G.dyy[1:][:, None]     # dyy(j+1)
    pos = va * dt * (qm - qc) / dyy_j
    neg = va * dt * (qc - qp) / dyy_jp
    return torch.where(va >= 0.0, pos, neg)


def _vanleer_x(G, uc, q, dt):
    """Monotone van Leer flux in longitude with integer-CFL extension."""
    nx = G.nx
    b = uc * dt / (G.dx * G.c[:, None])        # Courant number at interfaces
    ii_int = torch.trunc(b)
    frac = b - ii_int
    # integer part: flux_int(k) = sum_{j=k-ii}^{k-1} q_j = Pext(k) - Pext(k-ii)
    csum = torch.cumsum(q, dim=-1)
    total = csum[..., -1:]
    P_excl = torch.cat([torch.zeros_like(csum[..., :1]), csum[..., :-1]], dim=-1)

    k = _lon_index(q)
    # k - ii_int is integer-valued: the int64 cast is exact
    idx_src = k - ii_int.to(torch.int64)
    wraps = torch.div(idx_src, nx, rounding_mode="floor")
    idx_mod = idx_src - wraps * nx
    p_src = _gather_x(P_excl, idx_mod)
    flux_int = P_excl - (p_src + wraps.to(q.dtype) * total)
    # fractional part from the donor cell k - 1 - floor(b)
    donor = torch.remainder(k - 1 - torch.floor(b).to(torch.int64), nx)
    s = _slope_x(q, G.monotone)
    qq, ss = _gather_x(q, donor), _gather_x(s, donor)
    sgn = torch.where(frac >= 0.0, 1.0, -1.0).to(q.dtype)
    flux = flux_int + frac * (qq + 0.5 * ss * (sgn - frac))
    # dq_dt = -(flux(k+1) - flux(k))/dt  with periodic wrap
    return -(torch.roll(flux, -1, dims=-1) - flux) / dt


def _vanleer_y(G, vc, qx, dt):
    """Monotone van Leer flux in latitude; qx has 2 antipodal halo rows each side."""
    # slopes on rows -1..ny (ny+2 rows)
    qc = qx[..., 1:-1, :]      # rows -1..ny
    qm = qx[..., :-2, :]       # rows -2..ny-1
    qp = qx[..., 2:, :]        # rows 0..ny+1
    slope = (qp - qc) * G.dy_plus[:, None] + (qc - qm) * G.dy_minus[:, None]
    s = _limit_slope(slope, qc, qm, qp, G.monotone)   # rows -1..ny

    dy_ext = G.dy[1:-1][:, None]        # rows -1..ny (ny+2,)
    dtdy = dt / dy_ext
    # flux at interfaces j = 0..ny: donor row j-1 (vc>=0) or j (vc<0)
    q_dn = qx[..., 1:-2, :]    # rows -1..ny-1 (donor below interface)
    q_up = qx[..., 2:-1, :]    # rows 0..ny
    s_dn = s[..., :-1, :]
    s_up = s[..., 1:, :]
    dtdy_dn = dtdy[:-1]
    dtdy_up = dtdy[1:]
    ccb = G.cc[:, None]
    flux_pos = vc * ccb * (q_dn + 0.5 * s_dn * (1.0 - dtdy_dn * vc))
    flux_neg = vc * ccb * (q_up - 0.5 * s_up * (1.0 + dtdy_up * vc))
    flux = torch.where(vc >= 0.0, flux_pos, flux_neg)
    # polar boundaries: zero flux (at the true poles only)
    zero = torch.zeros_like(flux[..., :1, :])
    if G.south_pole:
        flux = torch.cat([zero, flux[..., 1:, :]], dim=-2)
    if G.north_pole:
        flux = torch.cat([flux[..., :-1, :], zero], dim=-2)
    dyc = 1.0 / (G.dy[2:-2][:, None] * G.c[:, None])
    return -dyc * (flux[..., 1:, :] - flux[..., :-1, :])
