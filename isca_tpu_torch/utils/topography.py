"""Surface boundary conditions: analytic Gaussian mountains, idealized land
masks, and spectrally-smoothed input topography.

Port of isca_tpu/utils/topography.py. Reference:
src/shared/topography/gaussian_topog.F90 (analytic mountains),
src/extra/python/isca/land_generator_fn.py (idealized land masks: squares and
Sauliere-2012-style continents), and src/atmos_spectral/init/
{spectral_init_cond,topog_regularization}.F90 (band-limiting input topography
through the spectral transform to reduce Gibbs ringing). Host-side numpy at
model-build time, except band_limit_topography, which runs the port's
transforms on their device and returns a tensor there.
"""

from __future__ import annotations

import numpy as np
import torch

from isca_tpu_torch.spectral import transforms as tr


def gaussian_topography(
    lons_deg, lats_deg, height=3000.0, olon=90.0, olat=45.0,
    wlon=15.0, wlat=15.0, rlon=0.0, rlat=0.0,
):
    """Gaussian mountain on (lat, lon) grid, heights in meters
    (gaussian_topog.F90:215-259 semantics, incl. ridge half-widths r*)."""
    lon = np.deg2rad(np.asarray(lons_deg))
    lat = np.deg2rad(np.asarray(lats_deg))
    d2r = np.pi / 180.0
    dy = np.abs(lat[:, None] - olat * d2r)
    yy = np.maximum(0.0, dy - rlat * d2r) / (wlat * d2r)
    dx = np.abs(lon[None, :] - olon * d2r)
    dx = np.minimum(dx, np.abs(dx - 2 * np.pi))
    xx = np.maximum(0.0, dx - rlon * d2r) / (wlon * d2r)
    return height * np.exp(-(xx**2) - yy**2)


# Sauliere 2012-style idealized continents (land_generator_fn.py:63-120)
_CONTINENTS = {
    # name: callable(lon_deg 2d, lat_deg 2d) -> bool mask
    "NA": lambda lo, la: (la >= 20) & (la <= 60)
    & (lo >= 260 - 0.8 * (la - 20)) & (lo <= 300 - 0.4 * (la - 20)),
    "SA": lambda lo, la: (la <= 20) & (la >= -60)
    & (lo >= 280 - 0.5 * (la - 20)) & (lo <= 310 + 0.3 * (la - 20)),
    "EA": lambda lo, la: (la >= 20) & (la <= 70) & (lo >= 0) & (lo <= 130),
    "AF": lambda lo, la: (la <= 20) & (la >= -35) & (lo >= 0 + 0.5 * (20 - la))
    & (lo <= 50),
    "AUS": lambda lo, la: (la <= -10) & (la >= -40) & (lo >= 110) & (lo <= 155),
    "IND": lambda lo, la: (la <= 23) & (la >= 5) & (lo >= 65) & (lo <= 90),
}


def land_mask(
    lons_deg, lats_deg, land_mode="square",
    boundaries=(20.0, 60.0, 20.0, 60.0), continents=("all",),
):
    """Idealized land mask on (lat, lon): 1 over land, 0 over ocean."""
    lo, la = np.meshgrid(np.asarray(lons_deg), np.asarray(lats_deg))
    if land_mode == "none":
        return np.zeros_like(lo)
    if land_mode == "square":
        s, n, w, e = boundaries
        return (((la >= s) & (la <= n)) & ((lo >= w) & (lo <= e))).astype(np.float64)
    if land_mode == "continents":
        names = _CONTINENTS.keys() if "all" in continents else continents
        mask = np.zeros_like(lo, dtype=bool)
        for name in names:
            mask |= _CONTINENTS[name](lo, la)
        return mask.astype(np.float64)
    raise ValueError(land_mode)


def _whole_globe(T: tr.SphericalTransforms, what: str):
    if T.mesh is not None:
        raise ValueError(f"{what} needs the whole globe's transforms, not a rank's "
                         "(T.mesh is set): build mesh-less transforms of the same "
                         "truncation, then cut the result to the band")


def band_limit_topography(T: tr.SphericalTransforms, zsurf, n_smooth_passes=0,
                          smooth_fraction=0.0):
    """Round-trip topography through the spectral transform so the initial
    surface geopotential is band-limited (spectral_init_cond semantics); an
    optional weak del^2 smoothing pass approximates topog_regularization's
    ocean smoothing.

    T must hold the whole globe: on a mesh, band-limit with mesh-less
    transforms of the same truncation first and give set_land the whole
    field (a sharded T raises ValueError)."""
    _whole_globe(T, "band_limit_topography")
    z = torch.as_tensor(zsurf if torch.is_tensor(zsurf) else np.asarray(zsurf, np.float64)).to(
        device=T.device, dtype=T.dtype)
    zs = tr.grid_to_spec(T, z)
    if n_smooth_passes > 0 and smooth_fraction > 0:
        lam = -T.eigenvalues / float(torch.max(-T.eigenvalues))
        damp = (1.0 - smooth_fraction * lam) ** n_smooth_passes
        zs = zs * damp.to(zs.dtype)
    return tr.spec_to_grid(T, zs)


# ---------------------------------------------------------------------------
# Ocean topography regularization — Lindberg & Broccoli (1996), the
# reference's topog_regularization.F90. Host-side numpy at init time.
# ---------------------------------------------------------------------------

def _host(x) -> np.ndarray:
    """A table or field as a float64 numpy array on the host."""
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def _np_tables(T: tr.SphericalTransforms):
    _whole_globe(T, "the topography regularization")
    P = _host(T.P)                           # (nlat, M+1, N+1)
    Pw = _host(T.Pw)
    Cf = _host(T.dft_cos_f)
    Sf = _host(T.dft_sin_f)
    Ci = _host(T.dft_cos_i)
    Si = _host(T.dft_sin_i)
    tri = _host(T.triangle)

    def g2s(g):
        F = g @ Cf + 1j * (g @ Sf)           # (nlat, M+1)
        return np.einsum("jmn,jm->mn", Pw, F) * tri

    def s2g(s):
        F = np.einsum("jmn,mn->jm", P, s)
        return F.real @ Ci + F.imag @ Si

    return P, g2s, s2g


def regularize_topography(
    T: tr.SphericalTransforms,
    surf_field,
    ocean_mask,
    lam: float,
    itmax: int = 1000,
    tolerance: float = 1.0e-5,
):
    """One regularization solve at fixed lambda (topog_regularization.F90:153-291).

    Minimizes ocean misfit + lam * ocean roughness (squared Laplacian) by
    Jacobi-style iteration in spectral space; land roughness is unconstrained.
    Returns (smoothed_field, fraction_smoothed) where fraction_smoothed =
    1 - <(del^2 a)^2>_ocean / <(del^2 b)^2>_ocean.
    """
    P, g2s, s2g = _np_tables(T)
    h = _host(surf_field)
    ocean = _host(ocean_mask) > 0.5
    wts = _host(T.wts)
    nn1 = _host(T.nn1)[None, : T.num_spherical + 1]  # n(n+1)

    def ocean_mean(f):
        return (f * ocean * (wts[:, None] / 2.0)).sum() / T.nlon

    # Dnm: ocean-weighted mean of squared Legendre functions (:336-360)
    ocean_frac_row = ocean.sum(axis=1) / T.nlon                  # (nlat,)
    Dnm = np.einsum("j,jmn->mn", wts * ocean_frac_row, P**2)
    Hnm = 1.0 / (1.0 + lam * Dnm * nn1**2)

    # Lanczos sigma factors for m > 0 (:328-333, applied :232-236)
    # Lanczos profile is a function of the TRUE truncation; padded m rows are
    # structurally zero so their sigma value is irrelevant (kept finite)
    m_idx = np.arange(T.num_fourier + 1, dtype=np.float64)
    facm = np.pi * np.minimum(m_idx, T.num_fourier_true) / (
        2.0 * max(T.num_fourier_true, 1))
    sig = np.ones_like(facm)
    sig[1:] = np.sin(facm[1:]) / facm[1:]
    sig = sig[:, None]

    bnm = g2s(h)
    anm = bnm / (1.0 + lam * nn1**2)                              # eq. 6.3
    rough = s2g(nn1 * anm)

    cost = 0.0
    converged = False
    for it in range(itmax):
        dr2 = nn1 * g2s(np.where(ocean, rough, 0.0))
        base = anm + Hnm * (bnm - anm) - lam * Hnm * dr2
        anm = np.where(m_idx[:, None] > 0, base * sig, base)
        smoothed = s2g(anm)
        rough = s2g(nn1 * anm)
        oldcost = cost
        cost = ocean_mean((h - smoothed) ** 2 + lam * rough**2)   # eq. 6.4
        if it > 0 and abs((oldcost - cost) / max(oldcost, 1e-300)) < tolerance:
            converged = True
            break
    if not converged:
        raise RuntimeError("regularize_topography failed to converge")

    lamcost_i = ocean_mean(s2g(nn1 * bnm) ** 2)
    lamcost = ocean_mean(rough**2)
    fraction_smoothed = 1.0 - lamcost / lamcost_i
    return smoothed, fraction_smoothed


def smooth_ocean_topography(
    T: tr.SphericalTransforms,
    surf_field,
    ocean_mask,
    ocean_topog_smoothing: float = 0.93,
    tol_lambda: float = 1.0e-3,
    itmax_lambda: int = 20,
):
    """Find lambda achieving the target smoothed fraction by secant iteration
    (compute_lambda, topog_regularization.F90:79-150), then regularize.

    Returns (smoothed_field, lambda, actual_fraction_smoothed). Used by the
    reference for topography_option='input'/'interpolated' with a land mask
    (spectral_init_cond.F90:238-247, ocean_topog_smoothing nml default .93).
    """
    lam1, lam2 = 1.0e-7, 2.0e-7
    s1, f1 = regularize_topography(T, surf_field, ocean_mask, lam1)
    if abs(ocean_topog_smoothing - f1) < tol_lambda:
        return s1, lam1, f1
    s2, f2 = regularize_topography(T, surf_field, ocean_mask, lam2)
    if abs(ocean_topog_smoothing - f2) < tol_lambda:
        return s2, lam2, f2
    if f1 > ocean_topog_smoothing or f2 > ocean_topog_smoothing:
        raise RuntimeError(
            "initial lambdas too large for the secant iteration "
            f"(fractions {f1:.3f}, {f2:.3f} vs target {ocean_topog_smoothing})")
    def secant(l1, fr1, l2, fr2):
        lam = ((fr2 - ocean_topog_smoothing) * l1
               + (ocean_topog_smoothing - fr1) * l2) / (fr2 - fr1)
        if lam < 0:
            raise RuntimeError("secant iteration produced negative lambda")
        return lam

    # alternate secant updates of lambda_2 and lambda_1 (:122-145)
    lam1 = secant(lam1, f1, lam2, f2)
    s1, f1 = regularize_topography(T, surf_field, ocean_mask, lam1)
    for _ in range(itmax_lambda):
        if abs(ocean_topog_smoothing - f1) < tol_lambda:
            return s1, lam1, f1
        lam2 = secant(lam1, f1, lam2, f2)
        s2, f2 = regularize_topography(T, surf_field, ocean_mask, lam2)
        if abs(ocean_topog_smoothing - f2) < tol_lambda:
            return s2, lam2, f2
        lam1 = secant(lam1, f1, lam2, f2)
        s1, f1 = regularize_topography(T, surf_field, ocean_mask, lam1)
    raise RuntimeError("cannot converge on lambda")
