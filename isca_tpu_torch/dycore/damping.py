"""Spectral hyperdiffusion (del^2k) with optional sponges, applied implicitly.

Port of isca_tpu/dycore/damping.py (reference:
src/atmos_spectral/model/spectral_damping.F90:56-331). The damping rate d(m,n)
is precomputed per mode; each step the tendency is corrected implicitly
against the *previous* time level:

    tend' = (tend - d * x_prev) / (1 + d * delta_t)

Options (same semantics as the reference namelist):
  * 'resolution_dependent' (default): d = coeff * (lam/lam_T)^order, lam = n(n+1)/a^2
    normalized by the highest retained total wavenumber T.
  * 'resolution_independent': d = coeff * lam^order.
  * 'exponential_cutoff' (Smith et al. 2002): d = ((sqrt(lam)-sqrt(lam_c)) /
    (sqrt(lam_T)-sqrt(lam_c)))^order above the cutoff wavenumber, 0 below; the
    effective rate is rescaled as (exp(log(dt*coeff+1)*d)-1)/dt at apply time.
  * damping_coeff_r: additional uniform linear drag.

Top-of-model sponges (spectral_damping.F90:230-288): an eddy sponge (m != 0)
plus separate zonal-mean sponges for the u-bearing (vor) and v-bearing (div)
fields (m == 0), Laplacian-weighted and applied to the top model level only,
folded into per-field top-level rate tables.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from isca_tpu_torch.spectral.transforms import SphericalTransforms


@dataclasses.dataclass(frozen=True)
class SpectralDamping:
    rate: torch.Tensor        # (M+1, N+2) damping rate d(m,n) [1/s] (exponent if exponential)
    sponge_vor: torch.Tensor  # (M+1, N+2) top-level sponge rate for vorticity
    sponge_div: torch.Tensor  # (M+1, N+2) top-level sponge rate for divergence
    exponential: bool
    coeff: float
    has_sponge: bool


def make_damping(
    T: SphericalTransforms,
    damping_coeff: float = 1.15740741e-4,
    damping_order: int = 2,
    damping_option: str = "resolution_dependent",
    cutoff_wn: int = 15,
    eddy_sponge_coeff: float = 0.0,
    zmu_sponge_coeff: float = 0.0,
    zmv_sponge_coeff: float = 0.0,
    damping_coeff_r: float = 0.0,
) -> SpectralDamping:
    M, N2 = T.num_fourier, T.num_spherical + 1
    a2 = T.radius * T.radius
    n = np.arange(N2, dtype=np.float64)
    lam = n * (n + 1.0) / a2                      # positive Laplacian eigenvalues
    # normalize at the largest retained total wavenumber: = truncation for
    # triangular; num_spherical-1 = fourier_inc*M + T for rhomboidal
    # (spectral_dynamics.F90:430-433 num_total_wavenumbers)
    n_tot = T.num_spherical - 1
    lam_T = n_tot * (n_tot + 1.0) / a2
    lam2d = np.broadcast_to(lam, (M + 1, N2)).copy()

    exponential = damping_option == "exponential_cutoff"
    if damping_option == "resolution_dependent":
        rate = damping_coeff * (lam2d / lam_T) ** damping_order
    elif damping_option == "resolution_independent":
        rate = damping_coeff * lam2d**damping_order
    elif exponential:
        lam_c = cutoff_wn * (cutoff_wn + 1.0) / a2
        x = (np.sqrt(lam2d) - np.sqrt(lam_c)) / (np.sqrt(lam_T) - np.sqrt(lam_c))
        rate = np.where(lam2d > lam_c, x**damping_order, 0.0)
    else:
        raise ValueError(f"invalid damping_option: {damping_option}")
    if not exponential:
        rate = rate + damping_coeff_r

    eddy = eddy_sponge_coeff * lam2d
    eddy[0, :] = 0.0
    zm_u = np.zeros_like(lam2d)
    zm_u[0, :] = zmu_sponge_coeff * lam
    zm_v = np.zeros_like(lam2d)
    zm_v[0, :] = zmv_sponge_coeff * lam

    # on a mesh: this rank's m rows of each (M+1, N+2) table
    f = lambda x: torch.as_tensor(T.local_m(x)).to(device=T.device, dtype=T.dtype)
    return SpectralDamping(
        rate=f(rate),
        sponge_vor=f(eddy + zm_u),
        sponge_div=f(eddy + zm_v),
        exponential=exponential,
        coeff=float(damping_coeff),
        has_sponge=bool(
            eddy_sponge_coeff != 0.0 or zmu_sponge_coeff != 0.0 or zmv_sponge_coeff != 0.0
        ),
    )


def apply_damping(D: SpectralDamping, x_prev: torch.Tensor, tend: torch.Tensor,
                  delta_t: float) -> torch.Tensor:
    """Implicit hyperdiffusion correction of a spectral tendency."""
    if D.exponential:
        d = (torch.exp(math.log(delta_t * D.coeff + 1.0) * D.rate) - 1.0) / delta_t
    else:
        d = D.rate
    return (tend - d * x_prev) / (1.0 + d * delta_t)


def apply_top_sponge(D: SpectralDamping, x_prev: torch.Tensor, tend: torch.Tensor,
                     delta_t: float, field: str) -> torch.Tensor:
    """Top-level (k = 0) sponge for 'vor' or 'div' on (nlev, m, n) tensors;
    out of place (the input tendency is not written)."""
    if not D.has_sponge:
        return tend
    sponge = D.sponge_vor if field == "vor" else D.sponge_div
    top = (tend[0] - sponge * x_prev[0]) / (1.0 + sponge * delta_t)
    return torch.cat([top[None], tend[1:]], dim=0)
