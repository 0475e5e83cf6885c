"""Gaussian grid and associated-Legendre table construction (host-side, float64).

Port of isca_tpu/spectral/gauss.py, kept as the port's own numpy copy
(reference: gauss_and_legendre.F90, Newton iteration for Gauss-Legendre
nodes/weights and the associated Legendre recurrences; the table setup in
spherical_fourier.F90:376-431). The tables are small, precision-critical and
built once at init, so they are built with numpy on the host.

Conventions
-----------
* Latitudes are the Gauss-Legendre nodes mu_j = sin(lat_j), ordered south -> north.
* Weights w_j satisfy sum_j w_j = 2.
* P[j, m, n] holds the 4pi-fully-normalized associated Legendre function
  Pbar_n^m(mu_j) (no Condon-Shortley phase), zero for n < m, satisfying

      (1/2) * sum_j  Pbar_n^m(mu_j) Pbar_n'^m(mu_j) w_j = delta_{n n'}

  so that a real field f(lambda, mu) = sum_{m,n} Re[ s_{mn} Pbar_n^m(mu) e^{i m lambda} ]
  (with the m=0 term counted once and m>0 terms twice via conjugate symmetry) has
  global area-weighted mean equal to s_{00}  (Pbar_0^0 = 1).
* eps[m, n] = sqrt((n^2 - m^2) / (4 n^2 - 1)) is the standard recurrence coupling
  coefficient used for the meridional-derivative / wind relations
  (reference: spherical.F90 coef_dym/coef_dyp/coef_uvm/coef_uvp tables).
"""

from __future__ import annotations

import numpy as np


def gauss_legendre(nlat: int) -> tuple[np.ndarray, np.ndarray]:
    """Gauss-Legendre nodes (ascending, south->north) and weights (sum to 2)."""
    x, w = np.polynomial.legendre.leggauss(nlat)
    order = np.argsort(x)
    return x[order], w[order]


def legendre_table(mu: np.ndarray, num_fourier: int, num_spherical: int) -> np.ndarray:
    """Fully-normalized associated Legendre functions Pbar_n^m(mu).

    Returns array of shape (len(mu), num_fourier + 1, num_spherical + 1) indexed
    [j, m, n] with total wavenumber n; entries with n < m are zero.

    Stable normalized recurrences:
      Pbar_0^0        = 1
      Pbar_m^m        = sqrt((2m+1)/(2m)) * cos(phi) * Pbar_{m-1}^{m-1}
      Pbar_{m+1}^m    = sqrt(2m+3) * mu * Pbar_m^m
      Pbar_n^m        = a_nm * (mu * Pbar_{n-1}^m - b_nm * Pbar_{n-2}^m)
        a_nm = sqrt((4n^2-1)/(n^2-m^2))
        b_nm = sqrt(((n-1)^2-m^2)/(4(n-1)^2-1))
    """
    mu = np.asarray(mu, dtype=np.float64)
    nj = mu.shape[0]
    M, N = num_fourier, num_spherical
    sintheta = np.sqrt(1.0 - mu * mu)  # cos(latitude)
    P = np.zeros((nj, M + 1, N + 1), dtype=np.float64)

    # Diagonal n == m.
    pmm = np.ones(nj, dtype=np.float64)
    for m in range(0, min(M, N) + 1):
        if m > 0:
            pmm = pmm * sintheta * np.sqrt((2.0 * m + 1.0) / (2.0 * m))
        P[:, m, m] = pmm
    # Off-diagonal upward recurrence in n.
    for m in range(0, M + 1):
        if m + 1 <= N:
            P[:, m, m + 1] = np.sqrt(2.0 * m + 3.0) * mu * P[:, m, m]
        for n in range(m + 2, N + 1):
            a = np.sqrt((4.0 * n * n - 1.0) / (n * n - m * m))
            b = np.sqrt(((n - 1.0) ** 2 - m * m) / (4.0 * (n - 1.0) ** 2 - 1.0))
            P[:, m, n] = a * (mu * P[:, m, n - 1] - b * P[:, m, n - 2])
    return P


def epsilon_table(num_fourier: int, num_spherical: int) -> np.ndarray:
    """eps[m, n] = sqrt((n^2 - m^2)/(4 n^2 - 1)), shape (M+1, N+2); eps[:, 0] = 0.

    One extra n row (n = num_spherical + 1) is provided so n+1 lookups at the top
    retained row never index out of bounds.
    """
    M, N = num_fourier, num_spherical
    m = np.arange(M + 1, dtype=np.float64)[:, None]
    n = np.arange(N + 2, dtype=np.float64)[None, :]
    num = n * n - m * m
    den = 4.0 * n * n - 1.0
    eps = np.sqrt(np.maximum(num, 0.0) / np.where(den == 0.0, 1.0, den))
    eps[:, 0] = 0.0
    return eps
