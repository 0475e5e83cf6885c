"""Hybrid sigma-pressure vertical coordinate definition (port of
isca_tpu/dycore/vert_coordinate.py; numpy only, like the original).

Reference: src/atmos_spectral/init/vert_coordinate.F90:89-310. Produces the
half-level coefficients (pk, bk) with p_half(k) = pk(k) + bk(k) * ps,
k = 0..num_levels (index 0 = model top), as plain numpy arrays (init-time only).

Options (same names/semantics as vert_coord_option):
  'even_sigma'    : bk = k/N
  'uneven_sigma'  : smooth stretch bk = exp(-z * scale_heights),
                    z = surf_res*zeta + (1-surf_res)*zeta^exponent, zeta = 1-k/N
  'hybrid'        : pure pressure above p_press blending to sigma below p_sigma
  'input'         : user-provided pk/bk arrays
  'mcm'           : fixed 14-level Manabe-Climate-Model sigma ladder
  'v197'          : fixed 18-level N30L18 sigma ladder
"""

from __future__ import annotations

import numpy as np


def even_sigma(num_levels: int) -> tuple[np.ndarray, np.ndarray]:
    b = np.arange(num_levels + 1, dtype=np.float64) / num_levels
    return np.zeros(num_levels + 1), b


def uneven_sigma(
    num_levels: int,
    scale_heights: float = 4.0,
    surf_res: float = 1.0,
    exponent: float = 2.0,
    zero_top: bool = True,
) -> tuple[np.ndarray, np.ndarray]:
    k = np.arange(num_levels + 1, dtype=np.float64)
    zeta = 1.0 - k / num_levels
    z = surf_res * zeta + (1.0 - surf_res) * zeta**exponent
    b = np.exp(-z * scale_heights)
    b[-1] = 1.0
    if zero_top:
        b[0] = 0.0
    return np.zeros(num_levels + 1), b


def hybrid(
    num_levels: int,
    p_press: float = 10000.0,
    p_sigma: float = 30000.0,
    p_ref: float = 101325.0,
    scale_heights: float = 4.0,
    surf_res: float = 1.0,
    exponent: float = 2.0,
) -> tuple[np.ndarray, np.ndarray]:
    """Pure pressure above p_press, pure sigma below p_sigma, smooth blend between.

    (vert_coordinate.F90:124-186: sigma levels from the uneven stretch, converted
    to a pressure profile at p_ref, then partitioned between pk and bk.)
    """
    _, b_sig = uneven_sigma(num_levels, scale_heights, surf_res, exponent, zero_top=False)
    p = b_sig * p_ref
    # weight: 1 = pure sigma, 0 = pure pressure
    w = (p - p_press) / (p_sigma - p_press)
    w = np.clip(w, 0.0, 1.0) ** 2  # smooth quadratic blend
    bk = b_sig * w
    pk = p - bk * p_ref
    pk[0] = max(pk[0], 0.0)
    pk[-1] = 0.0
    bk[-1] = 1.0
    return pk, bk


# Fixed historical sigma ladders (vert_coordinate.F90:276-311): 'mcm' is the
# 14-level Manabe Climate Model ladder, 'v197' the 18-level N30L18 one.
_MCM_B = np.array(
    [0.0, 0.03, 0.0707, 0.1311, 0.2102, 0.3036, 0.4062, 0.5138, 0.6226,
     0.7284, 0.8255, 0.9066, 0.9640, 0.9933, 1.0])
_V197_B = np.array(
    [0.0, 0.0089163, 0.0342936, 0.0740741, 0.1262002, 0.1886145, 0.2592592,
     0.3360768, 0.4170096, 0.5000000, 0.5829904, 0.6639231, 0.7407407,
     0.8113854, 0.8737997, 0.9259259, 0.9657064, 0.9910837, 1.0])


def compute_vert_coord(option: str = "even_sigma", num_levels: int = 18, **kw):
    if option == "even_sigma":
        return even_sigma(num_levels)
    if option == "uneven_sigma":
        return uneven_sigma(num_levels, **kw)
    if option == "hybrid":
        return hybrid(num_levels, **kw)
    if option == "input":
        return np.asarray(kw["pk"], np.float64), np.asarray(kw["bk"], np.float64)
    if option == "mcm":
        if num_levels != _MCM_B.size - 1:
            raise ValueError(f"vert_coord_option='mcm' requires num_levels="
                             f"{_MCM_B.size - 1}, got {num_levels}")
        return np.zeros_like(_MCM_B), _MCM_B.copy()
    if option == "v197":
        if num_levels != _V197_B.size - 1:
            raise ValueError(f"vert_coord_option='v197' requires num_levels="
                             f"{_V197_B.size - 1}, got {num_levels}")
        return np.zeros_like(_V197_B), _V197_B.copy()
    raise ValueError(f"invalid vert_coord_option: {option}")
