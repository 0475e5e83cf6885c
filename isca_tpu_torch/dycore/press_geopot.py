"""Hybrid-coordinate pressure variables and hydrostatic geopotential.

Port of isca_tpu/dycore/press_geopot.py (reference:
src/atmos_spectral/model/press_and_geopot.F90:87-467) on torch tensors.

Level convention: arrays are (..., lev) with index 0 = model top. Half-level
arrays have num_levels+1 entries.

Simmons & Burridge (1981) full-level definition:
    alpha_k     = 1 - p_half(k) * (ln p_half(k+1) - ln p_half(k)) / dp_k
    ln p_full_k = ln p_half(k+1) - alpha_k
with the special case of a p=0 model top: ln p_full(0) = ln p_half(1) - 1.
"""

from __future__ import annotations

import torch


def _dlnp(p_half):
    """ln p(k+1) - ln p(k) as log1p(dp/p(k)): the difference of two O(10)
    logs cancels to O(dp/p), so log1p keeps the error at the ulp of the
    difference (a p=0 top gives log1p(dp/1), unused)."""
    dp = p_half[..., 1:] - p_half[..., :-1]
    lower = p_half[..., :-1]
    safe_lower = torch.where(lower > 0.0, lower, torch.ones_like(lower))
    return dp, torch.log1p(dp / safe_lower)


def pressure_variables(pk, bk, surface_p, top_is_zero: bool,
                       option: str = "simmons_and_burridge"):
    """(p_half, ln_p_half, p_full, ln_p_full) from surface pressure.

    pk, bk: (L+1,) coefficient tensors; surface_p: any shape S.
    Returns tensors of shape S + (L+1,) and S + (L,).

    `option` is vert_difference_option: 'simmons_and_burridge' or 'mcm'
    (full level = arithmetic mean of half pressures).
    """
    ps = surface_p[..., None]
    p_half = pk + bk * ps
    if top_is_zero:
        # avoid log(0) at the top half level; value unused (set to 0)
        safe = torch.cat([torch.ones_like(p_half[..., :1]), p_half[..., 1:]], dim=-1)
        ln_p_half = torch.log(safe)
        ln_p_half = torch.cat(
            [torch.zeros_like(ln_p_half[..., :1]), ln_p_half[..., 1:]], dim=-1)
    else:
        ln_p_half = torch.log(p_half)
    if option == "mcm":
        p_full = 0.5 * (p_half[..., 1:] + p_half[..., :-1])
        return p_half, ln_p_half, p_full, torch.log(p_full)
    if option != "simmons_and_burridge":
        raise ValueError(f"invalid vert_difference_option {option!r}")
    dp, dlnp = _dlnp(p_half)
    alpha = 1.0 - p_half[..., :-1] * dlnp / dp
    ln_p_full = ln_p_half[..., 1:] - alpha
    if top_is_zero:
        # ln_top_level_factor = -1: ln p_full(top) = ln p_half(1) - 1
        top = ln_p_half[..., 1:2] - 1.0
        ln_p_full = torch.cat([top, ln_p_full[..., 1:]], dim=-1)
    p_full = torch.exp(ln_p_full)
    return p_half, ln_p_half, p_full, ln_p_full


def compute_geopotential(rdgas, virtual_t, ln_p_half, ln_p_full, surf_geopotential,
                         top_is_zero: bool, p_half=None):
    """Hydrostatic integration (press_and_geopot.F90:314-359).

    virtual_t: (..., L); ln_p_half: (..., L+1); ln_p_full: (..., L);
    surf_geopotential: (...). Returns (geopot_full (..., L), geopot_half (..., L+1)).
    geopot_half[..., 0] is 0 for a p=0 top (infinite height, unused).
    With p_half given, the log-pressure increments are computed
    cancellation-free via log1p.
    """
    if p_half is not None:
        _, dlnp = _dlnp(p_half)
    else:
        dlnp = ln_p_half[..., 1:] - ln_p_half[..., :-1]
    incr = rdgas * virtual_t * dlnp
    if top_is_zero:
        incr = torch.cat([torch.zeros_like(incr[..., :1]), incr[..., 1:]], dim=-1)
    # geopot_half(k) = surf + sum_{j>k} incr_j  (cumulative from the bottom up)
    rev_csum = torch.flip(torch.cumsum(torch.flip(incr, (-1,)), dim=-1), (-1,))
    geopot_half = torch.cat(
        [rev_csum, torch.zeros_like(rev_csum[..., :1])], dim=-1
    ) + surf_geopotential[..., None]
    geopot_full = geopot_half[..., 1:] + rdgas * virtual_t * (ln_p_half[..., 1:] - ln_p_full)
    return geopot_full, geopot_half


def virtual_temperature(t, q, zvir):
    """T_v = T (1 + (rvgas/rdgas - 1) q)."""
    return t * (1.0 + zvir * q)
