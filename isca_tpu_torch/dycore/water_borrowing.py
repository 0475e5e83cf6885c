"""Hole filling for negative spectral moisture (water borrowing).

Port of isca_tpu/dycore/water_borrowing.py (reference:
src/atmos_spectral/model/water_borrowing.F90): negative points borrow
mass-weighted water from their 4 neighbors (E/W/up/down), rescaling the
neighbors so column water is conserved. As in isca_tpu, a fixed number of
parallel Jacobi-style passes replaces the reference's sequential
alternating-direction row sweeps (each pass fills holes simultaneously from
the pre-pass neighbor values): the same conservation property, order-free;
trajectories differ from the sequential sweep at the level of the
hole-filling correction itself.
"""

from __future__ import annotations

import torch


def _one_pass(q, dp):
    w = q * dp  # mass-weighted water
    w_e = torch.roll(w, -1, dims=-1)
    w_w = torch.roll(w, 1, dims=-1)
    w_up = torch.cat([torch.zeros_like(w[:1]), w[:-1]], dim=0)
    w_dn = torch.cat([w[1:], torch.zeros_like(w[:1])], dim=0)
    neigh = w_e + w_w + w_up + w_dn
    total = neigh + w
    fill = (w < 0.0) & (total > 0.0)
    ratio = torch.where(fill, total / torch.where(neigh != 0, neigh, 1.0), 1.0)
    # zero the hole; rescale this cell's contribution as a neighbor donor
    q_new = torch.where(fill, 0.0, q)
    # each donor is scaled by the product of ratios of adjacent holes
    scale = torch.ones_like(q)
    for shifted in (
        torch.roll(ratio, 1, dims=-1), torch.roll(ratio, -1, dims=-1),
        torch.cat([ratio[1:], torch.ones_like(ratio[:1])], dim=0),
        torch.cat([torch.ones_like(ratio[:1]), ratio[:-1]], dim=0),
    ):
        scale = scale * shifted
    return torch.where(~fill, q_new * scale, q_new)


def water_borrowing(dt_qg, qg, p_half, delta_t, passes: int = 2):
    """Add hole-filling corrections to dt_qg (level-first (L, lat, lon)).

    qg: the grid moisture being checked (reference passes `previous`).
    """
    dp = p_half[1:] - p_half[:-1]
    q = qg
    for _ in range(passes):
        q = _one_pass(q, dp)
    return dt_qg + (q - qg) / delta_t
