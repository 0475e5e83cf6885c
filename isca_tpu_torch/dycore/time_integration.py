"""Leapfrog time stepping with the Robert-Asselin-(Williams) filter.

Port of isca_tpu/dycore/time_integration.py (reference:
src/atmos_spectral/model/leapfrog.F90). State is a (prev, curr) pair and each
function returns new tensors.

Plain leapfrog (leapfrog.F90:217-247):
    P      = prev - 2*curr
    future = prev + delta_t * tend
    curr'  = curr + nu*kappa*(P + future)
    fut'   = future + nu*(kappa-1)*(P + future)
  (nu = robert_coeff, kappa = raw_filter_coeff; kappa=1 -> classic Robert-Asselin.)

Two-part split (primitive-equation core): part A applies the (P)-portion and
the forward step; part B adds the (+future)-portion after the global fixers
and the next step's physics have modified the fields.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class TwoLevel(NamedTuple):
    """A prognostic variable at two time levels."""

    prev: torch.Tensor
    curr: torch.Tensor


def leapfrog(x: TwoLevel, tend, delta_t, robert_coeff: float = 0.04,
             raw_coeff: float = 1.0) -> TwoLevel:
    """Filtered leapfrog step: returns (filtered current, future) as the new pair."""
    P = x.prev - 2.0 * x.curr
    future = x.prev + delta_t * tend
    curr = x.curr + robert_coeff * raw_coeff * (P + future)
    future = future + robert_coeff * (raw_coeff - 1.0) * (P + future)
    return TwoLevel(prev=curr, curr=future)


def leapfrog_part_a(x: TwoLevel, tend, delta_t, robert_coeff: float = 0.04,
                    raw_coeff: float = 1.0):
    """Part A: forward step + (prev - 2 curr) filter portion.

    Returns the new (partially-filtered current, future) pair plus the saved
    P = prev - 2*curr needed by part B.
    """
    P = x.prev - 2.0 * x.curr
    future = x.prev + delta_t * tend
    curr = x.curr + robert_coeff * raw_coeff * P
    return TwoLevel(prev=curr, curr=future), P


def leapfrog_part_b(x: TwoLevel, P, robert_coeff: float = 0.04,
                    raw_coeff: float = 1.0) -> TwoLevel:
    """Part B (deferred): completes the filter with the (possibly corrected) future.

    Here x.prev is the partially-filtered 'current' from part A and x.curr the
    future field after global fixers / physics updates.
    """
    curr = x.prev + robert_coeff * raw_coeff * x.curr
    future = x.curr + robert_coeff * (raw_coeff - 1.0) * (P + x.curr)
    return TwoLevel(prev=curr, curr=future)
