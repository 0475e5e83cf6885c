"""Prognostic-field validity guard.

Port of isca_tpu/utils/validity.py's `ValidityReport` and `check_range`
(reference: spectral_dynamics.F90:940-1005, the per-step check of the new
grid temperature against `valid_range_t`). The check is a pair of
reductions on the device; the host reads a few scalars when it asks.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class ValidityReport(NamedTuple):
    """Result of a range check: 0-d tensors, and the multi-indices of the
    extrema as (ndim,) int32 tensors."""
    ok: torch.Tensor        # () bool: field entirely inside [lo, hi]
    vmin: torch.Tensor      # () extrema
    vmax: torch.Tensor
    min_idx: torch.Tensor   # (ndim,) int32 multi-index of the minimum
    max_idx: torch.Tensor


def check_range(field: torch.Tensor, lo: float, hi: float) -> ValidityReport:
    """Range-check a field. A NaN is the extremum it stands at (argmin and
    argmax propagate it), so a field holding one is never ok."""
    flat = field.reshape(-1)
    imin = torch.argmin(flat)
    imax = torch.argmax(flat)
    vmin = flat[imin]
    vmax = flat[imax]
    unravel = lambda i: torch.stack(torch.unravel_index(i, field.shape)).to(torch.int32)
    return ValidityReport(
        ok=(vmin >= lo) & (vmax <= hi),
        vmin=vmin, vmax=vmax,
        min_idx=unravel(imin), max_idx=unravel(imax),
    )
