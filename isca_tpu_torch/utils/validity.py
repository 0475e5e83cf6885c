"""Prognostic-field validity guard.

Port of isca_tpu/utils/validity.py: `ValidityReport`, `check_range` and
`describe_violation` (reference: spectral_dynamics.F90:940-1005, the
per-step check of the new grid temperature against `valid_range_t`, and
its located-extremum printout). The check is a pair of reductions on the
device; the host reads a few scalars when it asks. `Experiment.run` flushes
the diagnostics before it raises, the reference's flush-then-abort contract.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class ValidityReport(NamedTuple):
    """Result of a range check: 0-d tensors, and the multi-indices of the
    extrema as (ndim,) int32 tensors."""
    ok: torch.Tensor        # () bool: field entirely inside [lo, hi]
    vmin: torch.Tensor      # () extrema
    vmax: torch.Tensor
    min_idx: torch.Tensor   # (ndim,) int32 multi-index of the minimum
    max_idx: torch.Tensor


def check_range(field: torch.Tensor, lo: float, hi: float, mesh=None) -> ValidityReport:
    """Range-check a field. A NaN is the extremum it stands at (argmin and
    argmax propagate it), so a field holding one is never ok. On a mesh
    (the field is a rank's block) the extrema and `ok` are the whole
    field's, all_reduced; the indices stay within the rank's block."""
    flat = field.reshape(-1)
    imin = torch.argmin(flat)
    imax = torch.argmax(flat)
    vmin = flat[imin]
    vmax = flat[imax]
    if mesh is not None:
        vmin, vmax = mesh.all_reduce(vmin, "min"), mesh.all_reduce(vmax, "max")
    unravel = lambda i: torch.stack(torch.unravel_index(i, field.shape)).to(torch.int32)
    return ValidityReport(
        ok=(vmin >= lo) & (vmax <= hi),
        vmin=vmin, vmax=vmax,
        min_idx=unravel(imin), max_idx=unravel(imax),
    )


def describe_violation(name: str, report: ValidityReport, lo: float, hi: float,
                       lats=None, lons=None, level_axis: int | None = 0) -> str:
    """Render the reference's located-extremum printout
    (spectral_dynamics.F90:949-963: 'temperatures out of valid range' with
    lon/lat/level indices and degrees). lats/lons in radians if given."""
    vmin, vmax = float(report.vmin), float(report.vmax)
    lines = [f"{name} out of valid range [{lo}, {hi}]: "
             f"min={vmin:.3f}, max={vmax:.3f}"]
    for label, val, idx, bad in (("minimum", vmin, report.min_idx, vmin < lo),
                                 ("maximum", vmax, report.max_idx, vmax > hi)):
        if not bad:
            continue
        idx = torch.as_tensor(idx).cpu().numpy()
        loc = f"index {tuple(int(i) for i in idx)}"
        if lats is not None and lons is not None and idx.size >= 2:
            off = 1 if (level_axis == 0 and idx.size >= 3) else 0
            j, k = int(idx[off]), int(idx[off + 1])
            loc += (f" = (lat {np.degrees(float(lats[j])):.2f}deg, "
                    f"lon {np.degrees(float(lons[k])):.2f}deg")
            if off:
                loc += f", level {int(idx[0])}"
            loc += ")"
        lines.append(f"  {label} {val:.3f} at {loc}")
    return "\n".join(lines)
