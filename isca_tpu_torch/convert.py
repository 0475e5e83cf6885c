"""Carries a column-model state between isca_tpu and isca_tpu_torch.

A state travels as a dict of numpy arrays, so neither package imports the
other: `t_prev`, `t_curr`, `q_prev`, `q_curr`, `u_prev`, `u_curr`, `v_prev`,
`v_curr` (lat, lon, L), `t_surf` (lat, lon) and `time_seconds` (0-d). The
same dict built from an isca_tpu ColumnState (np.asarray of each leaf) starts
both packages from identical state.
"""

from __future__ import annotations

import numpy as np
import torch

from isca_tpu_torch import resolve_device
from isca_tpu_torch.dycore.time_integration import TwoLevel
from isca_tpu_torch.models.column import ColumnState

PROGNOSTIC = ("t", "q", "u", "v")
STATE_KEYS = tuple(f"{n}_{lvl}" for n in PROGNOSTIC for lvl in ("prev", "curr")) + (
    "t_surf", "time_seconds")


def column_state_from_numpy(d, dtype=torch.float32, device=None) -> ColumnState:
    """A ColumnState on `device` in `dtype`; time_seconds stays float32."""
    device = resolve_device(device)
    missing = set(STATE_KEYS) - set(d)
    if missing:
        raise KeyError(f"column state is missing {sorted(missing)}")
    as_t = lambda a, dt=dtype: torch.as_tensor(np.asarray(a)).to(device, dt)
    two = lambda n: TwoLevel(as_t(d[f"{n}_prev"]), as_t(d[f"{n}_curr"]))
    return ColumnState(
        t=two("t"), q=two("q"), u=two("u"), v=two("v"),
        t_surf=as_t(d["t_surf"]),
        time_seconds=as_t(d["time_seconds"], torch.float32))


def column_state_to_numpy(state: ColumnState) -> dict:
    """The state as a dict of numpy arrays (keys STATE_KEYS)."""
    out = {}
    for n in PROGNOSTIC:
        pair = getattr(state, n)
        out[f"{n}_prev"] = pair.prev.detach().cpu().numpy()
        out[f"{n}_curr"] = pair.curr.detach().cpu().numpy()
    out["t_surf"] = state.t_surf.detach().cpu().numpy()
    out["time_seconds"] = state.time_seconds.detach().cpu().numpy()
    return out
