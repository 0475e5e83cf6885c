"""Held-Suarez dry primitive-equation model (the reference's `held_suarez.x`).

Port of isca_tpu/models/dry.py: the spectral dycore
(isca_tpu_torch.dycore.primitive) with Held-Suarez forcing evaluated at the
`previous` time level (reference: the solo atmosphere.F90:292-330).
A run is a Python loop of eager steps. With PrimitiveConfig(mesh=...) every
rank steps its own blocks (dycore.primitive); the state, initial_state()
included, is the rank's blocks, and the diagnostics' means and extrema are
global.
"""

from __future__ import annotations

import dataclasses

import torch

from isca_tpu_torch.dycore.primitive import PrimitiveConfig, PrimitiveCore, PrimitiveState
from isca_tpu_torch.physics.hs_forcing import HSForcing, HSForcingConfig
from isca_tpu_torch.spectral import transforms as tr


@dataclasses.dataclass(frozen=True)
class HeldSuarezConfig:
    core: PrimitiveConfig = PrimitiveConfig()
    forcing: HSForcingConfig = HSForcingConfig()


class HeldSuarezModel:
    def __init__(self, config: HeldSuarezConfig = HeldSuarezConfig(), device=None):
        """device: None runs on CUDA (and raises without it); "cpu" on the CPU."""
        self.config = config
        self.core = PrimitiveCore(config.core, device=device)
        self.device = self.core.device
        self.forcing = HSForcing(config.forcing, self.core.T.lats)
        self.surf_geopotential = torch.zeros(self.core.T.grid_shape, dtype=config.core.dtype,
                                             device=self.device)

    def initial_state(self) -> PrimitiveState:
        return self.core.cold_start(self.surf_geopotential)

    # valid_range_t guard (spectral_dynamics.F90:940-1005)
    validity_name = "temperature"

    @property
    def validity_range(self):
        return self.config.core.valid_range_t

    def validity(self, state: PrimitiveState):
        return self.core.validity(state)

    def step(self, state: PrimitiveState, first: bool = False) -> PrimitiveState:
        # pressures at `current`, prognostic fields at `previous` (reference order)
        _, _, p_full, _ = self.core.pressure_variables(state.psg.curr)
        phys = self.forcing(state.ug.prev, state.vg.prev, state.tg.prev, p_full,
                            state.psg.curr)
        return self.core.dynamics_step(state, phys, self.surf_geopotential, first=first)

    def run(self, state: PrimitiveState, num_steps: int, first: bool = True) -> PrimitiveState:
        for i in range(num_steps):
            state = self.step(state, first=first and i == 0)
        return state

    def diag_fields(self, state: PrimitiveState, extended: bool = False) -> dict:
        """Standard 'dynamics' module diagnostic fields (SURVEY.md B.2).

        extended=True adds heights/pressures/slp/wspd, eddy covariance
        products, tracer fluxes, EKE/vort_norm (spectral_diagnostics set)."""
        if extended:
            return self.core.spectral_diagnostics(state, self.surf_geopotential)
        return {
            "ps": state.psg.curr,
            "ucomp": state.ug.curr,
            "vcomp": state.vg.curr,
            "temp": state.tg.curr,
            "vor": state.vorg.curr,
            "div": state.divg.curr,
            "omega": state.wg_full,
        }

    def diagnostics(self, state: PrimitiveState) -> dict:
        T = self.core.T
        u, v, t = state.ug.curr, state.vg.curr, state.tg.curr
        return {
            "mean_ps": tr.area_weighted_mean(T, state.psg.curr),
            "mean_T": tr.area_weighted_mean(T, t.mean(dim=0)),
            "tmin": tr.grid_min(T, t),
            "tmax": tr.grid_max(T, t),
            "umax": tr.grid_max(T, torch.abs(u)),
            "u_zonal": u.mean(dim=2),
            "t_zonal": t.mean(dim=2),
            "energy": self.core.mass_weighted_integral(
                0.5 * (u**2 + v**2) + self.core.C.cp_air * t, state.psg.curr),
        }
