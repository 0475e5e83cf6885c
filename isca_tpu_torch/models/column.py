"""Single-column (or lat-lon grid of independent columns) physics model.

Port of isca_tpu/models/column.py (reference: src/atmos_column/column.F90 +
the COLUMN_MODEL variant of the driver, atmosphere.F90:39-53): a no-op
dynamics on a (possibly 1x1) grid replaces the spectral dynamical core; the
same leapfrog time levels and the moist physics stack run unchanged. All
columns are independent, so they batch over the (lat, lon) axes.
"""

from __future__ import annotations

import dataclasses
import math
from types import SimpleNamespace
from typing import Any

import numpy as np
import torch

from isca_tpu_torch import resolve_device
from isca_tpu_torch.constants import Constants, EARTH
from isca_tpu_torch.dycore import press_geopot as pgm
from isca_tpu_torch.dycore import vert_coordinate as vc
from isca_tpu_torch.dycore.time_integration import TwoLevel, leapfrog
from isca_tpu_torch.physics.moist_driver import MoistPhysics, MoistPhysicsConfig
from isca_tpu_torch.utils.validity import check_range


@dataclasses.dataclass(frozen=True)
class ColumnConfig:
    nlat: int = 1
    nlon: int = 1
    lat_deg: float = 0.0           # latitude of the columns
    num_levels: int = 25
    dt: float = 600.0
    vert_coord_option: str = "uneven_sigma"
    vert_coord_kwargs: tuple = (("scale_heights", 6.0), ("surf_res", 0.5), ("exponent", 7.5))
    robert_coeff: float = 0.03
    initial_temperature: float = 264.0
    initial_sphum: float = 2.0e-6
    t_surf_init: float = 285.0
    ps: float = 1.0e5
    valid_range_t: tuple = (100.0, 500.0)
    physics: MoistPhysicsConfig = MoistPhysicsConfig()
    constants: Constants = EARTH
    dtype: Any = torch.float32


@dataclasses.dataclass
class ColumnState:
    t: TwoLevel      # (lat, lon, L) level-last
    q: TwoLevel
    u: TwoLevel
    v: TwoLevel
    t_surf: torch.Tensor
    time_seconds: torch.Tensor   # 0-d float32 whatever the model dtype


class ColumnModel:
    def __init__(self, config: ColumnConfig = ColumnConfig(), device=None, mesh=None):
        """device: None runs on CUDA; "cpu" on the CPU. mesh: the column
        model is not sharded yet, and a mesh raises NotImplementedError."""
        if mesh is not None:
            raise NotImplementedError("the column model is not sharded yet")
        self.config = c = config
        self.device = resolve_device(device)
        self.C = c.constants
        pk, bk = vc.compute_vert_coord(c.vert_coord_option, c.num_levels,
                                       **dict(c.vert_coord_kwargs))
        as_t = lambda a: torch.as_tensor(a, device=self.device).to(c.dtype)
        self.pk, self.bk = as_t(pk), as_t(bk)
        self.top_is_zero = bool(pk[0] == 0.0 and bk[0] == 0.0)
        lats = as_t(np.deg2rad(np.full(c.nlat, c.lat_deg)))
        lons = as_t(np.zeros(c.nlon))
        self.physics = MoistPhysics(c.physics, lats, lons)
        # minimal grid info for the Experiment/diag layer (column_grid role)
        self.T = SimpleNamespace(lats=lats, lons=lons, grid_shape=(c.nlat, c.nlon))
        ps = self._full((c.nlat, c.nlon), c.ps)
        ph, lph, pf, lpf = pgm.pressure_variables(self.pk, self.bk, ps, self.top_is_zero)
        self.p_half, self.p_full = ph, pf
        self.ln_p_half, self.ln_p_full = lph, lpf

    # valid_range_t guard (column variant; level-last layout)
    validity_name = "temperature"

    @property
    def validity_range(self):
        return self.config.valid_range_t

    def validity(self, state: ColumnState):
        lo, hi = self.config.valid_range_t
        return check_range(state.t.curr, lo, hi)

    def _full(self, shape, value, dtype=None):
        return torch.full(shape, value, dtype=dtype or self.config.dtype,
                          device=self.device)

    def initial_state(self) -> ColumnState:
        c = self.config
        shape = (c.nlat, c.nlon, c.num_levels)
        two = lambda x: TwoLevel(x, x.clone())
        return ColumnState(
            t=two(self._full(shape, c.initial_temperature)),
            q=two(self._full(shape, c.initial_sphum)),
            u=two(self._full(shape, 0.0)),
            v=two(self._full(shape, 0.0)),
            t_surf=self._full((c.nlat, c.nlon), c.t_surf_init),
            time_seconds=self._full((), 0.0, torch.float32),
        )

    def step(self, state: ColumnState, first: bool = False) -> ColumnState:
        c, C = self.config, self.C
        delta_t = c.dt if first else 2.0 * c.dt
        geo_f, geo_h = pgm.compute_geopotential(
            C.rdgas, state.t.curr, self.ln_p_half, self.ln_p_full,
            self._full((c.nlat, c.nlon), 0.0), self.top_is_zero,
            p_half=self.p_half)
        # float32 time, as in isca_tpu: gmt and time_since_ae round alike
        day = C.seconds_per_day
        gmt = torch.remainder(state.time_seconds, day) / day * 2.0 * math.pi
        tsae = torch.remainder(
            state.time_seconds / C.orbital_period
            - c.physics.radiation.equinox_day, 1.0) * 2.0 * math.pi
        phys = self.physics(
            delta_t, c.dt,
            state.u.prev, state.v.prev, state.t.prev, state.q.prev,
            self.p_full, self.p_half, self.p_full, self.p_half,
            geo_f / C.grav, geo_h / C.grav,
            state.t_surf, gmt=gmt, time_since_ae=tsae)

        # Robert-filtered leapfrog on the columns (no dynamics tendencies)
        lf = lambda x, tend: leapfrog(x, tend, delta_t, c.robert_coeff, 1.0)
        return ColumnState(
            t=lf(state.t, phys.dt_t),
            q=lf(state.q, phys.dt_q),
            u=lf(state.u, phys.dt_u),
            v=lf(state.v, phys.dt_v),
            t_surf=phys.t_surf,
            time_seconds=state.time_seconds + c.dt,
        )

    def run(self, state: ColumnState, num_steps: int, first: bool = True) -> ColumnState:
        for i in range(num_steps):
            state = self.step(state, first=first and i == 0)
        return state

    def diag_fields(self, state: ColumnState) -> dict:
        return {
            "temp": torch.movedim(state.t.curr, -1, 0),
            "sphum": torch.movedim(state.q.curr, -1, 0),
            "t_surf": state.t_surf,
        }
