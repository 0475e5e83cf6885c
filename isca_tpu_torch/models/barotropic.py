"""Spectral barotropic vorticity model.

Port of isca_tpu/models/barotropic.py (reference:
src/atmos_spectral_barotropic/{barotropic_dynamics,atmosphere,
barotropic_physics}.F90). The smallest full model loop in the hierarchy:

    d(zeta)/dt = -div[ (zeta + f) V ] + stirring - hyperdiffusion

solved pseudo-spectrally: the nonlinear term is formed in grid space as the
rotational tendency pair (pv*v, -pv*u) and converted with vor_div_from_uv_grid;
time stepping is Robert-filtered leapfrog; damping is implicit del^(2k).
An optional spectral tracer is advected with horizontal_advection
(advective form). A run is a Python loop of eager steps.

BarotropicConfig has no mesh, as isca_tpu's has none (its sharded run gets
its layout from sharded inputs under GSPMD); here the mesh is an explicit
constructor argument, and each rank then steps its latitude band and m
block (spectral.transforms) from initial_state()'s blocks.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from isca_tpu_torch.dycore.damping import apply_damping, make_damping
from isca_tpu_torch.dycore.time_integration import TwoLevel, leapfrog
from isca_tpu_torch.physics.stirring import make_stirring, stir
from isca_tpu_torch.spectral import transforms as tr
from isca_tpu_torch.utils import threefry
from isca_tpu_torch.utils.validity import check_range


@dataclasses.dataclass(frozen=True)
class BarotropicConfig:
    resolution: str | int = "T85"
    nlon: int | None = None       # lon_max nml; default from resolution table
    nlat: int | None = None       # lat_max nml
    dt: float = 1200.0
    radius: float = 6371.0e3
    omega: float = 7.292e-5
    robert_coeff: float = 0.04
    raw_filter_coeff: float = 1.0
    damping_option: str = "resolution_dependent"
    damping_order: int = 4
    damping_coeff: float = 1.0e-4
    damping_coeff_r: float = 0.0
    cutoff_wn: int = 30
    initial_zonal_wind: str = "two_jets"   # 'two_jets' | 'zero'
    # initial vorticity eddy perturbation (barotropic_dynamics.F90:~280)
    zeta_0: float = 8.0e-5
    m_0: int = 4
    eddy_width: float = 15.0
    eddy_lat: float = 45.0
    spec_tracer: bool = True
    valid_range_v: tuple[float, float] = (-1.0e3, 1.0e3)
    transform_precision: str = "highest"   # or "high", "default" (spectral/precision.py)
    truncation_shape: str = "triangular"   # or 'rhomboidal'
    fourier_inc: int = 1
    # stirring_nml
    stirring_amplitude: float = 0.0
    stirring_decay_time: float = 2 * 86400.0
    stirring_lat0: float = 45.0
    stirring_lon0: float = 180.0
    stirring_widthy: float = 12.0
    stirring_widthx: float = 45.0
    stirring_B: float = 0.0
    stirring_do_localize: bool = True
    stirring_n_max: int = 15
    stirring_n_min: int = 9
    stirring_m_min: int = 3
    dtype: torch.dtype = torch.float32


@dataclasses.dataclass
class BarotropicState:
    vors: TwoLevel        # spectral vorticity (M+1, N+2) complex, two levels
    u: TwoLevel           # grid winds (nlat, nlon)
    v: TwoLevel
    vorg: TwoLevel        # grid vorticity
    trs: TwoLevel         # spectral tracer (zeros if disabled)
    s_stir: torch.Tensor  # stirring AR(1) state
    rng: torch.Tensor     # uint32[2] threefry key (jax.random.PRNGKey)


def stirring_from_config(T, c):
    """make_stirring from a config's stirring_* fields (barotropic or shallow)."""
    return make_stirring(
        T, dt=c.dt, amplitude=c.stirring_amplitude,
        decay_time=c.stirring_decay_time, lat0=c.stirring_lat0,
        lon0=c.stirring_lon0, widthy=c.stirring_widthy, widthx=c.stirring_widthx,
        B=c.stirring_B, do_localize=c.stirring_do_localize,
        n_total_forcing_max=c.stirring_n_max, n_total_forcing_min=c.stirring_n_min,
        zonal_forcing_min=c.stirring_m_min)


def initial_tracer(lat_deg, grid_shape):
    """The reference's tracer: 1 in the 10-20N band, -1 poleward of 70N."""
    trg = np.zeros(grid_shape)
    trg = np.where((lat_deg > 10.0) & (lat_deg < 20.0), 1.0, trg)
    return np.where(lat_deg > 70.0, -1.0, trg)


class BarotropicModel:
    """Holds the (static) transform tables and config; provides the step."""

    def __init__(self, config: BarotropicConfig = BarotropicConfig(), device=None,
                 mesh=None):
        """device: None runs on CUDA (and raises without it); "cpu" on the CPU.
        mesh: an isca_tpu_torch.parallel.mesh.Mesh shards the model (device
        None is then the mesh's)."""
        self.config = c = config
        self.T = tr.make_transforms(c.resolution, nlon=c.nlon, nlat=c.nlat,
                                    radius=c.radius, dtype=c.dtype,
                                    precision=c.transform_precision,
                                    truncation_shape=c.truncation_shape,
                                    fourier_inc=c.fourier_inc, mesh=mesh, device=device)
        self.device = self.T.device
        self.damping = make_damping(
            self.T, damping_coeff=c.damping_coeff, damping_order=c.damping_order,
            damping_option=c.damping_option, cutoff_wn=c.cutoff_wn,
            damping_coeff_r=c.damping_coeff_r)
        self.stirring = stirring_from_config(self.T, c)
        self.coriolis = tr.coriolis_grid(self.T, c.omega)

    # valid_range_v wind guard
    validity_name = "wind component (0=u, 1=v)"

    @property
    def validity_range(self):
        return self.config.valid_range_v

    def validity(self, state: BarotropicState):
        lo, hi = self.config.valid_range_v
        return check_range(torch.stack([state.u.curr, state.v.curr]), lo, hi,
                           mesh=self.T.mesh)

    def initial_state(self, seed: int = 0) -> BarotropicState:
        c, T = self.config, self.T
        # numpy in the tables' own dtype, as isca_tpu computes from its tables
        coslat, sinlat = T.coslat.cpu().numpy(), T.sinlat.cpu().numpy()
        if c.initial_zonal_wind == "two_jets":
            u1d = 25.0 * coslat - 30.0 * coslat**3 + 300.0 * sinlat**2 * coslat**6
        elif c.initial_zonal_wind == "zero":
            u1d = np.zeros(T.grid_shape[0])
        else:
            raise ValueError(c.initial_zonal_wind)
        u0 = np.broadcast_to(u1d[:, None], T.grid_shape).astype(np.float64)

        # Gaussian eddy perturbation in vorticity at zonal wavenumber m_0
        # (barotropic_dynamics.F90 init: 0.5*zeta_0*cos(lat)*exp(-yy^2)*cos(m_0*lon),
        # yy = (lat - eddy_lat)/eddy_width in degrees).
        lat = np.degrees(T.lats.cpu().numpy())
        lon = T.lons.cpu().numpy()
        yy = (lat - c.eddy_lat) / c.eddy_width
        envelope = 0.5 * coslat * np.exp(-yy * yy)
        pert = c.zeta_0 * envelope[:, None] * np.cos(c.m_0 * lon)[None, :]
        trg = initial_tracer(lat[:, None], T.grid_shape)

        f = lambda x: torch.as_tensor(np.asarray(x)).to(device=self.device, dtype=c.dtype)
        u = f(u0)
        vors, _ = tr.vor_div_from_uv_grid(T, u, torch.zeros_like(u))
        vors = tr.triangular_truncate(T, vors + tr.grid_to_spec(T, f(pert)))
        u, v = tr.uv_grid_from_vor_div(T, vors, torch.zeros_like(vors))
        vorg = tr.spec_to_grid(T, vors)
        trs = tr.grid_to_spec(T, f(trg)) if c.spec_tracer else torch.zeros_like(vors)
        two = lambda x: TwoLevel(x, x)
        return BarotropicState(
            vors=two(vors), u=two(u), v=two(v), vorg=two(vorg), trs=two(trs),
            s_stir=torch.zeros_like(vors), rng=threefry.prng_key(seed, self.device))

    # ------------------------------------------------------------------
    def step(self, state: BarotropicState, first: bool = False) -> BarotropicState:
        """One leapfrog step (out of place). `first` -> forward Euler."""
        c, T = self.config, self.T
        delta_t = c.dt if first else 2.0 * c.dt

        pv = state.vorg.curr + self.coriolis
        dt_vors, _ = tr.vor_div_from_uv_grid(T, pv * state.v.curr, -pv * state.u.curr)
        dt_vors = apply_damping(self.damping, state.vors.prev, dt_vors, delta_t)
        s_stir, rng = stir(self.stirring, T, state.s_stir, state.rng)
        dt_vors = dt_vors + s_stir

        vors = leapfrog(state.vors, dt_vors, delta_t, c.robert_coeff, c.raw_filter_coeff)
        vorg_future = tr.spec_to_grid(T, vors.curr)
        u_future, v_future = tr.uv_grid_from_vor_div(T, vors.curr, torch.zeros_like(vors.curr))

        # spectral tracer: advective-form transport + damping + leapfrog
        if c.spec_tracer:
            adv = tr.horizontal_advection(T, state.trs.curr, state.u.curr, state.v.curr)
            dt_trs = apply_damping(self.damping, state.trs.prev, tr.grid_to_spec(T, adv),
                                   delta_t)
            trs = leapfrog(state.trs, dt_trs, delta_t, c.robert_coeff, c.raw_filter_coeff)
        else:
            trs = state.trs

        advance = lambda old, fut: TwoLevel(old.curr, fut)
        return BarotropicState(
            vors=vors, u=advance(state.u, u_future), v=advance(state.v, v_future),
            vorg=advance(state.vorg, vorg_future), trs=trs, s_stir=s_stir, rng=rng)

    def run(self, state: BarotropicState, num_steps: int, first: bool = True) -> BarotropicState:
        for i in range(num_steps):
            state = self.step(state, first=first and i == 0)
        return state

    def diag_fields(self, state: BarotropicState) -> dict:
        return {"ucomp": state.u.curr, "vcomp": state.v.curr, "vor": state.vorg.curr}

    def diagnostics(self, state: BarotropicState) -> dict:
        T = self.T
        stream = tr.spec_to_grid(T, tr.inverse_laplacian(T, state.vors.prev))
        return {"energy": -tr.area_weighted_mean(T, stream * state.vorg.prev),
                "enstrophy": tr.area_weighted_mean(T, state.vorg.prev * state.vorg.curr),
                "stream": stream}
