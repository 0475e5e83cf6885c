"""Spectral shallow-water model with semi-implicit gravity waves.

Port of isca_tpu/models/shallow.py (reference:
src/atmos_spectral_shallow/{shallow_dynamics,shallow_physics,
atmosphere}.F90). Prognostics: spectral vorticity, divergence, and geopotential
thickness h (= g*depth, mean h_0). One leapfrog step:

  dt_u += (zeta + f) v ;  dt_v -= (zeta + f) u          (rotational grid terms)
  (dt_vors, dt_divs) = vor_div_from_uv_grid(dt_u, dt_v)
  dt_h = -(V . grad h) - h * div  + physics
  dt_divs -= laplacian( h + deep_geopot + KE )
  semi-implicit gravity-wave correction (scalar per mode, alpha = 1/2):
      with lam = n(n+1)/a^2, mu = xi*delta_t:
      dt_h    += h_0 * (div_curr - div_prev)
      dt_divs += lam * (h_curr - h_prev)
      dt_divs  = (dt_divs + mu lam dt_h) / (1 + mu^2 lam h_0)
      dt_h    -= mu h_0 dt_divs
  implicit hyperdiffusion on (vor, div, h); stirring on vor; leapfrog all.

Physics (shallow_physics.F90): Rayleigh friction on (u, v) and Newtonian
relaxation of h to a localized h_eq bump + ITCZ band, evaluated at `previous`.
A run is a Python loop of eager steps.

ShallowConfig has no mesh, as isca_tpu's has none; as for BarotropicModel,
a mesh is an explicit constructor argument: each rank then steps its
latitude band and m block (spectral.transforms), the deep-flow geopotential
is built on the whole globe and cut to the band, and the stirring draws the
whole field and keeps the rank's m rows.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from isca_tpu_torch.dycore.damping import apply_damping, make_damping
from isca_tpu_torch.dycore.time_integration import TwoLevel, leapfrog
from isca_tpu_torch.models.barotropic import initial_tracer, stirring_from_config
from isca_tpu_torch.physics.stirring import stir
from isca_tpu_torch.spectral import transforms as tr
from isca_tpu_torch.utils import threefry
from isca_tpu_torch.utils.validity import check_range


@dataclasses.dataclass(frozen=True)
class ShallowConfig:
    resolution: str | int = "T85"
    nlon: int | None = None       # lon_max nml; default from resolution table
    nlat: int | None = None       # lat_max nml
    dt: float = 1200.0
    radius: float = 6371.0e3
    omega: float = 7.292e-5
    robert_coeff: float = 0.04
    robert_coeff_tracer: float = 0.04
    raw_filter_coeff: float = 1.0
    damping_option: str = "resolution_dependent"
    damping_order: int = 4
    damping_coeff: float = 1.0e-4
    cutoff_wn: int = 30
    h_0: float = 3.0e4                 # mean geopotential depth g*H [m^2/s^2]
    u_deep_mag: float = 0.0            # deep flow -> bottom geopotential
    n_merid_deep_flow: float = 3.0
    u_upper_mag_init: float = 0.0
    # initial vortex pair options
    add_initial_vortex_pair: bool = False
    add_initial_vortex_as_height: bool = True
    lon_centre_init_cyc: float = 0.0
    lat_centre_init_cyc: float = 60.0
    lon_centre_init_acyc: float = 180.0
    lat_centre_init_acyc: float = 60.0
    init_vortex_radius_deg: float = 5.0
    init_vortex_vor_f: float = 0.5
    init_vortex_h_h_0: float = 0.1
    spec_tracer: bool = True
    valid_range_v: tuple[float, float] = (-1.0e3, 1.0e3)
    transform_precision: str = "highest"   # or "high", "default" (spectral/precision.py)
    truncation_shape: str = "triangular"   # or 'rhomboidal'
    fourier_inc: int = 1
    # physics (shallow_physics_nml); damp times in days if negative like reference
    fric_damp_time: float = -20.0
    therm_damp_time: float = -10.0
    h_amp: float = 2.0e4
    h_lon: float = 90.0
    h_lat: float = 25.0
    h_width: float = 15.0
    h_itcz: float = 1.0e5
    itcz_width: float = 4.0
    physics_on: bool = False
    # stirring
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
class ShallowState:
    vors: TwoLevel
    divs: TwoLevel
    hs: TwoLevel
    u: TwoLevel
    v: TwoLevel
    vorg: TwoLevel
    divg: TwoLevel
    hg: TwoLevel
    trs: TwoLevel
    s_stir: torch.Tensor
    rng: torch.Tensor     # uint32[2] threefry key (jax.random.PRNGKey)


class ShallowModel:
    def __init__(self, config: ShallowConfig = ShallowConfig(), device=None, mesh=None):
        """device: None runs on CUDA (and raises without it); "cpu" on the CPU.
        mesh: an isca_tpu_torch.parallel.mesh.Mesh shards the model (device
        None is then the mesh's)."""
        self.config = c = config
        self.T = T = tr.make_transforms(c.resolution, nlon=c.nlon, nlat=c.nlat,
                                        radius=c.radius, dtype=c.dtype,
                                        precision=c.transform_precision,
                                        truncation_shape=c.truncation_shape,
                                        fourier_inc=c.fourier_inc, mesh=mesh,
                                        device=device)
        self.device = T.device
        self.damping = make_damping(
            T, damping_coeff=c.damping_coeff, damping_order=c.damping_order,
            damping_option=c.damping_option, cutoff_wn=c.cutoff_wn)
        self.stirring = stirring_from_config(T, c)
        self.coriolis = tr.coriolis_grid(T, c.omega)
        f = lambda x: torch.as_tensor(np.array(x)).to(device=self.device, dtype=c.dtype)
        # positive Laplacian eigenvalues lam = n(n+1)/a^2, broadcast over (m, n)
        nv = np.arange(T.num_spherical + 1, dtype=np.float64)
        lam = nv * (nv + 1.0) / (c.radius * c.radius)
        self.lam = f(np.broadcast_to(lam, T.spec_shape))

        # bottom ("deep flow") geopotential (shallow_dynamics_init:114-118),
        # its global mean removed on the whole globe, then this rank's band
        lat_g = tr.global_lats(T).cpu().numpy().astype(np.float64)
        nm = c.n_merid_deep_flow
        dg = (-2.0 * c.omega * c.u_deep_mag * c.radius / (1.0 - nm**2)) * (
            -np.cos(nm * lat_g) * np.cos(lat_g)
            - nm * (np.sin(nm * lat_g) * np.sin(lat_g) - np.sin(nm * np.pi / 4.0 * 2.0))
        )
        dg2d = np.broadcast_to(dg[:, None], (T.nlat, T.nlon)).copy()
        w = tr.gaussian_weights(T).cpu().numpy() / 2.0
        dg2d -= (dg2d.mean(axis=1) * w).sum()
        self.deep_geopot = f(T.local_lat(dg2d))

        # physics equilibrium height field (shallow_physics_init), column-local
        lat_deg = np.degrees(T.lats.cpu().numpy().astype(np.float64))
        lon_deg = np.degrees(T.lons.cpu().numpy())
        xx = (lon_deg[None, :] - c.h_lon) / (c.h_width * 2.0)
        yy = (lat_deg[:, None] - c.h_lat) / c.h_width
        h_eq = c.h_0 + c.h_amp * np.maximum(1e-10, np.exp(-(xx**2 + yy**2)))
        h_eq = h_eq + c.h_itcz * np.exp(-((lat_deg[:, None] / c.itcz_width) ** 2))
        self.h_eq = f(np.broadcast_to(h_eq, T.grid_shape))
        ft = c.fric_damp_time * (-86400.0 if c.fric_damp_time < 0 else 1.0)
        tt = c.therm_damp_time * (-86400.0 if c.therm_damp_time < 0 else 1.0)
        self.kappa_m = 1.0 / ft if ft != 0.0 else 0.0
        self.kappa_t = 1.0 / tt if tt != 0.0 else 0.0

    # valid_range_v wind guard
    validity_name = "wind component (0=u, 1=v)"

    @property
    def validity_range(self):
        return self.config.valid_range_v

    def validity(self, state: ShallowState):
        lo, hi = self.config.valid_range_v
        return check_range(torch.stack([state.u.curr, state.v.curr]), lo, hi,
                           mesh=self.T.mesh)

    def initial_state(self, seed: int = 0) -> ShallowState:
        c, T = self.config, self.T
        lat = T.lats.cpu().numpy().astype(np.float64)
        lat_deg = np.degrees(lat)
        lon_deg = np.degrees(T.lons.cpu().numpy())
        nm = c.n_merid_deep_flow

        hg0 = np.broadcast_to(c.h_0 - self.deep_geopot.cpu().numpy().astype(np.float64),
                              T.grid_shape).copy()
        vor0 = np.broadcast_to(
            (-(c.u_upper_mag_init * nm) / c.radius) * np.sin(lat)[:, None], T.grid_shape
        ).copy()

        if c.add_initial_vortex_pair:
            for (lon0, lat0, sign) in (
                (c.lon_centre_init_cyc, c.lat_centre_init_cyc, +1.0),
                (c.lon_centre_init_acyc, c.lat_centre_init_acyc, -1.0),
            ):
                dlon2 = np.minimum((lon_deg - lon0) ** 2, (lon_deg - lon0 - 360.0) ** 2)
                r = np.sqrt(dlon2[None, :] + (lat_deg[:, None] - lat0) ** 2) / c.init_vortex_radius_deg
                if c.add_initial_vortex_as_height:
                    hg0 += -sign * c.init_vortex_h_h_0 * c.h_0 * np.exp(-(r**2))
                else:
                    vor0 = np.where(r < 1.0, sign * c.init_vortex_vor_f * 2.0 * c.omega, vor0)
        trg = initial_tracer(lat_deg[:, None], T.grid_shape)

        f = lambda x: torch.as_tensor(np.asarray(x)).to(device=self.device, dtype=c.dtype)
        vors = tr.grid_to_spec(T, f(vor0))
        hs = tr.grid_to_spec(T, f(hg0))
        zeros = torch.zeros_like(vors)
        u, v = tr.uv_grid_from_vor_div(T, vors, zeros)
        trs = tr.grid_to_spec(T, f(trg)) if c.spec_tracer else zeros
        two = lambda x: TwoLevel(x, x)
        return ShallowState(
            vors=two(vors), divs=two(zeros), hs=two(hs), u=two(u), v=two(v),
            vorg=two(tr.spec_to_grid(T, vors)), divg=two(tr.spec_to_grid(T, zeros)),
            hg=two(tr.spec_to_grid(T, hs)), trs=two(trs),
            s_stir=zeros, rng=threefry.prng_key(seed, self.device))

    # ------------------------------------------------------------------
    def step(self, state: ShallowState, first: bool = False) -> ShallowState:
        c, T = self.config, self.T
        delta_t = c.dt if first else 2.0 * c.dt
        lam = self.lam

        # rotational terms, plus the physics tendencies at `previous`
        abs_vor = state.vorg.curr + self.coriolis
        dt_u = abs_vor * state.v.curr
        dt_v = -(abs_vor * state.u.curr)
        dt_h = tr.horizontal_advection(T, state.hs.curr, state.u.curr, state.v.curr)
        if c.physics_on:
            dt_u = -self.kappa_m * state.u.prev + dt_u
            dt_v = -self.kappa_m * state.v.prev + dt_v
            dt_h = -self.kappa_t * (state.hg.prev - self.h_eq) + dt_h
        dt_vors, dt_divs = tr.vor_div_from_uv_grid(T, dt_u, dt_v)

        # thickness equation
        dt_hs = tr.grid_to_spec(T, dt_h - state.hg.curr * state.divg.curr)

        # energy + geopotential gradient term in divergence equation
        bg = state.hg.curr + self.deep_geopot + 0.5 * (state.u.curr**2 + state.v.curr**2)
        dt_divs = dt_divs - tr.laplacian(T, tr.grid_to_spec(T, bg))

        # semi-implicit gravity-wave correction (shallow_dynamics.F90:493-514)
        mu = 0.5 * delta_t
        dt_hs = dt_hs + c.h_0 * (state.divs.curr - state.divs.prev)
        dt_divs = dt_divs - lam * (state.hs.curr - state.hs.prev)
        dt_divs = (dt_divs + mu * lam * dt_hs) / (1.0 + mu * mu * lam * c.h_0)
        dt_hs = dt_hs - mu * c.h_0 * dt_divs

        dt_vors = apply_damping(self.damping, state.vors.prev, dt_vors, delta_t)
        dt_divs = apply_damping(self.damping, state.divs.prev, dt_divs, delta_t)
        dt_hs = apply_damping(self.damping, state.hs.prev, dt_hs, delta_t)

        s_stir, rng = stir(self.stirring, T, state.s_stir, state.rng)
        dt_vors = dt_vors + s_stir

        lf = lambda x, t, rc=c.robert_coeff: leapfrog(x, t, delta_t, rc, c.raw_filter_coeff)
        vors, divs, hs = lf(state.vors, dt_vors), lf(state.divs, dt_divs), lf(state.hs, dt_hs)

        u_f, v_f = tr.uv_grid_from_vor_div(T, vors.curr, divs.curr)

        if c.spec_tracer:
            adv = tr.horizontal_advection(T, state.trs.curr, state.u.curr, state.v.curr)
            dt_trs = apply_damping(self.damping, state.trs.prev, tr.grid_to_spec(T, adv),
                                   delta_t)
            trs = lf(state.trs, dt_trs, c.robert_coeff_tracer)
        else:
            trs = state.trs

        advance = lambda old, fut: TwoLevel(old.curr, fut)
        return ShallowState(
            vors=vors, divs=divs, hs=hs,
            u=advance(state.u, u_f), v=advance(state.v, v_f),
            vorg=advance(state.vorg, tr.spec_to_grid(T, vors.curr)),
            divg=advance(state.divg, tr.spec_to_grid(T, divs.curr)),
            hg=advance(state.hg, tr.spec_to_grid(T, hs.curr)),
            trs=trs, s_stir=s_stir, rng=rng)

    def run(self, state: ShallowState, num_steps: int, first: bool = True) -> ShallowState:
        for i in range(num_steps):
            state = self.step(state, first=first and i == 0)
        return state

    def diag_fields(self, state: ShallowState) -> dict:
        return {
            "ucomp": state.u.curr, "vcomp": state.v.curr,
            "vor": state.vorg.curr, "div": state.divg.curr, "h": state.hg.curr,
        }

    def diagnostics(self, state: ShallowState) -> dict:
        T = self.T
        # total energy ~ <h(u^2+v^2)/2 + (h+hb)^2/2> / h_0 (up to consts)
        ke = 0.5 * state.hg.curr * (state.u.curr**2 + state.v.curr**2)
        pe = 0.5 * (state.hg.curr + self.deep_geopot) ** 2
        return {
            "energy": tr.area_weighted_mean(T, ke + pe) / self.config.h_0,
            "mean_h": tr.area_weighted_mean(T, state.hg.curr),
            "hmin": tr.grid_min(T, state.hg.curr),
        }
