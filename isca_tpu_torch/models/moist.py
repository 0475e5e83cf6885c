"""Grey-radiation moist aquaplanet (Frierson) model.

Port of isca_tpu/models/moist.py. Reference composition: GreyCodeBase
(`grey_isca.x`) - the primitive-equation spectral core + idealized_moist_phys
with two-stream grey radiation (or RRTM: RRTMG-SW with RRTMG-LW or grey LW,
or SOCRATES; optionally every `dt_rad` seconds, and with SimCloud or SPOOKIE
clouds feeding RRTM's or SOCRATES' cloud optics), simple or full
Betts-Miller or RAS convection, large-scale condensation, Monin-Obukhov
surface fluxes, the K-profile, MY2.5, EDT, entrain or stable-BL boundary
layer (with optional shallow convection), the upper-atmosphere damping
(Rayleigh sponge and the orographic and convective gravity-wave drags), and
a slab ocean with optional SST, sea-ice, q-flux and ozone series; specific
humidity as a grid tracer (van Leer + PPM vertical), with the
water-conservation fixer. A run is a Python loop of eager steps.

Land (`set_land`: a land mask and surface height) and the Manabe bucket
hydrology (`bucket=True`) are ported. MY2.5's TKE is part of the state.

Matches exp/test_cases/frierson/frierson_test_case.py defaults.

With PrimitiveConfig(mesh=...) every rank steps its latitude band of the
columns and its m block of the spectral state (dycore.primitive); the
diagnostics' means and extrema are global. The physics is column-local, so
every configuration runs on a mesh: each rank's MoistPhysics holds its
band's latitudes (radiation, clouds, the drags and the series see only its
columns), and set_land takes the whole globe's fields and keeps the band.
"""

from __future__ import annotations

import dataclasses
import math
import warnings

import numpy as np
import torch
from torch.profiler import record_function

from isca_tpu_torch.dycore import press_geopot as pgm
from isca_tpu_torch.dycore import vert_advection as va
from isca_tpu_torch.dycore.primitive import (
    GridTendencies,
    PrimitiveConfig,
    PrimitiveCore,
    PrimitiveState,
    TracerAttr,
)
from isca_tpu_torch.dycore.time_integration import TwoLevel, leapfrog
from isca_tpu_torch.physics.mixed_layer import initial_t_surf
from isca_tpu_torch.physics.moist_driver import (
    MoistPhysics,
    MoistPhysicsConfig,
    RadCache,
    zero_rad_cache,
)
from isca_tpu_torch.spectral import transforms as tr


@dataclasses.dataclass(frozen=True)
class GreyMoistConfig:
    core: PrimitiveConfig = PrimitiveConfig(
        resolution="T42",
        num_levels=25,
        dt=720.0,
        vert_coord_option="uneven_sigma",
        vert_coord_kwargs=(("scale_heights", 6.0), ("surf_res", 0.5), ("exponent", 7.5)),
        do_water_correction=True,
        water_correction_limit=200.0e2,
        use_virtual_temperature=False,   # frierson test case: dry dynamics T
        robert_coeff=0.03,
    )
    physics: MoistPhysicsConfig = MoistPhysicsConfig()
    initial_sphum: float = 2.0e-6
    t_surf_init: float = 285.0
    sphum_vert_scheme: str = va.FINITE_VOLUME_PARABOLIC


@dataclasses.dataclass
class GreyMoistState:
    dyn: PrimitiveState
    t_surf: torch.Tensor
    time_seconds: torch.Tensor   # 0-d float32 model time (s) for seasonal insolation
    bucket_depth: TwoLevel       # (lat, lon) water depth (m); constant unless bucket
    tke: torch.Tensor            # (lat, lon, L+1) MY2.5 TKE (zeros when unused)
    rad_cache: RadCache          # stored radiation for dt_rad substepping (age on the host)


class GreyMoistModel:
    def __init__(self, config: GreyMoistConfig = GreyMoistConfig(), device=None):
        """device: None runs on CUDA (and raises without it); "cpu" on the CPU."""
        self.config = config
        attrs = (TracerAttr("sphum", representation="grid",
                            vert_scheme=config.sphum_vert_scheme),)
        self.core = PrimitiveCore(config.core, tracer_attrs=attrs, device=device)
        self.device = self.core.device
        self.physics = MoistPhysics(config.physics, self.core.T.lats, self.core.T.lons)
        if config.physics.do_damping and config.physics.damping.do_cg_drag:
            ph = (self.core.pk.cpu().numpy()
                  + self.core.bk.cpu().numpy() * config.core.reference_sea_level_press)
            self.physics.init_cg_drag(0.5 * (ph[:-1] + ph[1:]))
        self.surf_geopotential = torch.zeros(self.core.T.grid_shape, dtype=config.core.dtype,
                                             device=self.device)
        self.land_mask = None   # optional (lat, lon) float mask

    def set_land(self, land_mask, surf_geopotential=None, units="m"):
        """Attach a land mask (and optionally topography).

        units='m' (default): `surf_geopotential` is surface HEIGHT in meters;
        grav is applied internally. units='m2/s2': it is already a
        geopotential (g*z) and is used as-is. Pass units explicitly when
        feeding legacy g*z fields: the magnitude check below only catches
        heights above 9500 m, so low-relief g*z (< ~970 m * g) would
        otherwise be silently double-multiplied by gravity.

        Raw gridded topography should be band-limited first
        (utils.topography.band_limit_topography) as the reference does for
        input topography. Arrays or tensors; they are moved to the model's
        device and dtype.

        On a mesh both fields are the whole globe's (nlat, nlon), as
        isca_tpu's are: each rank keeps its band's rows, so the spectral
        surface geopotential is the sharded transform of the whole field.
        Band-limit the topography before, with mesh-less transforms."""
        if units not in ("m", "m2/s2"):
            raise ValueError(f"set_land units must be 'm' or 'm2/s2', got {units!r}")
        T = self.core.T
        whole = (T.nlat, T.nlon)

        def as_t(x):
            x = torch.as_tensor(x if torch.is_tensor(x) else np.asarray(x, np.float64)).to(
                device=self.device, dtype=self.config.core.dtype)
            if T.mesh is not None:
                if tuple(x.shape) != whole:
                    raise ValueError(f"set_land on a mesh takes the whole globe's "
                                     f"{whole} fields, not {tuple(x.shape)}")
                x = T.local_lat(x).clone()
            return x

        self.land_mask = as_t(land_mask)
        self.physics.land_mask = self.land_mask
        if surf_geopotential is not None:
            topo = as_t(surf_geopotential)
            grav = self.core.C.grav
            if units == "m":
                zmax = float(tr.grid_max(T, topo))
                if zmax > 9500.0:
                    warnings.warn(
                        f"set_land: max surface height {zmax:.0f} m exceeds "
                        "any terrestrial value - set_land expects METERS by "
                        "default and applies grav itself (pass units='m2/s2' "
                        "for geopotential input)",
                        RuntimeWarning, stacklevel=2)
                self.surf_geopotential = topo * grav
            else:
                self.surf_geopotential = topo
            # surface height for land_option='zsurf' heat capacity
            self.physics.zsurf = self.surf_geopotential / grav

    # valid_range_t guard (spectral_dynamics.F90:940-1005)
    validity_name = "temperature"

    @property
    def validity_range(self):
        return self.config.core.valid_range_t

    def validity(self, state: GreyMoistState):
        return self.core.validity(state.dyn)

    # ------------------------------------------------------------------
    def initial_state(self) -> GreyMoistState:
        c, T = self.config, self.core.T
        dtype = c.core.dtype
        dyn = self.core.cold_start(self.surf_geopotential)
        q0 = torch.full_like(dyn.tracers["sphum"].curr, c.initial_sphum)
        dyn.tracers["sphum"] = TwoLevel(q0, q0)
        if c.physics.mixed_layer.prescribe_initial_dist:
            lat2d = T.lats[:, None] * torch.ones((1, T.nlon), dtype=dtype, device=self.device)
            t_surf = initial_t_surf(c.physics.mixed_layer, lat2d).to(dtype)
        else:
            t_surf = torch.full(T.grid_shape, c.t_surf_init, dtype=dtype, device=self.device)
        pc = c.physics
        if pc.bucket and self.land_mask is not None:
            full = lambda x: torch.full_like(self.land_mask, x, dtype=dtype)
            depth0 = torch.where(self.land_mask > 0.5, full(pc.init_bucket_depth_land),
                                 full(pc.init_bucket_depth))
        else:
            depth0 = torch.full(T.grid_shape, pc.init_bucket_depth, dtype=dtype,
                                device=self.device)
        L = c.core.num_levels
        return GreyMoistState(
            dyn=dyn, t_surf=t_surf,
            time_seconds=torch.zeros((), dtype=torch.float32, device=self.device),
            bucket_depth=TwoLevel(depth0, depth0),
            tke=torch.zeros(T.grid_shape + (L + 1,), dtype=dtype, device=self.device),
            rad_cache=zero_rad_cache(T.grid_shape, L, dtype, self.device))

    # ------------------------------------------------------------------
    def step(self, state: GreyMoistState, first: bool = False) -> GreyMoistState:
        return self._step_impl(state, first)[0]

    def step_with_diagnostics(self, state: GreyMoistState, first: bool = False):
        """One step, also returning the physics diagnostics dict
        (precipitation, fluxes, radiation...) merged with the standard
        prognostic diag_fields."""
        new_state, phys_diag = self._step_impl(state, first)
        diag = dict(self.diag_fields(new_state))
        diag.update(phys_diag)
        return new_state, diag

    def _step_impl(self, state: GreyMoistState, first: bool = False):
        c, core = self.config, self.core
        C = core.C
        dyn = state.dyn
        delta_t = c.core.dt if first else 2.0 * c.core.dt
        ll = lambda x: torch.movedim(x, 0, -1)   # level-first -> level-last
        lf = lambda x: torch.movedim(x, -1, 0)

        # pressures/heights at previous and current
        def pres_z(psg, tg):
            ph, lph, pf, lpf = pgm.pressure_variables(core.pk, core.bk, psg, core.top_is_zero)
            geo_f, geo_h = pgm.compute_geopotential(
                C.rdgas, ll(tg), lph, lpf, self.surf_geopotential,
                core.top_is_zero, p_half=ph)
            return ph, pf, geo_f / C.grav, geo_h / C.grav

        q = dyn.tracers["sphum"]
        ph_prev, pf_prev, _, _ = pres_z(dyn.psg.prev, dyn.tg.prev)
        ph_curr, pf_curr, zf_curr, zh_curr = pres_z(dyn.psg.curr, dyn.tg.curr)

        # float32 time, as in isca_tpu: gmt and time_since_ae round alike
        day = C.seconds_per_day
        gmt = torch.remainder(state.time_seconds, day) / day * 2.0 * math.pi
        tsae = torch.remainder(
            state.time_seconds / c.physics.constants.orbital_period
            - c.physics.radiation.equinox_day, 1.0) * 2.0 * math.pi

        with record_function("physics"):
            phys = self.physics(
                delta_t, c.core.dt,
                ll(dyn.ug.prev), ll(dyn.vg.prev), ll(dyn.tg.prev), ll(q.prev),
                pf_prev, ph_prev, pf_curr, ph_curr, zf_curr, zh_curr,
                state.t_surf, gmt=gmt, time_since_ae=tsae,
                bucket_depth=state.bucket_depth.curr,
                time_seconds=state.time_seconds,
                wg_full=ll(dyn.wg_full),
                tke=state.tke,
                rad_cache=state.rad_cache,
            )

        # bucket-depth leapfrog (idealized_moist_phys.F90:1343-1372)
        pc = c.physics
        bucket = state.bucket_depth
        if pc.bucket:
            bd = leapfrog(bucket, phys.diagnostics["dt_bucket"] / delta_t, delta_t,
                          pc.robert_bucket, pc.raw_bucket)
            curr = torch.clamp_min(bd.curr, 0.0)
            if self.land_mask is not None:
                curr = torch.where(self.land_mask > 0.5,
                                   torch.clamp_max(curr, pc.max_bucket_depth_land), curr)
            bucket = TwoLevel(torch.clamp_min(bd.prev, 0.0), curr)

        tend = GridTendencies(du=lf(phys.dt_u), dv=lf(phys.dt_v), dt=lf(phys.dt_t),
                              dtracers={"sphum": lf(phys.dt_q)})
        with record_function("dynamics"):
            dyn_new = core.dynamics_step(dyn, tend, self.surf_geopotential, first=first)
        new_state = GreyMoistState(
            dyn=dyn_new, t_surf=phys.t_surf,
            time_seconds=state.time_seconds + c.core.dt,
            bucket_depth=bucket,
            tke=phys.diagnostics.get("tke", state.tke),
            rad_cache=phys.rad_cache,
        )
        return new_state, phys.diagnostics

    # ------------------------------------------------------------------
    def run(self, state: GreyMoistState, num_steps: int, first: bool = True) -> GreyMoistState:
        for i in range(num_steps):
            state = self.step(state, first=first and i == 0)
        return state

    def diag_fields(self, state: GreyMoistState, extended: bool = False) -> dict:
        """Standard diagnostic fields ('dynamics' + moist additions).

        extended=True returns the reference's full spectral_diagnostics set
        (SURVEY.md B.2) plus t_surf."""
        if extended:
            out = self.core.spectral_diagnostics(
                state.dyn, self.surf_geopotential,
                use_virtual_temperature=self.config.core.use_virtual_temperature)
            out["t_surf"] = state.t_surf
            return out
        d = state.dyn
        return {
            "ps": d.psg.curr,
            "ucomp": d.ug.curr,
            "vcomp": d.vg.curr,
            "temp": d.tg.curr,
            "vor": d.vorg.curr,
            "div": d.divg.curr,
            "omega": d.wg_full,
            "sphum": d.tracers["sphum"].curr,
            "t_surf": state.t_surf,
        }

    def diagnostics(self, state: GreyMoistState) -> dict:
        T = self.core.T
        dyn = state.dyn
        q = dyn.tracers["sphum"].curr
        return {
            "mean_ps": tr.area_weighted_mean(T, dyn.psg.curr),
            "tmin": tr.grid_min(T, dyn.tg.curr),
            "tmax": tr.grid_max(T, dyn.tg.curr),
            "umax": tr.grid_max(T, torch.abs(dyn.ug.curr)),
            "qmin": tr.grid_min(T, q),
            "qmax": tr.grid_max(T, q),
            "mean_t_surf": tr.area_weighted_mean(T, state.t_surf),
            "total_water": self.core.mass_weighted_integral(q, dyn.psg.curr),
            "t_zonal": dyn.tg.curr.mean(dim=2),
            "u_zonal": dyn.ug.curr.mean(dim=2),
            "q_zonal": q.mean(dim=2),
        }


# Frierson 2006 sigma ladder (reference frierson_test_case.py vert_coordinate_nml)
FRIERSON_BK = (
    0.000000, 0.0117665, 0.0196679, 0.0315244, 0.0485411, 0.0719344,
    0.1027829, 0.1418581, 0.1894648, 0.2453219, 0.3085103, 0.3775033,
    0.4502789, 0.5244989, 0.5977253, 0.6676441, 0.7322627, 0.7900587,
    0.8400683, 0.8819111, 0.9157609, 0.9422770, 0.9625127, 0.9778177,
    0.9897489, 1.0000000,
)


def frierson_test_case_config(**core_overrides) -> GreyMoistConfig:
    """The reference's frierson_test_case.py configuration, faithfully.

    GreyMoistConfig() carries the *namelist defaults* (as the reference
    modules do); the published Frierson test case overrides them - shallow
    2.5 m slab with albedo 0.31 (Jucker & Gerber 2017 CTRL), atm_abs 0.2,
    Frierson's own sigma ladder, rhbm 0.7, low roughness lengths, zero
    gustiness, and an upper Rayleigh sponge (reference:
    exp/test_cases/frierson/frierson_test_case.py:49-171).
    """
    from isca_tpu_torch.physics.damping_driver import DampingDriverConfig
    from isca_tpu_torch.physics.lscale_cond import LscaleCondConfig
    from isca_tpu_torch.physics.mixed_layer import MixedLayerConfig
    from isca_tpu_torch.physics.qe_moist_convection import QEMoistConvectionConfig
    from isca_tpu_torch.physics.two_stream_gray import TwoStreamConfig

    core = PrimitiveConfig(
        resolution="T42",
        num_levels=25,
        dt=720.0,
        vert_coord_option="input",
        vert_coord_kwargs=(
            ("bk", FRIERSON_BK),
            ("pk", (0.0,) * len(FRIERSON_BK)),
        ),
        damping_order=4,
        do_water_correction=True,
        water_correction_limit=200.0e2,
        reference_sea_level_press=1.0e5,
        valid_range_t=(100.0, 800.0),
        use_virtual_temperature=False,
        robert_coeff=0.03,
        **core_overrides,
    )
    phys = MoistPhysicsConfig(
        convection_scheme="SIMPLE_BETTS_MILLER",
        convection=QEMoistConvectionConfig(rhbm=0.7, Tmin=160.0),
        condensation=LscaleCondConfig(do_simple=True, do_evap=True),
        radiation=TwoStreamConfig(atm_abs=0.2),
        mixed_layer=MixedLayerConfig(
            depth=2.5, albedo_value=0.31, tconst=285.0,
            prescribe_initial_dist=True, evaporation=True,
        ),
        do_damping=True,
        damping=DampingDriverConfig(
            do_rayleigh=True, trayfric=-0.25, sponge_pbottom=5000.0,
            do_conserve_energy=True,
        ),
        roughness_mom=3.21e-05,
        roughness_heat=3.21e-05,
        roughness_moist=3.21e-05,
        gust_const=0.0,
    )
    return GreyMoistConfig(core=core, physics=phys)


def mima_test_case_config(**core_overrides) -> GreyMoistConfig:
    """The reference's mima_test_case.py configuration (Jucker & Gerber 2017's
    MiMA, exp/test_cases/mima_test_case.py): GreyMoistConfig() with RRTM
    radiation (RRTMG-SW and RRTMG-LW through RRTMConfig's "auto", seasonal
    sun, constant ozone 1e-6) and full Betts-Miller convection. The test case
    sets no dt_rad: radiation runs every step."""
    from isca_tpu_torch.physics.rrtm_radiation import RRTMConfig

    cfg = GreyMoistConfig()
    return dataclasses.replace(
        cfg, core=dataclasses.replace(cfg.core, **core_overrides),
        physics=dataclasses.replace(
            cfg.physics, radiation_scheme="rrtm",
            rrtm=RRTMConfig(do_seasonal=True, o3_mmr=1.0e-6),
            convection_scheme="FULL_BETTS_MILLER"))


def socrates_aquaplanet_test_case_config(with_clouds=False, **core_overrides) -> GreyMoistConfig:
    """The reference's SOCRATES aquaplanet
    (exp/test_cases/socrates_aquaplanet_test_case.py): GreyMoistConfig()
    with SOCRATES radiation (synthetic ga7-like spectra, stellar constant
    1370 W/m2, CO2 300 ppmv); `with_clouds` is the script's --clouds, the
    socrates_aquaplanet_with_cloud variant, in which SimCloud feeds
    SOCRATES' cloud optics. SOCRATES runs in float32 whatever the dtype."""
    from isca_tpu_torch.physics.socrates import SocratesConfig

    cfg = GreyMoistConfig()
    return dataclasses.replace(
        cfg, core=dataclasses.replace(cfg.core, **core_overrides),
        physics=dataclasses.replace(
            cfg.physics, radiation_scheme="socrates",
            socrates=SocratesConfig(stellar_constant=1370.0, co2_ppmv=300.0),
            do_cloud_simple=with_clouds))


def simple_clouds_test_case_config(**core_overrides) -> GreyMoistConfig:
    """The reference's simple_clouds test case
    (exp/test_cases/simple_clouds_test_case.py): GreyMoistConfig() with
    RRTM radiation (RRTMConfig(): RRTMG-SW and RRTMG-LW through "auto") and
    SimCloud, whose clouds feed both RRTMG cloud optics."""
    from isca_tpu_torch.physics.rrtm_radiation import RRTMConfig

    cfg = GreyMoistConfig()
    return dataclasses.replace(
        cfg, core=dataclasses.replace(cfg.core, **core_overrides),
        physics=dataclasses.replace(
            cfg.physics, radiation_scheme="rrtm", rrtm=RRTMConfig(),
            do_cloud_simple=True))
