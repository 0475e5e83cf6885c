"""Primitive-equation spectral dynamical core (hybrid sigma-pressure, semi-implicit
RAW-filtered leapfrog), with grid and spectral tracers.

Port of isca_tpu/dycore/primitive.py (reference:
src/atmos_spectral/model/spectral_dynamics.F90, step at :780-1034,
four_in_one at :1038-1112, corrections at :1213-1340) as plain functions on
torch tensors:

* Grid fields carried at two time levels are the values synthesized when each
  level was `future` (plus global fixers); the Robert filter afterwards modifies
  only the SPECTRAL current. This lag is part of the reference trajectory.
* Ordering within one step: physics tendencies (computed by the caller at the
  `previous` time level) -> four_in_one/pressure-gradient/geopotential ->
  advection -> spectral tendencies -> semi-implicit correction -> hyperdiffusion
  -> leapfrog part A -> synthesize future grid fields -> mass/energy/water
  fixers (touch future grid AND spectral fields) -> leapfrog part B (sees the
  corrected future).
* First call is a forward step (prev == curr, delta_t = dt); afterwards 2*dt.
* Every update is out of place: cold_start gives both time levels the same
  tensor, so an in-place write would change both.

Array layout: grid (lev, lat, lon) with lev index 0 = top; spectral (lev, m, n)
complex with total-wavenumber n. Vertical-column helpers operate level-last
on movedim views.

On a mesh (PrimitiveConfig.mesh, isca_tpu_torch.parallel.mesh) every rank
steps its latitude band of the grid fields and its block of m rows of the
spectral ones: the transforms transpose between the two, the global fixers
and means all_reduce (spectral.transforms.area_weighted_mean), the (m=0,
n=0) corrections go to the rank holding m = 0, and the grid tracers'
finite-volume advection exchanges halo rows with the neighbouring bands.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import numpy as np
import torch

from isca_tpu_torch import resolve_device
from isca_tpu_torch.constants import Constants, EARTH
from isca_tpu_torch.dycore import fv_advection as fv
from isca_tpu_torch.dycore import press_geopot as pg
from isca_tpu_torch.dycore import vert_advection as va
from isca_tpu_torch.dycore import vert_coordinate as vc
from isca_tpu_torch.dycore.damping import apply_damping, apply_top_sponge, make_damping
from isca_tpu_torch.dycore.implicit import build_implicit, implicit_correction
from isca_tpu_torch.dycore.time_integration import (
    TwoLevel,
    leapfrog,
    leapfrog_part_a,
    leapfrog_part_b,
)
from isca_tpu_torch.dycore.water_borrowing import water_borrowing
from isca_tpu_torch.spectral import transforms as tr
from isca_tpu_torch.utils.validity import check_range

# schemes that read the `previous` time level (van Leer, PPM)
_PREV_LEVEL_SCHEMES = (va.VAN_LEER_LINEAR, va.FINITE_VOLUME_PARABOLIC)


def _lev_last(x):
    return torch.movedim(x, 0, -1)


def _lev_first(x):
    return torch.movedim(x, -1, 0)


class GridTendencies(NamedTuple):
    """Physics tendencies on the grid (level-first). Any entry may be None."""

    du: Any = None
    dv: Any = None
    dt: Any = None
    dtracers: Any = None   # dict[str, tensor]


@dataclasses.dataclass(frozen=True)
class TracerAttr:
    """Per-tracer numerics, the field_table equivalent
    (reference: src/extra/model/isca/field_table + tracer_type.F90)."""

    name: str
    representation: str = "grid"          # 'grid' (van Leer A-grid) | 'spectral'
    vert_scheme: str = va.FINITE_VOLUME_PARABOLIC
    robert_coeff: float = 0.04
    hole_filling: bool = False            # spectral representation only


@dataclasses.dataclass(frozen=True)
class PrimitiveConfig:
    resolution: str | int = "T42"
    nlon: int | None = None       # lon_max nml; default from resolution table
    nlat: int | None = None       # lat_max nml
    num_levels: int = 25
    dt: float = 600.0
    # dycore substeps per physics step (num_steps nml,
    # spectral_dynamics.F90:832): physics tendencies are held fixed while the
    # dynamics advances num_steps times with delta_t/num_steps; non-final
    # substeps use the inline-complete RAW leapfrog (leapfrog.F90:217-272),
    # the final substep the deferred part-A/part-B split.
    num_steps: int = 1
    vert_coord_option: str = "even_sigma"
    vert_difference_option: str = "simmons_and_burridge"  # or 'mcm'
    # the transform products: 'highest' (exact), 'high' (3xTF32) or
    # 'default' (one TF32 pass) in float32; float64 ignores it
    # (spectral/precision.py)
    transform_precision: str = "highest"
    fourier_method: str = "dft"            # 'dft' (dense matrix product) | 'fft'
    truncation_shape: str = "triangular"   # triang_trunc nml: or 'rhomboidal'
    fourier_inc: int = 1
    vert_coord_kwargs: tuple = ()          # dict items, e.g. (('scale_heights', 6.0), ...)
    robert_coeff: float = 0.04
    raw_filter_coeff: float = 1.0
    alpha_implicit: float = 0.5
    use_implicit: bool = True
    reference_temperature_implicit: float = 300.0
    reference_sea_level_press: float = 101325.0
    damping_option: str = "resolution_dependent"
    damping_order: int = 2
    damping_coeff: float = 1.15740741e-4
    damping_order_vor: int | None = None
    damping_order_div: int | None = None
    damping_coeff_vor: float | None = None
    damping_coeff_div: float | None = None
    cutoff_wn: int = 15
    eddy_sponge_coeff: float = 0.0
    zmu_sponge_coeff: float = 0.0
    zmv_sponge_coeff: float = 0.0
    do_mass_correction: bool = True
    do_energy_correction: bool = True
    do_water_correction: bool = False      # True only for moist models
    water_correction_limit: float = 0.0    # Pa; correct only where p >= limit
    valid_range_t: tuple[float, float] = (100.0, 500.0)
    make_symmetric: bool = False           # zonally-symmetric (axisymmetric)
    initial_temperature: float = 264.0
    uv_vert_advect_scheme: str = va.SECOND_CENTERED
    t_vert_advect_scheme: str = va.SECOND_CENTERED
    use_virtual_temperature: bool = False
    constants: Constants = EARTH
    dtype: Any = torch.float32
    # multi-device: an isca_tpu_torch.parallel.mesh.Mesh turns on the sharded
    # transforms (lat-band grid / m-block spectral); pad_m_to pads the m
    # axis (default: the mesh's size); overlap_chunks chains per sharded
    # transform (no effect without a mesh)
    mesh: Any = None
    pad_m_to: int | None = None
    overlap_chunks: int = 2


@dataclasses.dataclass
class PrimitiveState:
    # spectral prognostics (two time levels)
    vors: TwoLevel    # (L, m, n) complex
    divs: TwoLevel
    ts: TwoLevel
    lnps: TwoLevel    # (m, n)
    # grid mirrors
    ug: TwoLevel      # (L, lat, lon)
    vg: TwoLevel
    tg: TwoLevel
    psg: TwoLevel     # (lat, lon)
    vorg: TwoLevel
    divg: TwoLevel
    tracers: dict        # name -> TwoLevel grid (L, lat, lon)
    spec_tracers: dict   # name -> TwoLevel spectral (only for spectral tracers)
    wg_full: torch.Tensor   # omega diagnostic (L, lat, lon)


class PrimitiveCore:
    """Static tables + configuration; the step methods return new tensors."""

    def __init__(self, config: PrimitiveConfig, tracer_attrs: tuple = (), device=None):
        self.config = c = config
        self.tracer_attrs = tuple(tracer_attrs)
        if c.do_water_correction and "sphum" not in {a.name for a in self.tracer_attrs}:
            raise ValueError("do_water_correction needs a 'sphum' tracer")
        if c.mesh is not None and device is None:
            device = c.mesh.device
        self.device = resolve_device(device)
        self.C = c.constants
        self.T = tr.make_transforms(c.resolution, nlon=c.nlon, nlat=c.nlat,
                                    radius=self.C.radius,
                                    dtype=c.dtype,
                                    make_symmetric=c.make_symmetric,
                                    precision=c.transform_precision,
                                    fourier_method=c.fourier_method,
                                    truncation_shape=c.truncation_shape,
                                    fourier_inc=c.fourier_inc,
                                    pad_m_to=c.pad_m_to,
                                    mesh=c.mesh,
                                    overlap_chunks=c.overlap_chunks,
                                    device=self.device)
        self.fv_geom = fv.make_fv_geometry(self.T) if any(
            a.representation == "grid" for a in self.tracer_attrs) else None
        self.pk_np, self.bk_np = vc.compute_vert_coord(
            c.vert_coord_option, c.num_levels, **dict(c.vert_coord_kwargs))
        as_t = lambda a: torch.as_tensor(a).to(device=self.device, dtype=c.dtype)
        self.pk = as_t(self.pk_np)
        self.bk = as_t(self.bk_np)
        self.dpk = as_t(np.diff(self.pk_np))
        self.dbk = as_t(np.diff(self.bk_np))
        self.top_is_zero = bool(self.pk_np[0] == 0.0 and self.bk_np[0] == 0.0)

        damping_kw = dict(damping_option=c.damping_option, cutoff_wn=c.cutoff_wn,
                          eddy_sponge_coeff=c.eddy_sponge_coeff,
                          zmu_sponge_coeff=c.zmu_sponge_coeff,
                          zmv_sponge_coeff=c.zmv_sponge_coeff)
        self.damping = make_damping(self.T, damping_coeff=c.damping_coeff,
                                    damping_order=c.damping_order, **damping_kw)
        self.damping_vor = self.damping_div = self.damping
        if c.damping_coeff_vor is not None or c.damping_order_vor is not None:
            self.damping_vor = make_damping(
                self.T, damping_coeff=c.damping_coeff_vor or c.damping_coeff,
                damping_order=c.damping_order_vor or c.damping_order, **damping_kw)
        if c.damping_coeff_div is not None or c.damping_order_div is not None:
            self.damping_div = make_damping(
                self.T, damping_coeff=c.damping_coeff_div or c.damping_coeff,
                damping_order=c.damping_order_div or c.damping_order, **damping_kw)

        self.implicit = build_implicit(
            self.pk_np, self.bk_np,
            num_spherical=self.T.num_spherical,
            radius=self.C.radius,
            delta_ts=(c.dt / c.num_steps, 2.0 * c.dt / c.num_steps),
            t_ref=c.reference_temperature_implicit,
            ps_ref=c.reference_sea_level_press,
            alpha=c.alpha_implicit,
            rdgas=self.C.rdgas, cp_air=self.C.cp_air,
            dtype=c.dtype,
            vert_difference_option=c.vert_difference_option,
            device=self.device,
        ) if c.use_implicit else None

        self.coriolis = tr.coriolis_grid(self.T, self.C.omega)

    def unsharded(self) -> "PrimitiveCore":
        """This core without its mesh, on the whole globe with the same m
        rows (padding included), on this rank's device: for what is built
        on the global grid and then sharded (dycore.initial_conditions)."""
        c = dataclasses.replace(self.config, mesh=None, pad_m_to=self.T.num_fourier + 1)
        return PrimitiveCore(c, tracer_attrs=self.tracer_attrs, device=self.device)

    def _add_to_mean_mode(self, s, value):
        """s with `value` added to its (m=0, n=0) coefficient (the grid mean),
        out of place; on a mesh only the rank holding m = 0 adds it."""
        s = s.clone()
        if self.T.m_start == 0:
            s[..., 0, 0] += value
        return s

    # ------------------------------------------------------------------
    def pressure_variables(self, psg):
        """(p_half, ln_p_half, p_full, ln_p_full), level-first."""
        ph, lph, pf, lpf = pg.pressure_variables(
            self.pk, self.bk, psg, self.top_is_zero,
            option=self.config.vert_difference_option)
        return _lev_first(ph), _lev_first(lph), _lev_first(pf), _lev_first(lpf)

    def mass_weighted_integral(self, field, psg):
        """Area-averaged mass-weighted vertical integral (kg/m^2 x field units)."""
        dp = self.dpk[:, None, None] + self.dbk[:, None, None] * psg[None, :, :]
        return tr.area_weighted_mean(self.T, torch.sum(field * dp, dim=0)) / self.C.grav

    def spectral_diagnostics(self, state: PrimitiveState, surf_geopotential=None,
                             use_virtual_temperature: bool = False) -> dict:
        """The reference's full 'dynamics' diagnostic set
        (spectral_diagnostics, spectral_dynamics.F90:1709-1860; field list
        SURVEY.md B.2): heights/pressures, wspd, slp, eddy/covariance
        products, per-tracer fluxes, EKE and vort_norm scalars.

        All 3-D fields are level-first (L, lat, lon). slp uses the 0.006 K/m
        standard-lapse reduction from the lowest level with sigma > 0.8.
        """
        C, T = self.C, self.T
        if surf_geopotential is None:
            surf_geopotential = getattr(self, "surf_geopotential", self._zeros(T.grid_shape))
        u, v, t = state.ug.curr, state.vg.curr, state.tg.curr
        psg, w = state.psg.curr, state.wg_full
        p_half, ln_p_half, p_full, ln_p_full = self.pressure_variables(psg)
        virt_t = t
        if use_virtual_temperature and "sphum" in state.tracers:
            q = state.tracers["sphum"].curr
            virt_t = pg.virtual_temperature(t, q, C.rvgas / C.rdgas - 1.0)
        z_full, z_half = pg.compute_geopotential(
            C.rdgas, _lev_last(virt_t), _lev_last(ln_p_half), _lev_last(ln_p_full),
            surf_geopotential, self.top_is_zero, p_half=_lev_last(p_half))
        z_full = _lev_first(z_full) / C.grav
        z_half = _lev_first(z_half) / C.grav

        # sea-level pressure: reduce from the lowest level with sigma > 0.8
        # by a 6.5->6.0 K/km standard atmosphere (spectral_dynamics.F90:1823-1835)
        gamma = 0.006
        expf = C.rdgas * gamma / C.grav
        sigma = p_full / psg[None]
        # first level with sigma > 0.8: argmax returns the first maximum, and
        # has no CUDA kernel for bool, hence the uint8 mask
        k_low = torch.argmax((sigma > 0.8).to(torch.uint8), dim=0)
        t_k = torch.gather(t, 0, k_low[None])[0]
        p_k = torch.gather(p_full, 0, k_low[None])[0]
        t_low = t_k * (p_k / psg) ** (-expf)
        slp = psg * ((t_low + gamma * surf_geopotential / C.grav) / t_low) ** (1.0 / expf)

        # EKE: mass-weighted global eddy kinetic energy with the zonal mean
        # (m = 0 modes) removed (spectral_dynamics.F90:1855-1862)
        vor_s, div_s = tr.vor_div_from_uv_grid(T, u, v)
        zero_m0 = np.ones((T.num_fourier + 1, 1))
        zero_m0[0] = 0.0
        zero_m0 = torch.as_tensor(T.local_m(zero_m0)).to(device=self.device, dtype=T.dtype)
        ue, ve = tr.uv_grid_from_vor_div(T, vor_s * zero_m0, div_s * zero_m0)
        eke = self.mass_weighted_integral(0.5 * (ue**2 + ve**2), psg)

        # vort_norm: max |grad vor| at the bottom level (:1842-1853)
        vx = tr.spec_to_grid(T, tr.ddx_spec(T, vor_s[-1]))
        vy = tr.spec_to_grid(T, tr.cos_dlat_coeffs(T, vor_s[-1]))
        coslat = T.coslat[:, None]
        vort_norm = tr.grid_max(T, torch.sqrt((vx / (T.radius * coslat)) ** 2
                                              + (vy / (T.radius * coslat)) ** 2))

        out = {
            "ps": psg, "ucomp": u, "vcomp": v, "temp": t,
            "vor": state.vorg.curr, "div": state.divg.curr, "omega": w,
            "pres_full": p_full, "pres_half": p_half,
            "height": z_full, "height_half": z_half,
            "wspd": torch.sqrt(u**2 + v**2), "slp": slp,
            "ucomp_sq": u * u, "vcomp_sq": v * v, "temp_sq": t * t,
            "omega_sq": w * w, "ucomp_vcomp": u * v,
            "ucomp_omega": u * w, "vcomp_omega": v * w,
            "ucomp_temp": u * t, "vcomp_temp": v * t, "omega_temp": w * t,
            "ucomp_height": u * z_full, "vcomp_height": v * z_full,
            "omega_height": w * z_full, "vcomp_vor": v * state.vorg.curr,
            "EKE": eke, "vort_norm": vort_norm,
        }
        for name, tl in state.tracers.items():
            r = tl.curr
            out[name] = r
            out[f"ucomp_{name}"] = u * r
            out[f"vcomp_{name}"] = v * r
            out[f"omega_{name}"] = w * r
        return out

    def static_diag_fields(self, surf_geopotential=None) -> dict:
        """Static 'dynamics' fields: pk, bk, zsurf (spectral_dynamics.F90:1560-1570)."""
        if surf_geopotential is None:
            surf_geopotential = getattr(self, "surf_geopotential", self._zeros(self.T.grid_shape))
        return {"pk": self.pk, "bk": self.bk,
                "zsurf": surf_geopotential / self.C.grav}

    def validity(self, state: PrimitiveState):
        """valid_range_t temperature guard (spectral_dynamics.F90:940-971);
        global on a mesh (check_range)."""
        lo, hi = self.config.valid_range_t
        return check_range(state.tg.curr, lo, hi, mesh=self.T.mesh)

    def _zeros(self, shape, dtype=None):
        return torch.zeros(shape, dtype=dtype or self.config.dtype, device=self.device)

    # ------------------------------------------------------------------
    def cold_start(self, surf_geopotential=None) -> PrimitiveState:
        """Isothermal state of rest with tiny vorticity seeds (A.10)."""
        c, T = self.config, self.T
        L = c.num_levels
        if surf_geopotential is None:
            surf_geopotential = self._zeros(T.grid_shape)
        self.surf_geopotential = surf_geopotential

        # FMS seeds modes (m, n_idx) = (1,3),(5,3),(1,2),(5,2) -> total n = m + n_idx
        pert_mask = np.zeros((L, T.num_fourier + 1, T.num_spherical + 1))
        for (m, nidx) in ((1, 3), (5, 3), (1, 2), (5, 2)):
            pert_mask[L - 3:, m, m + nidx] = 1.0e-7
        pert = torch.as_tensor(T.local_m(pert_mask, axis=1)).to(device=self.device, dtype=c.dtype)
        surf = surf_geopotential.to(device=self.device, dtype=c.dtype)

        ln_psg = math.log(c.reference_sea_level_press) - surf / (
            self.C.rdgas * c.initial_temperature)
        tg = torch.full((L,) + T.grid_shape, c.initial_temperature, dtype=c.dtype,
                        device=self.device)
        vors = tr.triangular_truncate(T, torch.complex(pert, torch.zeros_like(pert)))
        divs = torch.zeros_like(vors)
        ug, vg = tr.uv_grid_from_vor_div(T, vors, divs)
        # band-limit T and ln ps through one round trip
        ts = tr.grid_to_spec(T, tg)
        tg = tr.spec_to_grid(T, ts)
        lnps = tr.grid_to_spec(T, ln_psg)
        ln_psg = tr.spec_to_grid(T, lnps)
        psg = torch.exp(ln_psg)
        vors, divs = tr.vor_div_from_uv_grid(T, ug, vg)
        ug, vg = tr.uv_grid_from_vor_div(T, vors, divs)
        vorg = tr.spec_to_grid(T, vors)
        divg = tr.spec_to_grid(T, divs)

        two = lambda x: TwoLevel(x, x)
        zeros_tr = {a.name: two(self._zeros((L,) + T.grid_shape))
                    for a in self.tracer_attrs}
        zeros_sp = {a.name: two(torch.zeros_like(vors))
                    for a in self.tracer_attrs if a.representation == "spectral"}
        return PrimitiveState(
            vors=two(vors), divs=two(divs), ts=two(ts), lnps=two(lnps),
            ug=two(ug), vg=two(vg), tg=two(tg), psg=two(psg),
            vorg=two(vorg), divg=two(divg),
            tracers=zeros_tr, spec_tracers=zeros_sp,
            wg_full=self._zeros((L,) + T.grid_shape),
        )

    # ------------------------------------------------------------------
    def _four_in_one(self, divg, u, v, virt_t, psg, ln_p_half, ln_p_full, p_full,
                     dx_psg, dy_psg):
        """PGF terms, divergence integral, vertical mass flux, omega, energy
        conversion (spectral_dynamics.F90:1038-1112; Simmons-Burridge or the
        MCM half-layer weighting selected by vert_difference_option)."""
        C = self.C
        kappa = C.rdgas / C.cp_air
        ps = psg[None]
        dbk = self.dbk[:, None, None]
        dp = self.dpk[:, None, None] + dbk * ps
        dmean = divg * dp + dbk * (u * dx_psg[None] + v * dy_psg[None])
        cum = torch.cumsum(dmean, dim=0)
        cum_before = torch.cat([torch.zeros_like(cum[:1]), cum[:-1]], dim=0)
        if self.config.vert_difference_option == "mcm":
            # spectral_dynamics.F90:1084-1099: PGF uses grad(ps)/ps directly;
            # energy conversion weights the current layer by 1/2
            x2 = (dx_psg / psg)[None] * torch.ones_like(virt_t)
            x3 = (dy_psg / psg)[None] * torch.ones_like(virt_t)
            x4 = (cum_before + 0.5 * dmean) / p_full
        else:
            dlog_1 = ln_p_half[1:] - ln_p_full
            dlog_2 = ln_p_full - ln_p_half[:-1]
            dlog_3 = ln_p_half[1:] - ln_p_half[:-1]
            x1 = (self.bk[1:, None, None] * dlog_1 + self.bk[:-1, None, None] * dlog_2) / dp
            x2 = x1 * dx_psg[None]
            x3 = x1 * dy_psg[None]
            x4 = (cum_before * dlog_3 + dmean * dlog_1) / dp
        du_pgf = -C.rdgas * virt_t * x2
        dv_pgf = -C.rdgas * virt_t * x3
        x5 = x4 - u * x2 - v * x3
        dt_t_econv = -kappa * virt_t * x5
        wg_full = -x5 * p_full
        dmean_tot = cum[-1]
        dps_tend = -dmean_tot

        # half-level mass flux: wg[k] = bk[k]*dmean_tot - cum[k-1], zero at ends
        wg_mid = self.bk[1:-1, None, None] * dmean_tot[None] - cum[:-1]
        zero = torch.zeros_like(dmean_tot[None])
        wg = torch.cat([zero, wg_mid, zero], dim=0)  # (L+1, lat, lon)
        return du_pgf, dv_pgf, dt_t_econv, dps_tend, wg, wg_full

    # ------------------------------------------------------------------
    def dynamics_step(self, state: PrimitiveState, phys: GridTendencies,
                      surf_geopotential, first: bool = False) -> PrimitiveState:
        """One full semi-implicit leapfrog step (num_steps substeps).

        Physics tendencies are applied identically in every substep
        (spectral_dynamics.F90:832-845 step_loop). Each substep's delta_t is
        dt/n or 2*dt/n exactly, the keys of the implicit wave matrices."""
        c = self.config
        n = c.num_steps
        for i in range(n):
            delta_t = (c.dt if (first and i == 0) else 2.0 * c.dt) / n
            state = self._substep(state, phys, surf_geopotential, delta_t,
                                  final=(i == n - 1))
        return state

    def _substep(self, state: PrimitiveState, phys: GridTendencies,
                 surf_geopotential, delta_t: float, final: bool = True) -> PrimitiveState:
        """One dynamics substep; `final` selects the deferred-part-B RAW
        leapfrog (2level_A/B) vs the inline-complete filter used for
        non-final substeps (spectral_dynamics.F90:919-931, 1147-1180)."""
        c, T, C = self.config, self.T, self.C
        zero3 = self._zeros((c.num_levels,) + T.grid_shape)
        dt_ug = phys.du if phys.du is not None else zero3
        dt_vg = phys.dv if phys.dv is not None else zero3
        dt_tg = phys.dt if phys.dt is not None else zero3

        # ---- global fixer reference values (initialize_corrections) ----
        if c.do_mass_correction:
            mean_ps_prev = tr.area_weighted_mean(T, state.psg.prev)
        if c.do_energy_correction:
            energy_prev = self.mass_weighted_integral(
                0.5 * ((state.ug.prev + delta_t * dt_ug) ** 2
                       + (state.vg.prev + delta_t * dt_vg) ** 2)
                + C.cp_air * (state.tg.prev + delta_t * dt_tg),
                state.psg.prev,
            )

        # ---- pressure variables and gradients at `current`: one batched
        # gradient synthesis of ln ps (2 fields), T (2L) and each spectral
        # tracer (2L) ----
        p_half, ln_p_half, p_full, ln_p_full = self.pressure_variables(state.psg.curr)
        L = c.num_levels
        sp_attrs = [a for a in self.tracer_attrs if a.representation == "spectral"]
        lnps_c, ts_c = state.lnps.curr, state.ts.curr
        grad_parts = [tr.ddx_spec(T, lnps_c)[None], tr.cos_dlat_coeffs(T, lnps_c)[None],
                      tr.ddx_spec(T, ts_c), tr.cos_dlat_coeffs(T, ts_c)]
        for attr in sp_attrs:
            s_tr = state.spec_tracers[attr.name].curr
            grad_parts += [tr.ddx_spec(T, s_tr), tr.cos_dlat_coeffs(T, s_tr)]
        gsyn = tr.spec_to_grid(T, torch.cat(grad_parts, dim=0))
        dx_lnps, dy_lnps = gsyn[0], gsyn[1]
        coslat = T.coslat[:, None]
        acoslat = T.radius * coslat
        # advective-form -(V . grad) terms for T and the spectral tracers
        t_adv = -(state.ug.curr * gsyn[2:2 + L]
                  + state.vg.curr * gsyn[2 + L:2 + 2 * L]) / acoslat
        sp_adv = {}
        for i, attr in enumerate(sp_attrs):
            o = 2 + 2 * L + 2 * L * i
            sp_adv[attr.name] = -(state.ug.curr * gsyn[o:o + L]
                                  + state.vg.curr * gsyn[o + L:o + 2 * L]) / acoslat
        dx_psg = state.psg.curr * dx_lnps / (T.radius * coslat)
        dy_psg = state.psg.curr * dy_lnps / (T.radius * coslat)

        if c.use_virtual_temperature and "sphum" in state.tracers:
            virt_t = pg.virtual_temperature(state.tg.curr, state.tracers["sphum"].curr, C.zvir)
        else:
            virt_t = state.tg.curr
        du_pgf, dv_pgf, dt_econv, dps_tend, wg, wg_full = self._four_in_one(
            state.divg.curr, state.ug.curr, state.vg.curr, virt_t, state.psg.curr,
            ln_p_half, ln_p_full, p_full, dx_psg, dy_psg,
        )
        dt_ug = dt_ug + du_pgf
        dt_vg = dt_vg + dv_pgf
        dt_tg = dt_tg + dt_econv

        # geopotential (hydrostatic)
        phig_full, _ = pg.compute_geopotential(
            C.rdgas, _lev_last(virt_t), _lev_last(ln_p_half), _lev_last(ln_p_full),
            surf_geopotential, self.top_is_zero, p_half=_lev_last(p_half),
        )
        phig_full = _lev_first(phig_full)

        # surface-pressure tendency (analyzed in the single batched
        # grid_to_spec below)
        dt_ln_psg = dps_tend / state.psg.curr

        # vertical advection (level-last helpers)
        dp3 = p_half[1:] - p_half[:-1]
        pick = lambda pair, scheme: pair.prev if scheme in _PREV_LEVEL_SCHEMES else pair.curr
        w_l, dp_l = _lev_last(wg), _lev_last(dp3)
        vadv = lambda x, scheme: _lev_first(
            va.vert_advection(delta_t, w_l, dp_l, _lev_last(x), scheme))
        dt_ug = dt_ug + vadv(pick(state.ug, c.uv_vert_advect_scheme), c.uv_vert_advect_scheme)
        dt_vg = dt_vg + vadv(pick(state.vg, c.uv_vert_advect_scheme), c.uv_vert_advect_scheme)
        dt_tg = dt_tg + vadv(pick(state.tg, c.t_vert_advect_scheme), c.t_vert_advect_scheme)

        # horizontal advection of T (advective form, gradients from the
        # batched synthesis above)
        dt_tg = dt_tg + t_adv

        # rotational terms
        abs_vor = state.vorg.curr + self.coriolis[None]
        dt_ug = dt_ug + abs_vor * state.vg.curr
        dt_vg = dt_vg - abs_vor * state.ug.curr

        # ---- spectral tracers, pass 1: grid-space tendencies (they join
        # the single batched analysis; update_tracers spectral branch,
        # spectral_dynamics.F90:1116-1160) ----
        dtracers = phys.dtracers or {}
        sp_dt = {}
        for attr in sp_attrs:
            trg = state.tracers[attr.name]
            dt_tr = sp_adv[attr.name]
            if dtracers.get(attr.name) is not None:
                dt_tr = dt_tr + dtracers[attr.name]
            dt_tr = dt_tr + vadv(pick(trg, attr.vert_scheme), attr.vert_scheme)
            if attr.hole_filling:
                dt_tr = water_borrowing(dt_tr, trg.prev, p_half, delta_t)
            sp_dt[attr.name] = dt_tr

        # ---- one batched analysis: (u,v)/cos for vor-div, T tendency,
        # Phi+KE, ln ps tendency, spectral tracer tendencies ----
        phi_plus_ke = phig_full + 0.5 * (state.ug.curr**2 + state.vg.curr**2)
        ana = tr.grid_to_spec(T, torch.cat(
            [dt_ug / coslat, dt_vg / coslat, dt_tg, phi_plus_ke, dt_ln_psg[None]]
            + [sp_dt[a.name] for a in sp_attrs], dim=0),
            truncate=False)
        tt = lambda s: tr.triangular_truncate(T, s)
        dt_vors, dt_divs = tr.vor_div_from_analysis(T, ana[:L], ana[L:2 * L])
        dt_ts = tt(ana[2 * L:3 * L])
        dt_divs = dt_divs - tr.laplacian(T, tt(ana[3 * L:4 * L]))
        dt_lnps = tt(ana[4 * L])
        sp_dts = {a.name: tt(ana[4 * L + 1 + i * L:4 * L + 1 + (i + 1) * L])
                  for i, a in enumerate(sp_attrs)}

        # semi-implicit correction
        if c.use_implicit:
            dt_divs, dt_ts, dt_lnps = implicit_correction(
                self.implicit, dt_divs, dt_ts, dt_lnps,
                state.divs, state.ts, state.lnps, delta_t,
            )

        # hyperdiffusion (+ top sponges)
        dt_vors = apply_damping(self.damping_vor, state.vors.prev, dt_vors, delta_t)
        dt_vors = apply_top_sponge(self.damping_vor, state.vors.prev, dt_vors, delta_t, "vor")
        dt_divs = apply_damping(self.damping_div, state.divs.prev, dt_divs, delta_t)
        dt_divs = apply_top_sponge(self.damping_div, state.divs.prev, dt_divs, delta_t, "div")
        dt_ts = apply_damping(self.damping, state.ts.prev, dt_ts, delta_t)

        # ---- leapfrog: part A (final substep) or inline-complete RAW ----
        rc, rw = c.robert_coeff, c.raw_filter_coeff
        if final:
            lnps, P_lnps = leapfrog_part_a(state.lnps, dt_lnps, delta_t, rc, rw)
            vors, P_vors = leapfrog_part_a(state.vors, dt_vors, delta_t, rc, rw)
            divs, P_divs = leapfrog_part_a(state.divs, dt_divs, delta_t, rc, rw)
            ts, P_ts = leapfrog_part_a(state.ts, dt_ts, delta_t, rc, rw)
        else:
            lnps = leapfrog(state.lnps, dt_lnps, delta_t, rc, rw)
            vors = leapfrog(state.vors, dt_vors, delta_t, rc, rw)
            divs = leapfrog(state.divs, dt_divs, delta_t, rc, rw)
            ts = leapfrog(state.ts, dt_ts, delta_t, rc, rw)

        # ---- spectral tracers, pass 2: damping + leapfrog (their future
        # grid values join the single batched synthesis below) ----
        new_tracers = dict(state.tracers)
        new_spec_tracers = dict(state.spec_tracers)
        tracer_partB = {}
        for attr in sp_attrs:
            trs = state.spec_tracers[attr.name]
            dt_trs = apply_damping(self.damping, trs.prev, sp_dts[attr.name], delta_t)
            if final:
                trs_new, tracer_partB[attr.name] = leapfrog_part_a(
                    trs, dt_trs, delta_t, attr.robert_coeff, rw)
            else:
                trs_new = leapfrog(trs, dt_trs, delta_t, attr.robert_coeff, rw)
            new_spec_tracers[attr.name] = trs_new

        # ---- one batched synthesis of every future grid field: prognostics,
        # winds (via uv_coeffs), spectral tracers ----
        U, V = tr.uv_coeffs_from_vor_div(T, vors.curr, divs.curr)
        synth = tr.spec_to_grid(T, torch.cat(
            [divs.curr, vors.curr, ts.curr, lnps.curr[None], U, V]
            + [new_spec_tracers[a.name].curr for a in sp_attrs], dim=0))
        divg_f = synth[:L]
        vorg_f = synth[L:2 * L]
        tg_f = synth[2 * L:3 * L]
        psg_f = torch.exp(synth[3 * L])
        ug_f = synth[3 * L + 1:4 * L + 1] / coslat
        vg_f = synth[4 * L + 1:5 * L + 1] / coslat
        for i, attr in enumerate(sp_attrs):
            trg_f = synth[5 * L + 1 + i * L:5 * L + 1 + (i + 1) * L]
            new_tracers[attr.name] = TwoLevel(state.tracers[attr.name].curr, trg_f)

        # ---- grid tracers (update_tracers, spectral_dynamics.F90:1116-1188) ----
        if c.do_water_correction:
            dq_phys = dtracers.get("sphum")
            q_prev_est = state.tracers["sphum"].prev
            if dq_phys is not None:
                q_prev_est = q_prev_est + delta_t * dq_phys
            mean_water_prev = self.mass_weighted_integral(q_prev_est, state.psg.prev)
        for attr in self.tracer_attrs:
            if attr.representation == "spectral":
                continue  # handled in the batched passes above
            trg = state.tracers[attr.name]
            dtr_phys = dtracers.get(attr.name)
            # grid tracer: forward from previous + van Leer horiz + FV vertical
            tr_future = trg.prev
            if dtr_phys is not None:
                tr_future = tr_future + delta_t * dtr_phys
            adv = fv.a_grid_horiz_advection(
                self.fv_geom, state.ug.curr, state.vg.curr, tr_future, delta_t)
            tr_future = tr_future + delta_t * adv
            tr_future = tr_future + delta_t * vadv(tr_future, attr.vert_scheme)
            if final:
                P_tr = trg.prev - 2.0 * trg.curr
                tracer_partB[attr.name] = P_tr
            else:
                # inline-complete filter on `current` only; the reference
                # overwrites the future with the unfiltered tr_future
                # (spectral_dynamics.F90:1164-1180 last assignment)
                P_tr = trg.prev - 2.0 * trg.curr + tr_future
            curr_filt = trg.curr + attr.robert_coeff * rw * P_tr
            new_tracers[attr.name] = TwoLevel(curr_filt, tr_future)

        # ---- global fixers (compute_corrections) on the future fields;
        # the (0, 0) coefficients are written into fresh copies ----
        if c.do_mass_correction:
            mean_ps_f = tr.area_weighted_mean(T, psg_f)
            mass_factor = mean_ps_prev / mean_ps_f
            psg_f = psg_f * mass_factor
            # grid mean equals the (0,0) coefficient in this normalization
            lnps = TwoLevel(lnps.prev,
                            self._add_to_mean_mode(lnps.curr, torch.log(mass_factor)))
        if c.do_energy_correction:
            energy_f = self.mass_weighted_integral(
                0.5 * (ug_f**2 + vg_f**2) + C.cp_air * tg_f, psg_f)
            t_corr = C.grav * (energy_prev - energy_f) / (C.cp_air * mean_ps_prev)
            tg_f = tg_f + t_corr
            ts = TwoLevel(ts.prev, self._add_to_mean_mode(ts.curr, t_corr))

        if c.do_water_correction:
            # rescale future moisture where p >= water_correction_limit so the
            # corrected-region mass integral restores the previous total
            # (spectral_dynamics.F90:1245-1283 incl. the MiMA limit extension)
            q_f = new_tracers["sphum"].curr
            mask = (p_full >= c.water_correction_limit).to(c.dtype)
            corr = self.mass_weighted_integral(q_f * mask, psg_f)
            not_corr = self.mass_weighted_integral(q_f * (1.0 - mask), psg_f)
            total = corr + not_corr
            base = torch.where(total > 0.0,
                               mean_water_prev / torch.where(total > 0, total, 1.0), 1.0)
            safe_corr = torch.where(corr > 0, corr, 1.0)
            factor = base * (1.0 + not_corr / safe_corr) - not_corr / safe_corr
            factor = torch.where((total > 0.0) & (corr > 0.0), factor, 1.0)
            q_f = torch.where(mask > 0, factor * q_f, q_f)
            new_tracers["sphum"] = TwoLevel(new_tracers["sphum"].prev, q_f)

        # ---- leapfrog part B (final substep only: filter completes with the
        # corrected future; non-final substeps used the inline filter) ----
        if final:
            lnps = leapfrog_part_b(lnps, P_lnps, rc, rw)
            vors = leapfrog_part_b(vors, P_vors, rc, rw)
            divs = leapfrog_part_b(divs, P_divs, rc, rw)
            ts = leapfrog_part_b(ts, P_ts, rc, rw)
            for attr in self.tracer_attrs:
                pairs = new_spec_tracers if attr.representation == "spectral" else new_tracers
                pairs[attr.name] = leapfrog_part_b(
                    pairs[attr.name], tracer_partB[attr.name], attr.robert_coeff, rw)

        advance = lambda old, fut: TwoLevel(old.curr, fut)
        return PrimitiveState(
            vors=vors, divs=divs, ts=ts, lnps=lnps,
            ug=advance(state.ug, ug_f), vg=advance(state.vg, vg_f),
            tg=advance(state.tg, tg_f), psg=advance(state.psg, psg_f),
            vorg=advance(state.vorg, vorg_f), divg=advance(state.divg, divg_f),
            tracers=new_tracers, spec_tracers=new_spec_tracers,
            wg_full=wg_full,
        )
