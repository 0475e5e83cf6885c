"""SOCRATES radiation: spectral-file-driven correlated-k two-stream solver.

Port of isca_tpu/physics/socrates.py, isca_tpu's implementation of the
radiative transfer the reference reaches through the external UK Met Office
SOCRATES core (src/atmos_param/socrates/interface/socrates_calc.F90:
set_control/set_atm/set_bound/set_cld staging then the radiance solver):

  * Gas optics: all bands' major-gas ESFT k-terms are packed into one flat
    "g-point" axis G (28 for the synthetic SW spectrum); minor gases in a
    band contribute their weight-averaged grey extinction (SOCRATES'
    "equivalent extinction" overlap, i_gas_overlap = k_eqv), scattered onto
    their bands with `index_add_`, and the H2O continuum adds band-wise
    absorption. tau is one (..., L, G) tensor.
  * SW: delta-rescaled two-stream (PIFM) + vertical adding through the
    shared `sw_flux_solve` of the RRTMG-SW port (the CUDA kernel
    csrc/sw_flux.cu on CUDA tensors), with per-g incident flux
    S0 * solar_frac[band] * w_k. Every input reaches it full-shaped and
    contiguous, the cloud fraction expanded to (..., L, G).
  * LW: non-scattering linear-in-tau source with diffusivity 1.66 and
    total-sky cloud blending, split into a downward pass (surface LW down,
    t_surf independent) and an upward completion, the same down/up seam the
    grey scheme exposes; isca_tpu's two `lax.scan` sweeps are level loops.
  * Clouds: Slingo-type droplet/ice parametrizations from the spectral file
    (blocks 10/12), fed by SimCloud fields like the RRTM coupling.

The scheme runs in its own dtype, float32 unless the caller asks for
another, whatever the model's: isca_tpu's driver builds it without a dtype,
so a float64 GCM gets float32 SOCRATES heating, and so does the port's.
Spectral data are put on the device once, at construction.

Spectral files come from `socrates_spectral` (Met Office text format reader
+ synthetic ga7-like spectra for use without downloaded files).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

import isca_tpu_torch.physics.astronomy as astro
from isca_tpu_torch import resolve_device
from isca_tpu_torch.constants import Constants, EARTH
from isca_tpu_torch.physics.rrtmg_sw import sw_flux_solve
from isca_tpu_torch.physics.socrates_spectral import (
    IP_CFC11, IP_CFC12, IP_CH4, IP_CO2, IP_H2O, IP_N2O, IP_O2, IP_O3, IP_SO2,
    MOLAR_MASS, MOLAR_MASS_AIR, SCALE_NULL, SCALE_POWER_LAW, SCALE_POWER_QUAD,
    SpectrumData, read_spectral_file, synthetic_lw_spectrum,
    synthetic_sw_spectrum,
)
from isca_tpu_torch.physics.two_stream_gray import RadDownResult, RadResult

STEFAN = 5.670374419e-8


# ---------------------------------------------------------------------------
# Precomputed band/g-point packing (numpy at init)
# ---------------------------------------------------------------------------

class _Packed(NamedTuple):
    band_of_g: np.ndarray     # (G,) int
    w_g: np.ndarray           # (G,) ESFT weight
    k_g: np.ndarray           # (G,) major-gas k at reference
    gas_of_g: np.ndarray      # (G,) major-gas id
    fnc_g: np.ndarray         # (G,) scaling function type
    p0_g: np.ndarray
    t0_g: np.ndarray
    sc_g: np.ndarray          # (G, 4) scaling params zero-padded
    # minor (grey equivalent-extinction) terms: flat list over (band, gas)
    m_band: np.ndarray        # (M,)
    m_gas: np.ndarray         # (M,)
    m_kbar: np.ndarray        # (M,)
    m_fnc: np.ndarray
    m_p0: np.ndarray
    m_t0: np.ndarray
    m_sc: np.ndarray          # (M, 4)


def _pack(spec: SpectrumData) -> _Packed:
    """Per-g tables in band order, each band's ESFT terms in the order of
    its gas list (the spectral data's insertion order, as isca_tpu)."""
    bg, wg, kg, gg, fg, p0, t0, sc = [], [], [], [], [], [], [], []
    mb, mg, mk, mf, mp, mt, ms = [], [], [], [], [], [], []
    for b in range(spec.n_band):
        gases = [g for g in spec.band_gases[b] if (b, g) in spec.esft]
        if not gases:
            # no absorber: single transparent g-point keeps the band
            bg.append(b); wg.append(1.0); kg.append(0.0); gg.append(0)
            fg.append(SCALE_NULL); p0.append(1e5); t0.append(250.0)
            sc.append((0.0,) * 4)
            continue
        major, minors = gases[0], gases[1:]
        fit = spec.esft[(b, major)]
        pad = tuple(fit.scale) + (0.0,) * (4 - len(fit.scale))
        for i in range(len(fit.k)):
            bg.append(b); wg.append(float(fit.w[i])); kg.append(float(fit.k[i]))
            gg.append(major); fg.append(fit.scale_fnc)
            p0.append(fit.p_ref); t0.append(fit.t_ref); sc.append(pad)
        for g in minors:
            mfit = spec.esft[(b, g)]
            mb.append(b); mg.append(g)
            mk.append(float(np.sum(mfit.k * mfit.w)))
            mf.append(mfit.scale_fnc); mp.append(mfit.p_ref)
            mt.append(mfit.t_ref)
            ms.append(tuple(mfit.scale) + (0.0,) * (4 - len(mfit.scale)))
    z4 = np.zeros((0, 4))
    return _Packed(
        np.array(bg), np.array(wg), np.array(kg), np.array(gg),
        np.array(fg), np.array(p0), np.array(t0), np.array(sc),
        np.array(mb, int), np.array(mg, int), np.array(mk),
        np.array(mf, int) if mf else np.zeros(0, int),
        np.array(mp) if mp else np.zeros(0),
        np.array(mt) if mt else np.zeros(0),
        np.array(ms) if ms else z4)


def _scale_factor(fnc, p0, t0, sc, p, t):
    """Evaluate the k-scaling f(p,T) for stacked parameter arrays.

    fnc/p0/t0: (N,), sc: (N, 4); p, t: (..., L, 1).  Returns (..., L, N).
    """
    pr = p / p0
    tr = t / t0
    a, b_, c, d = sc[:, 0], sc[:, 1], sc[:, 2], sc[:, 3]
    power = pr ** a * tr ** b_
    x = tr - 1.0
    quad = pr ** a * (1.0 + c * x + d * x * x)
    return torch.where(fnc == SCALE_POWER_LAW, power,
                       torch.where(fnc == SCALE_POWER_QUAD, quad, 1.0))


class BandOptics(NamedTuple):
    """Per-g-point clear-sky optics, (..., L, G)."""
    tau_abs: torch.Tensor
    tau_ray: torch.Tensor        # zero for LW


class SocratesGasOptics:
    """Gas optics for one spectral file: mmr fields -> per-g optical depth.
    The packed tables live on `device` (None is CUDA) in `dtype`."""

    def __init__(self, spec: SpectrumData, dtype=torch.float32, device=None):
        self.spec = spec
        self.p = _pack(spec)
        self.dtype = dtype
        self.device = resolve_device(device)
        j = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)
        ji = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int64, device=self.device)
        P = self.p
        self.band_of_g = ji(P.band_of_g)
        self.w_g = j(P.w_g)
        self.k_g, self.fnc_g = j(P.k_g), ji(P.fnc_g)
        self.p0_g, self.t0_g, self.sc_g = j(P.p0_g), j(P.t0_g), j(P.sc_g)
        self.n_g = len(P.band_of_g)
        self.n_band = spec.n_band
        self.rayleigh_b = j(spec.rayleigh) if spec.rayleigh is not None else None
        self.m_band = ji(P.m_band)
        self.m_fnc, self.m_k = ji(P.m_fnc), j(P.m_kbar)
        self.m_p0, self.m_t0, self.m_sc = j(P.m_p0), j(P.m_t0), j(P.m_sc)
        self.cont_band = {b: ji([b]) for b in spec.continuum}

    def _as(self, x):
        return torch.as_tensor(x, dtype=self.dtype, device=self.device)

    def _path(self, mmr, d_mass):
        """Absorber path mmr * d_mass, mmr rounded to the dtype first (as
        isca_tpu's jnp.asarray(mmr, dtype)). A Python number is multiplied
        in, never copied to the device: such a copy waits for the device."""
        if isinstance(mmr, (int, float)):
            return d_mass * float(mmr)
        return self._as(mmr) * d_mass

    def __call__(self, p_full, t_full, d_mass, mmr: dict) -> BandOptics:
        """p_full/t_full/d_mass: (..., L); mmr: gas id -> (..., L) or scalar.

        d_mass = dp/g is the layer air mass [kg/m2].
        """
        p_full, t_full, d_mass = self._as(p_full), self._as(t_full), self._as(d_mass)
        P = self.p
        pe = p_full[..., None]
        te = t_full[..., None]
        # major-gas terms: tau_g = k_g * f_g(p,T) * u(major gas)
        f = _scale_factor(self.fnc_g, self.p0_g, self.t0_g, self.sc_g, pe, te)
        u_of = {}
        for g in set(P.gas_of_g.tolist()) | set(P.m_gas.tolist()):
            if g == 0:
                continue
            u_of[int(g)] = self._path(mmr.get(int(g), 0.0), d_mass)
        if u_of:
            u_stack = torch.stack(
                [u_of.get(int(g), torch.zeros_like(d_mass)) for g in P.gas_of_g],
                dim=-1)                                        # (..., L, G)
        else:
            u_stack = torch.zeros(d_mass.shape + (self.n_g,), dtype=self.dtype,
                                  device=self.device)
        tau = self.k_g * f * u_stack

        # minor gases: grey equivalent extinction accumulated per band
        if len(P.m_band):
            fm = _scale_factor(self.m_fnc, self.m_p0, self.m_t0, self.m_sc, pe, te)
            um = torch.stack([u_of.get(int(g), torch.zeros_like(d_mass))
                              for g in P.m_gas], dim=-1)
            tau_m = self.m_k * fm * um                       # (..., L, M)
            tau_b = torch.zeros(tau.shape[:-1] + (self.n_band,), dtype=self.dtype,
                                device=self.device)
            tau_b.index_add_(-1, self.m_band, tau_m)
            tau = tau + tau_b[..., self.band_of_g]

        # H2O continuum (self: scales with vapour pressure; foreign: dry air)
        if self.spec.continuum:
            q_h2o = mmr.get(IP_H2O, 0.0)
            if torch.is_tensor(q_h2o):
                q_h2o = self._as(q_h2o)
            u_h2o = self._path(q_h2o, d_mass)
            vmr = q_h2o * (MOLAR_MASS_AIR / MOLAR_MASS[IP_H2O])
            e_h2o = vmr * p_full
            tau_cb = torch.zeros(tau.shape[:-1] + (self.n_band,), dtype=self.dtype,
                                 device=self.device)
            for b, conts in self.spec.continuum.items():
                acc = 0.0
                for c in conts:
                    x = (e_h2o if c.self_broadened else p_full) / c.p_ref_c
                    acc = acc + (c.k * x ** c.alpha
                                 * (c.t_ref_c / t_full) ** c.beta) * u_h2o
                tau_cb.index_add_(-1, self.cont_band[b], acc[..., None])
            tau = tau + tau_cb[..., self.band_of_g]

        if self.rayleigh_b is not None:
            tau_ray = self.rayleigh_b[self.band_of_g] * d_mass[..., None]
        else:
            tau_ray = torch.zeros_like(tau)
        return BandOptics(tau_abs=tau, tau_ray=tau_ray)


def cloud_optics(coeffs, band_of_g, cwp, re, dtype):
    """Slingo parametrization: (tau, ssa, asy) per g-point.

    coeffs (nb, 6) = (a, b, c, d, e, f): tau = cwp (a + b/re),
    1 - ssa = c + d re, g = e + f re.  cwp [g/m2], re [um].
    """
    c = torch.as_tensor(coeffs, dtype=dtype, device=cwp.device)
    a, b = c[band_of_g, 0], c[band_of_g, 1]
    cc, d = c[band_of_g, 2], c[band_of_g, 3]
    e, f = c[band_of_g, 4], c[band_of_g, 5]
    re_ = torch.clamp(re, min=1.0)[..., None]
    tau = cwp[..., None] * (a + b / re_)
    ssa = torch.clamp(1.0 - (cc + d * re_), 0.0, 0.999999)
    asy = torch.clamp(e + f * re_, 0.0, 0.95)
    return tau, ssa, asy


# ---------------------------------------------------------------------------
# LW solve: non-scattering linear-in-tau with total-sky cloud blending
# ---------------------------------------------------------------------------

DIFFUSIVITY = 1.66


def _tfn(od):
    """Linear-in-tau transition function (shared form with the RRTMG port)."""
    ods = torch.clamp(od, min=1e-12)
    exact = 1.0 - 2.0 * (1.0 / ods - torch.exp(-ods) / (1.0 - torch.exp(-ods)))
    return torch.where(od < 0.06, od / 6.0, exact)


def planck_bands(planck, t_ref, T, dtype):
    """Evaluate the block-6 polynomial per band: (..., nb) [W/m2]."""
    T = torch.as_tensor(T, dtype=dtype)
    c = torch.as_tensor(planck, dtype=dtype, device=T.device)   # (nb, deg+1)
    x = T / t_ref
    powers = x[..., None] ** torch.arange(c.shape[1], dtype=dtype, device=T.device)
    return torch.einsum("...d,nd->...n", powers, c)


class LwDown(NamedTuple):
    """t_surf-independent LW state (down pass done, up pass pending)."""
    A: torch.Tensor          # (..., L, G) layer recursion coefficient
    Su: torch.Tensor         # (..., L, G) upward source
    radld_sfc: torch.Tensor  # (..., G) downward radiance at surface
    dflx: torch.Tensor       # (..., L+1) broadband downward flux (top-down)
    w_g: torch.Tensor        # (G,)


def lw_down_solve(tau_abs, tau_cld, cf, blay_g, blev_g, w_g):
    """Downward pass. tau_abs/tau_cld: (..., L, G); cf: (..., L) or None;
    blay_g/blev_g: per-g Planck at layers (..., L, G) / levels (..., L+1, G)
    (already including the ESFT weight); returns LwDown.

    Layers are ordered top to bottom (index 0 = top), half level 0 = TOA.
    """
    od = torch.clamp(DIFFUSIVITY * tau_abs, min=0.0)
    atrans = 1.0 - torch.exp(-od)
    tf = _tfn(od)
    dplankdn = blev_g[..., :-1, :] - blay_g
    dplankup = blev_g[..., 1:, :] - blay_g
    bbd = blay_g + tf * dplankdn
    bbu = blay_g + tf * dplankup

    if cf is not None:
        cfe = cf[..., None]
        odtot = od + DIFFUSIVITY * tau_cld
        atot = 1.0 - torch.exp(-odtot)
        tftot = _tfn(odtot)
        bbdtot = blay_g + tftot * dplankdn
        bbutot = blay_g + tftot * dplankup
        # total-sky blend of (transmission, source) by cloud fraction
        A = (1.0 - cfe) * (1.0 - atrans) + cfe * (1.0 - atot)
        Sd = (1.0 - cfe) * bbd * atrans + cfe * bbdtot * atot
        Su = (1.0 - cfe) * bbu * atrans + cfe * bbutot * atot
    else:
        A = 1.0 - atrans
        Sd = bbd * atrans
        Su = bbu * atrans

    # level loop (isca_tpu's lax.scan), top to bottom
    radld = torch.zeros_like(A[..., 0, :])
    levels = [radld]
    for l in range(A.shape[-2]):
        radld = A[..., l, :] * radld + Sd[..., l, :]
        levels.append(radld)
    # downward flux at half levels: pi * radiance already folded into B
    dn = torch.stack(levels, dim=-2)
    dflx = torch.sum(dn * w_g, dim=-1)
    return LwDown(A=A, Su=Su, radld_sfc=radld, dflx=dflx, w_g=w_g)


def lw_up_solve(down: LwDown, bsurf_g, emissivity):
    """Upward pass given surface Planck per g (weight included).

    Returns (uflx (..., L+1) top-down, olr)."""
    radup = emissivity * bsurf_g + (1.0 - emissivity) * down.radld_sfc
    # level loop (isca_tpu's reversed lax.scan), bottom layer to top
    levels = [radup]
    for l in range(down.A.shape[-2] - 1, -1, -1):
        radup = down.A[..., l, :] * radup + down.Su[..., l, :]
        levels.append(radup)
    up = torch.stack(levels[::-1], dim=-2)      # top-down ordering
    uflx = torch.sum(up * down.w_g, dim=-1)
    olr = torch.sum(radup * down.w_g, dim=-1)
    return uflx, olr


# ---------------------------------------------------------------------------
# Configuration + adapter (socrates_rad_nml surface)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SocratesConfig:
    """socrates_rad_nml (socrates_config_mod.f90:17-133).

    Spectral filenames accept a Met Office spectral-file path or
    'synthetic' / 'unset' to use the built-in ga7-like synthetic spectra.
    """
    stellar_constant: float = 1368.22
    tidally_locked: bool = False
    frierson_solar_rad: bool = False  # Frierson P2 annual-mean insolation
    del_sol: float = 1.4
    del_sw: float = 0.0
    socrates_hires_mode: bool = False
    lw_spectral_filename: str = "synthetic"
    lw_hires_spectral_filename: str = "unset"
    sw_spectral_filename: str = "synthetic"
    sw_hires_spectral_filename: str = "unset"
    account_for_effect_of_water: bool = True
    account_for_effect_of_ozone: bool = True
    do_read_ozone: bool = False       # driver feeds o3_field (time_interp)
    ozone_file_name: str = "ozone"
    ozone_field_name: str = "ozone"
    input_o3_file_is_mmr: bool = True
    do_read_co2: bool = False         # driver feeds carbon_conc (TimeSeries)
    co2_file_name: str = "co2"
    co2_field_name: str = "co2"
    input_planet_emissivity: float = 1.0
    co2_ppmv: float = 300.0
    input_co2_mmr: bool = False
    use_pressure_interp_for_half_levels: bool = False
    # incoming-solar options
    solday: int = 0
    do_rad_time_avg: bool = True
    equinox_day: float = 0.75
    # radiation timestep controls (handled by the moist driver's RadCache)
    dt_rad: int = 0
    store_intermediate_rad: bool = True
    dt_rad_avg: int = -1
    # well-mixed gases, mass mixing ratios (socrates_config_mod.f90:62-72)
    co_mix_ratio: float = 0.0
    n2o_mix_ratio: float = 4.945e-7
    ch4_mix_ratio: float = 1.006e-6
    o2_mix_ratio: float = 0.2314
    so2_mix_ratio: float = 0.0
    cfc11_mix_ratio: float = 1.110e-9
    cfc12_mix_ratio: float = 2.187e-9
    inc_h2o: bool = True
    inc_co2: bool = True
    inc_co: bool = False
    inc_o3: bool = True
    inc_n2o: bool = False
    inc_ch4: bool = False
    inc_o2: bool = False
    inc_so2: bool = False
    inc_cfc11: bool = False
    inc_cfc12: bool = False
    o3_mmr: float = 0.0               # constant-profile fallback
    # SimCloud coupling (socrates_init args, idealized_moist_phys.F90:795)
    do_cloud_simple: bool = False
    constants: Constants = EARTH


def _load_spectrum(path_or_synth, sw: bool) -> SpectrumData:
    if path_or_synth in ("synthetic", "", None, "unset"):
        return synthetic_sw_spectrum() if sw else synthetic_lw_spectrum()
    return read_spectral_file(path_or_synth)


class SocratesRadiation:
    """SOCRATES scheme with the TwoStreamGray down()/up() driver interface.

    Mirrors run_socrates (socrates_interface.F90:871-1507): staged inputs,
    LW+SW solves, heating rates, net surf SW down + surf LW down outputs;
    dt_rad substepping and stored fluxes are handled by the moist driver's
    RadCache as for RRTM. Every input is cast to `dtype` (float32 unless
    asked otherwise); the spectral data live on `device` (None is CUDA).
    Each down() and up() call runs inside a profiler range "socrates".
    """

    def __init__(self, config: SocratesConfig = SocratesConfig(),
                 sw_spectrum: SpectrumData | None = None,
                 lw_spectrum: SpectrumData | None = None,
                 dtype=torch.float32, device=None):
        self.config = config
        self.dtype = dtype
        self.device = resolve_device(device)
        self.sw_spec = sw_spectrum or _load_spectrum(
            config.sw_spectral_filename, sw=True)
        self.lw_spec = lw_spectrum or _load_spectrum(
            config.lw_spectral_filename, sw=False)
        self.sw_gas = SocratesGasOptics(self.sw_spec, dtype, self.device)
        self.lw_gas = SocratesGasOptics(self.lw_spec, dtype, self.device)
        on = lambda a: None if a is None else torch.as_tensor(
            np.asarray(a), dtype=dtype, device=self.device)
        self._lw_planck = on(self.lw_spec.planck)
        self._solar_frac = on(self.sw_spec.solar_frac)
        self._coeffs = {name: (on(spec.drop_coeffs), on(spec.ice_coeffs))
                        for name, spec in (("sw", self.sw_spec), ("lw", self.lw_spec))}
        self.o3_field = None          # optional (..., L) mmr set by the driver

    def _as(self, x):
        return torch.as_tensor(x, dtype=self.dtype, device=self.device)

    # -- gas staging ------------------------------------------------------
    def _mmr(self, q, co2_vmr):
        cfg = self.config
        vmr2mmr = lambda g, v: v * (MOLAR_MASS[g] / MOLAR_MASS_AIR)
        mmr = {}
        if cfg.inc_h2o and cfg.account_for_effect_of_water:
            mmr[IP_H2O] = q
        if cfg.inc_co2:
            mmr[IP_CO2] = vmr2mmr(IP_CO2, co2_vmr)
        if cfg.inc_o3 and cfg.account_for_effect_of_ozone:
            mmr[IP_O3] = self.o3_field if self.o3_field is not None else cfg.o3_mmr
        if cfg.inc_n2o:
            mmr[IP_N2O] = cfg.n2o_mix_ratio
        if cfg.inc_ch4:
            mmr[IP_CH4] = cfg.ch4_mix_ratio
        if cfg.inc_o2:
            mmr[IP_O2] = cfg.o2_mix_ratio
        if cfg.inc_so2:
            mmr[IP_SO2] = cfg.so2_mix_ratio
        if cfg.inc_cfc11:
            mmr[IP_CFC11] = cfg.cfc11_mix_ratio
        if cfg.inc_cfc12:
            mmr[IP_CFC12] = cfg.cfc12_mix_ratio
        return mmr

    def _cloud_optics(self, which, band_of_g, clwp, ciwp, reff):
        """Liquid and ice Slingo optics of one spectrum, or None."""
        drop, ice = self._coeffs[which]
        if drop is None or ice is None:
            return None
        return (cloud_optics(drop, band_of_g, clwp, reff, self.dtype),
                cloud_optics(ice, band_of_g, ciwp, reff, self.dtype))

    def down(self, lat, lon, p_half, t, q, albedo, gmt=0.0, time_since_ae=0.0,
             dt_rad_avg=None, carbon_conc=None, cloud_fields=None) -> RadDownResult:
        with record_function("socrates"):
            return self._down(lat, lon, p_half, t, q, albedo, gmt, time_since_ae,
                              dt_rad_avg, carbon_conc, cloud_fields)

    def _down(self, lat, lon, p_half, t, q, albedo, gmt, time_since_ae,
              dt_rad_avg, carbon_conc, cloud_fields) -> RadDownResult:
        cfg, C = self.config, self.config.constants
        dt = self.dtype
        p_half, t, q, albedo, lat, lon = map(self._as, (p_half, t, q, albedo, lat, lon))
        p_full = 0.5 * (p_half[..., :-1] + p_half[..., 1:])
        d_mass = (p_half[..., 1:] - p_half[..., :-1]) / C.grav
        co2_vmr = (carbon_conc * 1e-6 if carbon_conc is not None
                   else cfg.co2_ppmv * 1e-6)
        mmr = self._mmr(q, co2_vmr)

        # ---- insolation ----
        if cfg.frierson_solar_rad:
            # Frierson annual-mean P2 profile (socrates_config_mod.f90:22-24)
            p2 = (1.0 - 3.0 * torch.sin(lat) ** 2) / 4.0
            coszen = torch.clamp(
                0.25 * (1.0 + cfg.del_sol * p2 + cfg.del_sw * torch.sin(lat)), min=0.0)
            rr = 1.0
        else:
            orbit = astro.Orbit()
            dtr = dt_rad_avg if cfg.do_rad_time_avg else None
            coszen, frac, rr = astro.diurnal_solar(
                orbit, lat, lon, gmt, time_since_ae, dtr)
            coszen = coszen * frac

        # ---- clouds from SimCloud (cf, reff [um], qcl [kg/kg], frac_liq) --
        sw_cloud = None
        lw_tau_cld, lw_cf = None, None
        if cloud_fields is not None:
            cf, reff, qcl, frac_liq = map(self._as, cloud_fields)
            dp = p_half[..., 1:] - p_half[..., :-1]
            cwp = qcl / torch.clamp(cf, min=1e-4) * dp / C.grav * 1.0e3  # g/m2
            cwp = torch.where(cf > 1e-4, cwp, 0.0)
            clwp, ciwp = cwp * frac_liq, cwp * (1.0 - frac_liq)
            sw = self._cloud_optics("sw", self.sw_gas.band_of_g, clwp, ciwp, reff)
            if sw is not None:
                (tl, sl, gl), (ti, si, gi) = sw
                tau = tl + ti
                scat = sl * tl + si * ti
                ssa = torch.where(tau > 0, scat / torch.clamp(tau, min=1e-12), 0.0)
                asy = torch.where(scat > 0, (gl * sl * tl + gi * si * ti)
                                  / torch.clamp(scat, min=1e-12), 0.0)
                sw_cloud = (tau, ssa, asy, cf[..., None])
            lw = self._cloud_optics("lw", self.lw_gas.band_of_g, clwp, ciwp, reff)
            if lw is not None:
                # LW Slingo coefficients are absorption-only (a + b/re)
                lw_tau_cld = lw[0][0] + lw[1][0]
                lw_cf = cf

        # ---- LW down ----
        lw = self.lw_gas(p_full, t, d_mass, mmr)
        # half-level temperatures (plain mean + extrapolated ends,
        # socrates_interface.F90 t_half staging)
        t_half = torch.cat([
            t[..., :1],
            0.5 * (t[..., 1:] + t[..., :-1]),
            1.5 * t[..., -1:] - 0.5 * t[..., -2:-1]], dim=-1)
        t_ref = self.lw_spec.t_ref_planck
        band_of_g = self.lw_gas.band_of_g
        blay_g = planck_bands(self._lw_planck, t_ref, t, dt)[..., band_of_g]
        blev_g = planck_bands(self._lw_planck, t_ref, t_half, dt)[..., band_of_g]
        self._lw_down = lw_down_solve(
            lw.tau_abs, lw_tau_cld, lw_cf, blay_g, blev_g, self.lw_gas.w_g)
        surf_lw_down = self._lw_down.dflx[..., -1]

        # ---- SW ----
        sw = self.sw_gas(p_full, t, d_mass, mmr)
        tau_tot = torch.clamp(sw.tau_abs + sw.tau_ray, min=1e-9)
        w0 = torch.clamp(sw.tau_ray / tau_tot, 0.0, 0.999999)
        g0 = torch.zeros_like(tau_tot)          # Rayleigh: isotropic
        layer = tau_tot.shape
        cloud = None
        if sw_cloud is not None:
            tc, sc_, gc, cfe = sw_cloud
            tau_o = tau_tot + tc
            scat_o = sw.tau_ray + sc_ * tc
            w0_o = torch.clamp(scat_o / torch.clamp(tau_o, min=1e-9), 0.0, 0.999999)
            g_o = torch.where(scat_o > 0,
                              gc * sc_ * tc / torch.clamp(scat_o, min=1e-12), 0.0)
            # the card's kernel takes the cloud fraction full-shaped, (..., L, G)
            cloud = (tau_o, w0_o, g_o, cfe.expand(layer).contiguous())
        batch = layer[:-2]
        G = layer[-1]
        mu0 = torch.clamp(coszen, min=1e-6)[..., None, None].expand(
            batch + (1, 1)).contiguous()
        zincflx = (self.sw_gas.w_g * self._solar_frac[self.sw_gas.band_of_g]
                   * cfg.stellar_constant * rr
                   * torch.clamp(coszen, min=0.0)[..., None]).expand(batch + (G,)).contiguous()
        alb_g = (albedo[..., None] * torch.ones_like(self.sw_gas.w_g)).expand(
            batch + (G,)).contiguous()
        swd, swu, dird = sw_flux_solve(
            tau_tot, w0, g0, mu0, alb_g, alb_g, zincflx, cloud=cloud)
        # night columns give zeros, not the solve's output
        daylight = (coszen > 0.0)[..., None]
        swd = torch.where(daylight, swd, 0.0)
        swu = torch.where(daylight, swu, 0.0)
        self._sw_up = swu
        dp_half = p_half[..., 1:] - p_half[..., :-1]
        self._sw_heat = (C.grav / C.cp_air
                         * (swd[..., :-1] - swd[..., 1:]
                            + swu[..., 1:] - swu[..., :-1]) / dp_half)
        net_surf_sw_down = swd[..., -1] - swu[..., -1]

        zl = torch.zeros_like(t)
        return RadDownResult(
            net_surf_sw_down=net_surf_sw_down,
            surf_lw_down=surf_lw_down,
            lw_down=self._lw_down.dflx,
            sw_down=swd,
            coszen=coszen,
            insolation=cfg.stellar_constant * coszen,
            lw_dtrans=zl, lw_dtrans_win=zl, b=zl, b_win=zl,
        )

    def up(self, down: RadDownResult, p_half, t_surf, albedo) -> RadResult:
        """The LW upward pass from the surface emission at `t_surf` and the
        heating rates; completes the last down() call."""
        with record_function("socrates"):
            cfg, C = self.config, self.config.constants
            p_half, t_surf = self._as(p_half), self._as(t_surf)
            bsurf_b = planck_bands(self._lw_planck, self.lw_spec.t_ref_planck,
                                   t_surf, self.dtype)
            # per-g radiances are unweighted; the w_g reduction happens inside
            # lw_up_solve, matching lw_down_solve's convention
            bsurf_g = bsurf_b[..., self.lw_gas.band_of_g]
            uflx, olr = lw_up_solve(self._lw_down, bsurf_g, cfg.input_planet_emissivity)
            dp = p_half[..., 1:] - p_half[..., :-1]
            dflx = self._lw_down.dflx
            lw_heat = (C.grav / C.cp_air
                       * (dflx[..., :-1] - dflx[..., 1:]
                          + uflx[..., 1:] - uflx[..., :-1]) / dp)
            tdt_rad = lw_heat + self._sw_heat
            net_lw_surf = uflx[..., -1] - dflx[..., -1]
            return RadResult(
                tdt_rad=tdt_rad, tdt_solar=self._sw_heat, olr=olr,
                lw_up=uflx, sw_up=self._sw_up, net_lw_surf=net_lw_surf)
