"""SimCloud diagnostic cloud scheme (cloud fraction, particle size, water path).

Port of isca_tpu/physics/cloud_simple.py (reference SimCloud scheme:
  - src/atmos_param/cloud_simple/cloud_simple.F90:104-212 (driver: liquid
    fraction, effective radius, in-cloud water)
  - src/atmos_param/cloud_simple/large_scale_cloud.F90:144-334 (six RH-based
    stratiform cloud-fraction formulas + three critical-RH profiles + omega
    adjustment + polar freeze-dry)
  - src/atmos_param/cloud_simple/marine_strat_cloud.F90:131-520 (marine
    stratocumulus from inversion proxies: LTS / Slingo / EIS / ECTEI /
    Park-ELF)
  - src/atmos_param/cloud_simple/cloud_cover_diags.F90 (total/high/mid/low
    cloud amounts under maximum / random / maximum-random overlap)),
and of its SPOOKIE-protocol companion (cloud_spookie.F90).

Everything is a closed-form tensor expression over all columns at once: the
per-column level searches are argmins over the level axis (first index on
ties, as jnp.argmin), the inversion window a level mask, and the
maximum-random overlap regions a one-hot reduction over region ids built by
a cumulative sum.

Deviation kept from isca_tpu: the reference computes the exact LCL of
Romps (2017, JAS) via a Lambert-W evaluation (lcl.F90); this uses Bolton
(1980, MWR, eq. 15) for T_LCL followed by the dry adiabatic height.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from isca_tpu_torch.constants import Constants, EARTH

# Newtonian-gravity constants used by the reference's geopotential->geometric
# height conversion (marine_strat_cloud.F90:33-36, after MetPy).
EARTH_MASS = 5.9722e24       # kg
GRAV_CONST = 6.674e-11       # m^3 kg^-1 s^-2


@dataclasses.dataclass(frozen=True)
class LargeScaleCloudConfig:
    """large_scale_cloud_nml (large_scale_cloud.F90:62-71)."""
    formula: str = "LINEAR"   # SPOOKIE | SUNDQVIST | LINEAR | SMITH | SLINGO | XR96
    # piecewise-linear rhcrit profile
    rhcsfc: float = 0.95
    rhc700: float = 0.7
    rhc200: float = 0.3
    # fitted rhcrit profile
    do_fitted_rhcrit: bool = False
    rhc_surf: float = 0.8
    rhc_top: float = 0.4
    n_rhc: float = 3.1
    do_poly_rhcrit: bool = False
    # linear-coefficient profile
    linear_a_surf: float = 42.0
    linear_a_top: float = 12.0
    linear_power: float = 8.5
    # slingo80
    slingo_rhc_low: float = 0.8
    slingo_rhc_mid: float = 0.65
    slingo_rhc_high: float = 0.8
    # omega adjustment
    do_adjust_cld_by_omega: bool = False
    omega_adj_threshold: float = 0.1     # Pa/s
    adj_pres_threshold: float = 7.0e4    # Pa
    # polar freeze-dry (Vavrus & Waliser 2008)
    do_freezedry: bool = False
    qv_polar_val: float = 0.003          # kg/kg
    freezedry_power: float = 2.5


@dataclasses.dataclass(frozen=True)
class MarineStratConfig:
    """marine_strat_cloud_nml (marine_strat_cloud.F90:41-44)."""
    method: str = "PARK_ELF"   # LTS | SLINGO | EIS_WOOD | ECTEI | PARK_ELF
    dthdp_min_threshold: float = -0.05   # K/hPa
    park_a: float = 1.272
    park_b: float = -0.366


@dataclasses.dataclass(frozen=True)
class CloudSimpleConfig:
    """cloud_simple_nml (cloud_simple.F90:33-48)."""
    T_max: float = -5.0      # Celsius: all liquid above
    T_min: float = -40.0     # Celsius: all ice below
    reff_liq: float = 14.0   # micron
    reff_ice: float = 25.0   # micron
    qcl_val: float = 0.2     # g/kg in-cloud liquid
    do_qcl_with_temp: bool = True
    do_add_stratocumulus: bool = False
    do_cloud_cover_diags: bool = True
    overlap_assumption: str = "MAXIMUM-RANDOM"   # | MAXIMUM | RANDOM
    mid_cld_bottom: float = 7.0e4
    high_cld_bottom: float = 4.0e4
    large_scale: LargeScaleCloudConfig = LargeScaleCloudConfig()
    marine_strat: MarineStratConfig = MarineStratConfig()
    constants: Constants = EARTH


class CloudSimpleResult(NamedTuple):
    cf: torch.Tensor          # (..., L) cloud fraction 0-1
    reff_rad: torch.Tensor    # (..., L) effective radius [micron]
    qcl_rad: torch.Tensor     # (..., L) cloud liquid specific humidity [kg/kg]
    frac_liq: torch.Tensor    # (..., L) liquid fraction of condensate
    diagnostics: dict


def _t_lcl_bolton(t, rh):
    """Bolton (1980) eq. 22: LCL temperature from T [K] and RH [0-1]."""
    rh = torch.clamp(rh, 1e-4, 1.0)
    return 1.0 / (1.0 / (t - 55.0) - torch.log(rh) / 2840.0) + 55.0


def lcl_height(t_surf, rh_surf, C: Constants):
    """LCL height above surface [m]: dry-adiabatic lift to Bolton T_LCL.

    Stands in for the reference's Romps (2017) exact LCL (lcl.F90:36-191).
    """
    t_lcl = _t_lcl_bolton(t_surf, rh_surf)
    return torch.clamp(C.cp_air / C.grav * (t_surf - t_lcl), min=0.0)


def geopotential_to_height(z_geopot):
    """Geopotential height [m] -> geometric height [m].

    marine_strat_cloud.F90:288-296 (Newtonian gravity with MetPy constants);
    takes geopotential height (z = gh/g0) directly.
    """
    radius = 6.371e6
    scaled = z_geopot * 9.80 * radius
    return scaled * radius / (GRAV_CONST * EARTH_MASS - scaled)


# ---------------------------------------------------------------------------
# large-scale (stratiform) cloud fraction
# ---------------------------------------------------------------------------

def _rhcrit(cfg: LargeScaleCloudConfig, p_full):
    """Critical-RH profile (large_scale_cloud.F90:172-198)."""
    p_surf = 1.0e5
    if cfg.do_fitted_rhcrit:
        return cfg.rhc_top + (cfg.rhc_surf - cfg.rhc_top) * torch.exp(
            1.0 - (p_surf / p_full) ** cfg.n_rhc)
    if cfg.do_poly_rhcrit:
        rhc1, rhc2, zrhc = 0.8, 1.73, 0.95
        sigma = p_full / p_surf
        return zrhc - rhc1 * sigma * (1.0 - sigma) * (1.0 + rhc2 * (sigma - 0.5))
    low = cfg.rhcsfc - (cfg.rhcsfc - cfg.rhc700) * (p_surf - p_full) / (p_surf - 7.0e4)
    mid = cfg.rhc700 - (cfg.rhc700 - cfg.rhc200) * (7.0e4 - p_full) / 5.0e4
    return torch.where(p_full > 7.0e4, low,
                       torch.where(p_full > 2.0e4, mid, cfg.rhc200))


def large_scale_cloud_fraction(cfg: LargeScaleCloudConfig, p_full, ps, rh,
                               q_hum, qsat, qcl_rad, wg_full):
    """Stratiform cloud fraction (large_scale_cloud.F90:236-334)."""
    formula = cfg.formula.upper()
    rhcrit = _rhcrit(cfg, p_full)
    rh1 = torch.clamp(rh, max=1.0)

    if formula == "SPOOKIE":
        cf = (rh - rhcrit) / (1.0 - rhcrit)
    elif formula == "SUNDQVIST":
        cf = 1.0 - torch.sqrt(torch.clamp((1.0 - rh1) / (1.0 - rhcrit), min=0.0))
    elif formula == "SMITH":
        cf = 1.0 - (3.0 / math.sqrt(2.0) *
                    torch.clamp((1.0 - rh1) / (1.0 - rhcrit), min=0.0)) ** (2.0 / 3.0)
    elif formula == "SLINGO":
        rhc = torch.where(p_full > 8.0e4, cfg.slingo_rhc_low,
                          torch.where(p_full < 4.0e4, cfg.slingo_rhc_high,
                                      torch.full_like(p_full, cfg.slingo_rhc_mid)))
        cf = torch.where(rh < rhc, 0.0, ((rh - rhc) / (1.0 - rhc)) ** 2)
    elif formula == "XR96":
        p_para, alpha_0, gamma = 0.25, 100.0, 0.49
        denom = torch.clamp(qsat - q_hum, min=1e-12) ** gamma
        mid = torch.clamp(rh, 0.0, 1.0) ** p_para * (
            1.0 - torch.exp(-alpha_0 * qcl_rad / denom))
        cf = torch.where(rh >= 1.0, 1.0, torch.where(rh <= 0.0, 0.0, mid))
    elif formula == "LINEAR":
        coeff_a = cfg.linear_a_top + (cfg.linear_a_surf - cfg.linear_a_top) * torch.exp(
            1.0 - (ps[..., None] / p_full) ** cfg.linear_power)
        cf = coeff_a * (rh - 1.0) + 1.0
    else:
        raise ValueError(f"unknown cloud-fraction formula {cfg.formula!r}")
    cf = torch.clamp(cf, 0.0, 1.0)

    if cfg.do_adjust_cld_by_omega:
        # large_scale_cloud.F90:200-212: thin out (then remove) low cloud in
        # subsiding columns.
        deep = p_full > cfg.adj_pres_threshold
        scale = torch.clamp((cfg.omega_adj_threshold - wg_full)
                            / cfg.omega_adj_threshold, max=1.0)
        cf = torch.where(deep & (wg_full > 0.0) & (wg_full < cfg.omega_adj_threshold),
                         scale * cf, cf)
        cf = torch.where(deep & (wg_full >= cfg.omega_adj_threshold), 0.0, cf)

    if cfg.do_freezedry:
        # Vavrus & Waliser (2008) freeze-dry (large_scale_cloud.F90:215-234),
        # applied at all levels as the reference does.
        qv_k = (p_full / ps[..., None]) ** cfg.freezedry_power * cfg.qv_polar_val
        cf = cf * torch.clamp(q_hum / qv_k, 0.15, 1.0)
    return cf, rhcrit


# ---------------------------------------------------------------------------
# marine stratocumulus
# ---------------------------------------------------------------------------

def _k700(p_full):
    return torch.argmin(torch.abs(p_full - 7.0e4), dim=-1)


def _take_level(a, k):
    return torch.gather(a, -1, k[..., None])[..., 0]


def _moist_lapse_rate(t, p, C: Constants):
    """Saturated moist-adiabatic lapse rate [K/m] (marine_strat_cloud.F90:504-512).

    Uses the simple Clausius-Clapeyron es about TFREEZE that the reference's
    lookup_es tabulates.
    """
    es = 610.78 * torch.exp(-C.hlv / C.rvgas * (1.0 / t - 1.0 / C.tfreeze))
    qs = 0.622 * es / torch.clamp(p - es, min=1.0)
    num = 1.0 + C.hlv * qs / (C.rdgas * t)
    den = 1.0 + C.hlv ** 2 * qs / (C.cp_air * C.rvgas * t ** 2)
    return (C.grav / C.cp_air) * (1.0 - num / den)


def marine_strat_cloud(cfg: MarineStratConfig, C: Constants, temp, p_full,
                       p_half, z_full, rh, q_hum, temp_2m, q_2m, rh_2m, psg,
                       wg_full, ocean, cf, klcls=None):
    """Overwrite cf with inversion-capped stratocumulus over ocean.

    marine_strat_cloud.F90:131-248. The per-column kdthdp search and the
    two-level application window are level masks.
    """
    kappa = C.rdgas / C.cp_air
    pstar = 1.0e5
    L = temp.shape[-1]
    kidx = torch.arange(L, device=temp.device)

    # theta and dth/dp [K/hPa] with a 2m-surface extension at the bottom
    # (marine_strat_cloud.F90:455-478).
    theta = temp * (pstar / p_full) ** kappa
    dth_int = (theta[..., :-1] - theta[..., 1:]) / (
        p_half[..., 1:-1] - p_half[..., 2:]) * 1.0e2
    theta_0 = temp_2m * (pstar / psg) ** kappa
    dth_sfc = (theta[..., -1] - theta_0) / (p_half[..., -1] - psg) * 1.0e2
    dthdp = torch.cat([dth_int, dth_sfc[..., None]], dim=-1)

    # kdthdp: most negative dth/dp below 800 hPa that beats the threshold
    # (first level on ties; level 0 where none does, as jnp.argmin).
    mask = (p_full > 8.0e4) & (dthdp < cfg.dthdp_min_threshold)
    masked = torch.where(mask, dthdp, math.inf)
    kk = torch.argmin(masked, dim=-1)
    has_inv = torch.any(mask, dim=-1)

    # inversion-strength proxies (per column)
    k700 = _k700(p_full)
    t700 = _take_level(temp, k700)
    lts = t700 * (pstar / _take_level(p_full, k700)) ** kappa \
        - temp_2m * (pstar / psg) ** kappa
    z_height = geopotential_to_height(z_full)
    z700 = _take_level(z_height, k700)

    zlcl = lcl_height(temp_2m, rh_2m, C)
    if klcls is None:
        klcls = torch.argmin(torch.abs(z_height - zlcl[..., None]), dim=-1)

    method = cfg.method.upper()
    if method == "LTS":
        k_surf_theta = theta[..., -1]
        strat2d = torch.clamp((_take_level(theta, k700) - k_surf_theta) * 0.057
                              - 0.5573, 0.0, 1.0)
    elif method == "EIS_WOOD":
        t850 = 0.5 * (t700 + temp_2m)
        gamma850 = _moist_lapse_rate(t850, 8.5e4, C)
        eis = lts - gamma850 * (z700 - zlcl)
        strat2d = torch.clamp(0.06 * eis + 0.14, 0.0, 1.0)
    elif method == "ECTEI":
        t850 = 0.5 * (t700 + temp_2m)
        gamma850 = _moist_lapse_rate(t850, 8.5e4, C)
        eis = lts - gamma850 * (z700 - zlcl)
        k_en, c_qgap = 0.7, 0.76
        beta = (1.0 - k_en) * c_qgap
        q700 = _take_level(q_hum, k700)
        ectei = eis - beta * C.hlv / C.cp_air * (q_2m - q700)
        strat2d = torch.clamp(0.031 * ectei + 0.39, 0.0, 1.0)
    elif method == "PARK_ELF":
        # marine_strat_cloud.F90:411-501
        delta_zs = 2750.0
        plcl = _take_level(p_full, klcls)
        tlcl = _take_level(temp, klcls)
        zlcl_lvl = torch.clamp(lcl_height(temp_2m, rh_2m, C), min=0.0)
        gamma_dl = _moist_lapse_rate(tlcl, plcl, C)
        gamma700 = _moist_lapse_rate(t700, _take_level(p_full, k700), C)
        qv_ml = _take_level(q_hum, klcls)
        z_ml = zlcl_lvl
        zinv = -lts / gamma700 + z700 + delta_zs * (gamma_dl / gamma700)
        zinv = torch.minimum(torch.maximum(zinv, z_ml), z_ml + delta_zs)
        beta2 = torch.sqrt(torch.clamp(zinv * zlcl_lvl, min=0.0)) / delta_zs
        f_para = torch.clamp(qv_ml / 0.003, 0.15, 1.0)
        elf = f_para * (1.0 - beta2)
        strat2d = torch.clamp(cfg.park_a * elf + cfg.park_b, 0.0, 1.0)
    elif method == "SLINGO":
        strat2d = None   # per-level, handled below
    else:
        raise ValueError(f"unknown marine strat method {cfg.method!r}")

    # Application window: levels kk and kk+1 where subsiding, strong-gradient,
    # below 800hPa, over ocean with an inversion (marine_strat_cloud.F90:171-191).
    window = (kidx == kk[..., None]) | (kidx == torch.clamp(kk + 1, max=L - 1)[..., None])
    apply = (window & has_inv[..., None] & ocean[..., None]
             & (wg_full > 0.0) & (dthdp < cfg.dthdp_min_threshold)
             & (p_full > 8.0e4))

    if method == "SLINGO":
        strat = torch.clamp(-6.67 * dthdp - 0.667, 0.0, 1.0)
        kb = torch.clamp(kk + 1, max=L - 1)
        rhb = _take_level(rh, kb)
        rhb_frac = torch.clamp((rhb - 0.6) / 0.2, 0.0, 1.0)
        cand = torch.clamp(strat * rhb_frac[..., None], max=1.0)
    else:
        cand = strat2d[..., None].expand(cf.shape)

    new_cf = torch.where(apply, torch.maximum(cf, cand), cf)
    diag = {"lts": lts, "zlcl": zlcl, "dthdp": dthdp,
            "marine_strat": torch.where(apply, torch.clamp(new_cf, 0.0, 1.0), 0.0)}
    return new_cf, diag


# ---------------------------------------------------------------------------
# cloud-cover diagnostics (overlap assumptions)
# ---------------------------------------------------------------------------

def _band_cover_maxrnd(cf, in_band, rid, n_regions):
    """Cloud cover of one pressure band under maximum-random overlap.

    Within each contiguous cloudy region (same rid) layers overlap maximally;
    distinct regions combine randomly (cloud_cover_diags.F90:92-203 region
    machinery, as a one-hot reduction instead of the CAM index walk).
    """
    cfb = torch.where(in_band, cf, 0.0)
    # (..., L, R) one-hot of region membership
    onehot = rid[..., None] == torch.arange(n_regions, device=cf.device)
    per_region = torch.amax(torch.where(onehot, cfb[..., None], 0.0), dim=-2)
    clear = torch.prod(1.0 - per_region, dim=-1)
    return 1.0 - clear


def cloud_cover_diags(cf, p_full, p_half, overlap="MAXIMUM-RANDOM",
                      mid_cld_bottom=7.0e4, high_cld_bottom=4.0e4,
                      cf_min=0.0):
    """Total/low/mid/high cloud amounts (cloud_cover_diags.F90:68-379)."""
    L = cf.shape[-1]
    bands = {
        "tot_cld_amt": torch.ones_like(cf, dtype=torch.bool),
        "low_cld_amt": p_full > mid_cld_bottom,
        "mid_cld_amt": (p_full <= mid_cld_bottom) & (p_full > high_cld_bottom),
        "high_cld_amt": p_full <= high_cld_bottom,
    }
    overlap = overlap.upper()
    out = {}
    if overlap == "MAXIMUM":
        for name, band in bands.items():
            out[name] = torch.amax(torch.where(band, cf, 0.0), dim=-1)
    elif overlap == "RANDOM":
        for name, band in bands.items():
            out[name] = 1.0 - torch.prod(torch.where(band, 1.0 - cf, 1.0), dim=-1)
    elif overlap == "MAXIMUM-RANDOM":
        # Region id per level: count of completed cloudy blocks above.
        cloudy = cf > cf_min
        prev_cloudy = torch.cat(
            [torch.zeros_like(cloudy[..., :1]), cloudy[..., :-1]], dim=-1)
        new_block = cloudy & ~prev_cloudy
        rid = torch.cumsum(new_block.to(torch.int32), dim=-1) - 1
        rid = torch.where(cloudy, rid, -1)   # clear layers contribute nothing
        n_regions = (L + 1) // 2
        for name, band in bands.items():
            # rid = -1 on clear layers never matches a region slot
            out[name] = _band_cover_maxrnd(cf, band & (rid >= 0), rid, n_regions)
    else:
        raise ValueError(f"unknown overlap assumption {overlap!r}")
    return {k: v * 100.0 for k, v in out.items()}   # percent, as reference


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

class CloudSimple:
    """cloud_simple.F90:104-155 driver, as a pure callable."""

    def __init__(self, config: CloudSimpleConfig, svp):
        self.config = config
        self.svp = svp

    def __call__(self, p_half, p_full, temp, q_hum, z_full, wg_full, psg,
                 temp_2m=None, q_2m=None, rh_2m=None, klcls=None,
                 ocean=None) -> CloudSimpleResult:
        cfg = self.config
        C = cfg.constants
        qs = self.svp.qs(temp, p_full)
        rh_in_cf = q_hum / qs

        # liquid fraction: linear in T between T_min and T_max Celsius
        # (cloud_simple.F90:137-151)
        t_hi = C.tfreeze + cfg.T_max
        t_lo = C.tfreeze + cfg.T_min
        frac_liq = torch.clamp((temp - t_lo) / (t_hi - t_lo), 0.0, 1.0)
        reff_rad = cfg.reff_liq * frac_liq + cfg.reff_ice * (1.0 - frac_liq)

        # in-cloud water for the XR96 formula's first pass uses the previous
        # qcl; the reference initializes qcl_rad=1e-8 (idealized_moist_phys
        # .F90:1013) before the call.
        qcl_seed = torch.full_like(temp, 1e-8)
        cf, rhcrit = large_scale_cloud_fraction(
            cfg.large_scale, p_full, psg, rh_in_cf, q_hum, qs, qcl_seed, wg_full)
        diag = {"rh_in_cf": rh_in_cf * 100.0, "rhcrit": rhcrit * 100.0,
                "frac_liq": frac_liq}

        if cfg.do_add_stratocumulus:
            if temp_2m is None:
                temp_2m = temp[..., -1]
            if q_2m is None:
                q_2m = q_hum[..., -1]
            if rh_2m is None:
                rh_2m = torch.clamp(rh_in_cf[..., -1], 0.0, 1.0)
            if ocean is None:
                ocean = torch.ones(temp.shape[:-1], dtype=torch.bool, device=temp.device)
            cf, strat_diag = marine_strat_cloud(
                cfg.marine_strat, C, temp, p_full, p_half, z_full, rh_in_cf,
                q_hum, temp_2m, q_2m, rh_2m, psg, wg_full, ocean, cf, klcls)
            diag.update(strat_diag)

        # in-cloud water content -> qcl_rad (cloud_simple.F90:161-179)
        if cfg.do_qcl_with_temp:
            in_cloud_qcl = cfg.qcl_val * (temp - 220.0) / (280.0 - 220.0)
            in_cloud_qcl = torch.clamp(in_cloud_qcl, 3.0e-4, cfg.qcl_val) / 1.0e3
        else:
            in_cloud_qcl = 3.0e-4 + (1.0 - 3.0e-4) * (p_full - 2.0e4) / 8.0e4
            in_cloud_qcl = torch.clamp(in_cloud_qcl / 1.0e3, min=0.0)
        qcl_rad = cf * in_cloud_qcl

        if cfg.do_cloud_cover_diags:
            diag.update(cloud_cover_diags(
                cf, p_full, p_half, cfg.overlap_assumption,
                cfg.mid_cld_bottom, cfg.high_cld_bottom))

        diag.update(cf=cf, reff_rad=reff_rad, qcl_rad=qcl_rad)
        return CloudSimpleResult(cf=cf, reff_rad=reff_rad, qcl_rad=qcl_rad,
                                 frac_liq=frac_liq, diagnostics=diag)


# ---------------------------------------------------------------------------
# SPOOKIE-protocol cloud scheme (cloud_spookie.F90)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CloudSpookieConfig:
    """cloud_spookie_nml (cloud_spookie.F90: defaults at module head)."""
    spookie_protocol: int = 2
    cca_lower_limit: float = 0.0
    rhc_sfc: float = 1.0
    rhc_base: float = 0.7
    rhc_top: float = 0.2
    rh_min_sfc: float = 1.0
    rh_min_base: float = 0.8
    rh_min_top: float = 0.9
    rh_max_sfc: float = 1.0
    rh_max_base: float = 1.0
    rh_max_top: float = 1.0
    p_base: float = 70000.0
    p_top: float = 20000.0
    constants: Constants = EARTH


def cloud_spookie(cfg: CloudSpookieConfig, svp, p_full, temp, q_hum):
    """SPOOKIE comparison-protocol diagnostic clouds
    (cloud_spookie.F90:84-180): two fixed RH-ramp protocols, a hard-coded
    10/20 um liquid/ice effective radius and protocol-specific in-cloud
    water. Returns (cf, cca, reff_rad [um], qcl_rad [kg/kg], diagnostics)."""
    C = cfg.constants
    qs = svp.qs(temp, p_full)
    rh = q_hum / qs
    p_surf = p_full[..., -1:]

    frac_liq = torch.clamp(1.0 - (C.tfreeze - temp) / 40.0, 0.0, 1.0)
    reff_rad = 10.0 * frac_liq + 20.0 * (1.0 - frac_liq)

    def ramp(sfc, base, top):
        low = sfc - (sfc - base) * (p_surf - p_full) / (p_surf - cfg.p_base)
        mid = base - (base - top) * (cfg.p_base - p_full) / (cfg.p_base - cfg.p_top)
        return torch.where(p_full > cfg.p_base, low,
                           torch.where(p_full > cfg.p_top, mid, top))

    if cfg.spookie_protocol == 1:
        rhcrit = ramp(cfg.rhc_sfc, cfg.rhc_base, cfg.rhc_top)
        cf = (rh - rhcrit) / (1.0 - rhcrit)
        in_cloud_qcl = torch.clamp(
            3.0e-4 + (1.0 - 3.0e-4) * (p_full - cfg.p_top) / 80000.0, min=0.0)
        diag = {"simple_rhcrit": rhcrit * 100.0}
    else:
        rh_min = ramp(cfg.rh_min_sfc, cfg.rh_min_base, cfg.rh_min_top)
        rh_max = ramp(cfg.rh_max_sfc, cfg.rh_max_base, cfg.rh_max_top)
        cf = (rh - rh_min) / torch.clamp(rh_max - rh_min, min=1e-6)
        in_cloud_qcl = torch.clamp(0.2 * (temp - 220.0) / (280.0 - 220.0),
                                   3.0e-4, 0.2)
        diag = {"rh_min": rh_min * 100.0}
    cf = torch.clamp(cf, 0.0, 1.0)
    cca = torch.clamp(torch.zeros_like(cf), min=cfg.cca_lower_limit)
    qcl_rad = cf * in_cloud_qcl / 1000.0
    diag.update(cf=cf, reff_rad=reff_rad, frac_liq=frac_liq,
                qcl_rad=qcl_rad, rh_in_cf=rh * 100.0)
    return cf, cca, reff_rad, qcl_rad, diag
