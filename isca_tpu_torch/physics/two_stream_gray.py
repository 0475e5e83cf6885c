"""Grey two-stream radiation (no scattering) with four optical-depth schemes.

Port of isca_tpu/physics/two_stream_gray.py (reference:
src/atmos_param/two_stream_gray_rad/two_stream_gray_rad.F90, :386-656 down
sweep, :659-776 up sweep). Schemes:

* 'frierson' (default): tau_lw = [ir_tau_eq + (pole-eq) sin^2(lat)] * odp *
  [linear_tau p/p0 + (1-linear_tau)(p/p0)^4]; SW pure attenuation with
  (1 - sw_diff sin^2) atm_abs (p/p0)^solar_exponent.
* 'byrne': d(tau) = (a mu + 0.17 ln(CO2/360) + b q) dp/p0.
* 'geen': two LW bands (window fraction) with q/CO2-dependent optical depths
  and q-dependent SW absorption.
* 'schneider': giant-planet power-law taus; interior heat flux enters via
  b_surf = surf_lw_down + net_surf_sw_down.

Split into down/up passes with the surface flux computed in between, as the
reference driver orders them. Cumulative sweeps loop over the level axis
(level-last tensors).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from isca_tpu_torch.constants import Constants, EARTH
from isca_tpu_torch.physics import astronomy as astro


@dataclasses.dataclass(frozen=True)
class TwoStreamConfig:
    rad_scheme: str = "frierson"   # frierson | byrne | geen | schneider
    solar_constant: float = 1360.0
    del_sol: float = 1.4
    del_sw: float = 0.0
    ir_tau_eq: float = 6.0
    ir_tau_pole: float = 1.5
    odp: float = 1.0
    atm_abs: float = 0.0
    sw_diff: float = 0.0
    linear_tau: float = 0.1
    wv_exponent: float = 4.0
    solar_exponent: float = 4.0
    do_seasonal: bool = False
    use_time_average_coszen: bool = False
    dt_rad_avg: float = -1.0
    solday: int = -10
    equinox_day: float = 0.75
    # byrne
    bog_a: float = 0.8678
    bog_b: float = 1997.9
    bog_mu: float = 1.0
    carbon_conc: float = 360.0
    # geen
    ir_tau_co2_win: float = 0.2150
    ir_tau_wv_win1: float = 147.11
    ir_tau_wv_win2: float = 1.0814e4
    ir_tau_co2: float = 0.1
    ir_tau_wv1: float = 23.8
    ir_tau_wv2: float = 254.0
    window: float = 0.3732
    # schneider (giant planet)
    lw_tau_0_gp: float = 80.0
    sw_tau_0_gp: float = 3.0
    lw_tau_exponent_gp: float = 2.0
    sw_tau_exponent_gp: float = 1.0
    gp_albedo: float = 0.343
    ga_asym: float = 0.77         # effective asymmetry attenuation factor
    diabatic_acce: float = 1.0
    orbit: astro.Orbit = astro.Orbit()
    constants: Constants = EARTH
    pstd_mks_earth: float = 101325.0


class RadDownResult(NamedTuple):
    net_surf_sw_down: torch.Tensor
    surf_lw_down: torch.Tensor
    lw_dtrans: torch.Tensor       # (..., L) per-layer LW transmission
    lw_down: torch.Tensor         # (..., L+1)
    sw_down: torch.Tensor         # (..., L+1)
    lw_dtrans_win: torch.Tensor   # geen only (ones otherwise)
    b: torch.Tensor               # (non-window) Planck emission per layer
    b_win: torch.Tensor
    coszen: torch.Tensor
    insolation: torch.Tensor


class RadResult(NamedTuple):
    tdt_rad: torch.Tensor
    tdt_solar: torch.Tensor
    olr: torch.Tensor
    lw_up: torch.Tensor
    sw_up: torch.Tensor
    net_lw_surf: torch.Tensor


def _log(x):
    """log of a Python scalar or a tensor."""
    return torch.log(x) if torch.is_tensor(x) else math.log(x)


def _cumulative_down(dtrans, b, top):
    """down(k+1) = down(k) dtrans(k) + b(k)(1 - dtrans(k)), down(0) = top."""
    downs = [top]
    for k in range(dtrans.shape[-1]):
        dt = dtrans[..., k]
        downs.append(downs[-1] * dt + b[..., k] * (1.0 - dt))
    return torch.stack(downs, dim=-1)


def _cumulative_up(dtrans, b, bottom):
    """up(k) = up(k+1) dtrans(k) + b(k)(1-dtrans(k)), up(L) = bottom."""
    L = dtrans.shape[-1]
    ups = [bottom]
    for k in range(L - 1, -1, -1):
        dt = dtrans[..., k]
        ups.append(ups[-1] * dt + b[..., k] * (1.0 - dt))
    return torch.stack(ups[::-1], dim=-1)


class TwoStreamGray:
    def __init__(self, config: TwoStreamConfig):
        self.config = config
        self.C = config.constants

    # ---------------- downward pass --------------------------------
    def down(self, lat, lon, p_half, t, q, albedo, gmt=0.0, time_since_ae=0.0,
             dt_rad_avg=None, carbon_conc=None) -> RadDownResult:
        """lat/lon (...,) broadcastable to columns; p_half (..., L+1); t,q (..., L).

        carbon_conc: optional runtime CO2 concentration (ppmv scalar),
        overriding cfg.carbon_conc (byrne/geen schemes)."""
        cfg, C = self.config, self.C
        co2 = cfg.carbon_conc if carbon_conc is None else carbon_conc
        scheme = cfg.rad_scheme.lower()
        p0 = C.pstd_mks

        # ---- insolation ----
        if cfg.do_seasonal:
            dt_rad = dt_rad_avg if cfg.use_time_average_coszen else None
            coszen, frac, rr = astro.diurnal_solar(
                cfg.orbit, lat, lon, gmt, time_since_ae, dt_rad)
            insolation = cfg.solar_constant * coszen * rr
        elif scheme == "schneider":
            coszen = torch.cos(lat)
            insolation = (cfg.solar_constant / math.pi) * torch.cos(lat)
        else:
            coszen = torch.zeros_like(lat)
            insolation = astro.annual_mean_p2_insolation(
                cfg.solar_constant, lat, cfg.del_sol, cfg.del_sw)

        # ---- shortwave down ----
        ins = insolation[..., None]
        if scheme == "geen":
            dpn = (p_half[..., 1:] - p_half[..., :-1]) / p_half[..., -1:]
            tau_k = torch.zeros_like(q[..., 0])
            sw_dt = []
            for k in range(q.shape[-1]):
                sw_wv = tau_k + 0.5194
                sw_wv = torch.exp(0.01887 / (tau_k + 0.009522) + 1.603 / (sw_wv * sw_wv))
                dtau = (0.0596 + 0.0029 * _log(co2 / 360.0)
                        + sw_wv * q[..., k]) * dpn[..., k]
                tau_k = tau_k + dtau
                sw_dt.append(torch.exp(-dtau))
            sw_dtrans = torch.stack(sw_dt, dim=-1)
            sw_down = ins * torch.cat(
                [torch.ones_like(sw_dtrans[..., :1]),
                 torch.cumprod(sw_dtrans, dim=-1)], dim=-1)
        elif scheme == "schneider":
            sw_tau = cfg.sw_tau_0_gp * (p_half / p0) ** cfg.sw_tau_exponent_gp
            sw_down = ins * (1.0 - cfg.gp_albedo) * torch.exp(-cfg.ga_asym * sw_tau)
        else:
            sw_tau0 = (1.0 - cfg.sw_diff * torch.sin(lat) ** 2) * cfg.atm_abs
            sw_tau = sw_tau0[..., None] * (p_half / p0) ** cfg.solar_exponent
            sw_down = ins * torch.exp(-sw_tau)

        # ---- longwave transmissions + down ----
        b_full = C.stefan * t**4
        b_win = torch.zeros_like(b_full)
        lw_dtrans_win = torch.ones_like(b_full)
        dp = p_half[..., 1:] - p_half[..., :-1]
        zero_top = torch.zeros_like(t[..., 0])
        if scheme == "geen":
            dtau = (cfg.ir_tau_co2 + 0.2023 * _log(co2 / 360.0)
                    + cfg.ir_tau_wv1 * torch.log(cfg.ir_tau_wv2 * q + 1.0)
                    ) * dp / cfg.pstd_mks_earth
            lw_dtrans = torch.exp(-dtau)
            dtau_w = (cfg.ir_tau_co2_win + 0.0954 * _log(co2 / 360.0)
                      + cfg.ir_tau_wv_win1 * q + cfg.ir_tau_wv_win2 * q * q
                      ) * dp / cfg.pstd_mks_earth
            lw_dtrans_win = torch.exp(-dtau_w)
            b_win = cfg.window * b_full
            b = (1.0 - cfg.window) * b_full
            lw_down = (_cumulative_down(lw_dtrans, b, zero_top)
                       + _cumulative_down(lw_dtrans_win, b_win, zero_top))
        elif scheme == "byrne":
            dtau = (cfg.bog_a * cfg.bog_mu + 0.17 * _log(co2 / 360.0)
                    + cfg.bog_b * q) * dp / cfg.pstd_mks_earth
            lw_dtrans = torch.exp(-dtau)
            b = b_full
            lw_down = _cumulative_down(lw_dtrans, b, zero_top)
        elif scheme == "schneider":
            lw_tau = cfg.lw_tau_0_gp * (p_half / p0) ** cfg.lw_tau_exponent_gp
            lw_dtrans = torch.exp(-(lw_tau[..., 1:] - lw_tau[..., :-1]))
            b = b_full
            lw_down = _cumulative_down(lw_dtrans, b, zero_top)
        else:  # frierson
            lw_tau0 = (cfg.ir_tau_eq
                       + (cfg.ir_tau_pole - cfg.ir_tau_eq) * torch.sin(lat) ** 2) * cfg.odp
            lw_tau = lw_tau0[..., None] * (
                cfg.linear_tau * p_half / p0
                + (1.0 - cfg.linear_tau) * (p_half / p0) ** cfg.wv_exponent)
            lw_dtrans = torch.exp(-(lw_tau[..., 1:] - lw_tau[..., :-1]))
            b = b_full
            lw_down = _cumulative_down(lw_dtrans, b, zero_top)

        surf_lw_down = lw_down[..., -1]
        net_surf_sw_down = sw_down[..., -1] * (1.0 - albedo)
        return RadDownResult(
            net_surf_sw_down=net_surf_sw_down, surf_lw_down=surf_lw_down,
            lw_dtrans=lw_dtrans, lw_down=lw_down, sw_down=sw_down,
            lw_dtrans_win=lw_dtrans_win, b=b, b_win=b_win,
            coszen=coszen, insolation=insolation,
        )

    # ---------------- upward pass ----------------------------------
    def up(self, down: RadDownResult, p_half, t_surf, albedo) -> RadResult:
        cfg, C = self.config, self.C
        scheme = cfg.rad_scheme.lower()
        b_surf = C.stefan * t_surf**4
        if scheme == "geen":
            lw_up = (
                _cumulative_up(down.lw_dtrans, down.b, b_surf * (1.0 - cfg.window))
                + _cumulative_up(down.lw_dtrans_win, down.b_win, b_surf * cfg.window))
        elif scheme == "schneider":
            b_surf_gp = down.surf_lw_down + down.net_surf_sw_down
            lw_up = _cumulative_up(down.lw_dtrans, down.b, b_surf_gp)
        else:
            lw_up = _cumulative_up(down.lw_dtrans, down.b, b_surf)

        sw_up = albedo[..., None] * down.sw_down[..., -1:]
        sw_up = sw_up.expand(down.sw_down.shape)
        lw_flux = lw_up - down.lw_down
        sw_flux = sw_up - down.sw_down
        rad_flux = lw_flux + sw_flux
        dp = p_half[..., 1:] - p_half[..., :-1]
        tdt_rad = cfg.diabatic_acce * (rad_flux[..., 1:] - rad_flux[..., :-1]) * (
            C.grav / (C.cp_air * dp))
        tdt_solar = (sw_flux[..., 1:] - sw_flux[..., :-1]) * (C.grav / (C.cp_air * dp))
        return RadResult(
            tdt_rad=tdt_rad, tdt_solar=tdt_solar, olr=lw_up[..., 0],
            lw_up=lw_up, sw_up=sw_up, net_lw_surf=lw_flux[..., -1],
        )
