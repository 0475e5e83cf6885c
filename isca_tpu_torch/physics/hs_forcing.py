"""Held-Suarez (1994) forcing: Newtonian temperature relaxation + Rayleigh
boundary-layer friction.

Port of isca_tpu/physics/hs_forcing.py (reference:
src/atmos_param/hs_forcing/hs_forcing.F90:508-679, defaults :70-85).

  T_eq = max( T_strat - eps sin(lat),
              [T* - delv cos^2(lat) ln(p/p0)] (p/p0)^kappa )
  T*   = T0 - delh sin^2(lat) - eps sin(lat)
  k_T  = ka + (ks - ka) cos^4(lat) max(0, (sigma - sigma_b)/(1 - sigma_b))
  k_v  = kf max(0, (sigma - sigma_b)/(1 - sigma_b))
  dT/dt = -k_T (T - T_eq);  du/dt = -k_v u;  dv/dt = -k_v v
  optional: dT/dt += -(u du + v dv)/cp   (do_conserve_energy)

Negative ka/ks/kf are in days (reference flag convention). Called with fields at
the `previous` time level and pressures at `current` (atmosphere.F90:304-311).
"""

from __future__ import annotations

import dataclasses

import torch

from isca_tpu_torch.constants import Constants, EARTH
from isca_tpu_torch.dycore.primitive import GridTendencies


@dataclasses.dataclass(frozen=True)
class HSForcingConfig:
    t_zero: float = 315.0
    t_strat: float = 200.0
    delh: float = 60.0
    delv: float = 10.0
    eps: float = 0.0
    sigma_b: float = 0.7
    P00: float = 1.0e5
    ka: float = -40.0   # negative => days
    ks: float = -4.0
    kf: float = -1.0
    do_conserve_energy: bool = True
    # equilibrium_t_option: 'Held_Suarez' (default) | 'exoplanet' | 'from_file'
    # (exoplanet: T* from instantaneous coszen, hs_forcing.F90:571-583;
    # from_file: set HSForcing.teq_field to a level-first (L, lat, lon) or
    # (L, lat, 1) equilibrium-temperature tensor, hs_forcing.F90:458)
    equilibrium_t_option: str = "Held_Suarez"
    # relax winds toward a specified zonal-mean flow instead of Rayleigh
    # drag (hs_forcing.F90:96-97, 641-655); set HSForcing.u_spec / v_spec
    # to level-first (L, nlat, 1) target zonal means
    relax_to_specified_wind: bool = False
    # optional localized heating (Isidoro option, hs_forcing.F90:718-769)
    local_heating_srfamp: float = 0.0      # K/day at the surface
    local_heating_xwidth: float = 10.0     # degrees
    local_heating_ywidth: float = 10.0
    local_heating_xcenter: float = 180.0
    local_heating_ycenter: float = 45.0
    local_heating_vert_decay: float = 1.0e4  # Pa
    # optional boundary-layer tracer source/sink (trflux/trsink)
    trflux: float = 1.0e-5
    trsink: float = -4.0
    constants: Constants = EARTH


def _per_sec(k):
    return 1.0 / (-k * 86400.0) if k < 0 else (1.0 / k if k != 0 else 0.0)


class HSForcing:
    def __init__(self, config: HSForcingConfig, lats: torch.Tensor):
        """lats: (nlat,) radians, on the device and in the dtype of the run."""
        self.config = c = config
        self.tka = _per_sec(c.ka)
        self.tks = _per_sec(c.ks)
        self.vkf = _per_sec(c.kf)
        sin_lat = torch.sin(lats)[:, None]
        self.sin_lat = sin_lat
        self.cos_lat_2 = 1.0 - sin_lat**2
        self.cos_lat_4 = self.cos_lat_2**2
        self.t_star_lat = c.t_zero - c.delh * sin_lat**2 - c.eps * sin_lat
        self.tstr = c.t_strat - c.eps * sin_lat
        self.teq_field = None   # (L, lat, lon|1) for 'from_file'
        self.u_spec = None      # (L, lat, 1) zonal-mean wind targets
        self.v_spec = None

    def __call__(self, u, v, t, p_full, psg, coszen=None) -> GridTendencies:
        """All fields level-first (L, lat, lon); psg (lat, lon).

        coszen: optional instantaneous cosine of the zenith angle (lat, lon)
        for the 'exoplanet' equilibrium temperature option."""
        c = self.config
        C = c.constants
        kappa = C.rdgas / C.cp_air

        p_norm = p_full / c.P00
        ln_p = torch.log(p_norm)
        if c.equilibrium_t_option == "from_file" and self.teq_field is not None:
            teq = self.teq_field.expand(t.shape)
        else:
            if c.equilibrium_t_option == "exoplanet" and coszen is not None:
                t_star = c.t_zero - c.delh * (1.0 - coszen) - c.eps * self.sin_lat
                the = t_star[None] - c.delv * coszen[None] * ln_p
            else:
                the = self.t_star_lat[None] - c.delv * self.cos_lat_2[None] * ln_p
            teq = torch.maximum(the * p_norm**kappa, self.tstr[None])

        sigma = p_full / psg[None]
        sfac = torch.where(
            (sigma <= 1.0) & (sigma > c.sigma_b),
            (sigma - c.sigma_b) / (1.0 - c.sigma_b),
            torch.zeros_like(sigma),
        )
        tdamp = self.tka + (self.tks - self.tka) * self.cos_lat_4[None] * sfac
        dt_t = -tdamp * (t - teq)

        if c.relax_to_specified_wind and self.u_spec is not None:
            # relax zonal means toward the target at every level, rate vkf
            # (hs_forcing.F90:641-655)
            umean = u.mean(dim=-1, keepdim=True)
            vmean = v.mean(dim=-1, keepdim=True)
            dt_u = ((self.u_spec - umean) * self.vkf).expand(u.shape)
            dt_v = ((self.v_spec - vmean) * self.vkf).expand(v.shape)
        else:
            vfac = self.vkf * sfac
            dt_u = -vfac * u
            dt_v = -vfac * v
        if c.do_conserve_energy:
            dt_t = dt_t - (u * dt_u + v * dt_v) / C.cp_air

        if c.local_heating_srfamp != 0.0:
            dt_t = dt_t + self.local_heating(p_full, psg)
        return GridTendencies(du=dt_u, dv=dt_v, dt=dt_t)

    def local_heating(self, p_full, psg):
        """Isidoro-option localized heating: Gaussian in lon/lat, decaying
        exponentially with pressure depth (hs_forcing.F90:718-769)."""
        c = self.config
        amp = c.local_heating_srfamp / 86400.0   # K/day -> K/s
        lat_deg = torch.rad2deg(torch.arcsin(self.sin_lat[:, 0]))[:, None]
        nlon = p_full.shape[-1]
        lon_deg = (torch.arange(nlon, dtype=p_full.dtype, device=p_full.device)
                   * (360.0 / nlon))[None, :]
        dlon = torch.abs(lon_deg - c.local_heating_xcenter)
        dlon = torch.minimum(dlon, 360.0 - dlon)
        lonf = torch.exp(-0.5 * (dlon / c.local_heating_xwidth) ** 2)
        latf = torch.exp(-0.5 * ((lat_deg - c.local_heating_ycenter) / c.local_heating_ywidth) ** 2)
        pfac = torch.exp((p_full - psg[None]) / c.local_heating_vert_decay)
        return amp * (lonf * latf)[None] * pfac

    def tracer_source_sink(self, r, p_half):
        """Surface-flux source + uniform sink for the optional HS tracer
        (hs_forcing.F90:683-716). Level-first tensors; p_half (L+1, lat, lon)."""
        c = self.config
        rdamp = c.trsink * (-86400.0 if c.trsink < 0 else 1.0)
        rdamp = 1.0 / rdamp if rdamp != 0 else 0.0
        pmass = p_half[-1] - p_half[-2]
        source = torch.cat([torch.zeros_like(r[:-1]), (c.trflux / pmass)[None]], dim=0)
        return source - rdamp * r
