"""RRTM radiation adapter: RRTMG-SW with the grey two-stream LW.

Port of isca_tpu/physics/rrtm_radiation.py (reference:
src/atmos_param/rrtm_radiation/rrtm_radiation.F90, the adapter that reshapes
model fields to RRTMG columns, manages ozone/CO2 inputs, the radiation-grid
cost controls and coszen averaging) with its grey-LW branch: RRTMG-SW
(`physics/rrtmg_sw.py`) paired with the Frierson/Byrne/Geen grey two-stream
LW, which is what a user of the reference runs from a bare checkout.
RRTMG-LW (`lw_scheme="rrtmg"`, and `"auto"`, which picks it when its k-tables
are installed) and SimCloud cloud optics are not ported yet and raise.

The adapter exposes the same down()/up() interface as TwoStreamGray so the
moist physics driver can switch schemes by configuration.
"""

from __future__ import annotations

import dataclasses

import torch

import isca_tpu_torch.physics.astronomy as astro
from isca_tpu_torch.constants import Constants, EARTH
from isca_tpu_torch.physics.rrtmg_sw import RRTMGSw, RRTMGSwConfig
from isca_tpu_torch.physics.two_stream_gray import (
    RadDownResult,
    RadResult,
    TwoStreamConfig,
    TwoStreamGray,
)


@dataclasses.dataclass(frozen=True)
class RRTMConfig:
    """rrtm_radiation_nml equivalents (rrtm_radiation.F90:150-205)."""
    co2ppmv: float = 300.0
    solr_cnst: float = 1368.22
    do_seasonal: bool = True
    use_time_average_coszen: bool = True
    solday: int = 0
    equinox_day: float = 0.75
    albedo_value: float = 0.25      # used only if driver passes none
    o3_mmr: float = 0.0             # constant ozone mass mixing ratio fallback
    # trace gases for the RRTMG-LW bands (a later slice of the port)
    n2ovmr: float = 3.2e-7
    ch4vmr: float = 1.8e-6
    # input guards before the k-distribution solver (rrtm_radiation.F90:
    # 147-149): radiation never sees q below h2o_lower_limit or T outside
    # [temp_lower_limit, temp_upper_limit]
    h2o_lower_limit: float = 2.0e-7
    temp_lower_limit: float = 100.0
    temp_upper_limit: float = 370.0
    # radiation-grid cost controls (rrtm_radiation.F90:156-177)
    lonstep: int = 1                # subsample fields along longitude
    do_zm_rad: bool = False         # return only zonal-mean radiation
    do_zm_tracers: bool = False     # feed zonal-mean q to radiation
    # LW scheme selection: "auto" = RRTMG-LW if its k-tables are installed,
    # else grey; "rrtmg" forces RRTMG-LW; "grey" forces the two-stream LW.
    # Only "grey" is ported so far.
    lw_scheme: str = "auto"
    # grey-LW companion configuration
    lw: TwoStreamConfig = TwoStreamConfig()
    constants: Constants = EARTH


def _lon_expand(a, k, zm=False):
    """Map a lonstep-subsampled (lat, lon/k, ...) field back to the full
    longitude grid: linear interpolation, toroidally closed
    (rrtm_radiation.F90:947-968); with zm, the zonal mean of the subsampled
    columns is broadcast instead (do_zm_rad)."""
    if zm:
        m = torch.mean(a, dim=1, keepdim=True)
        full = a.shape[:1] + (a.shape[1] * k,) + a.shape[2:]
        return m.expand(full)
    if k == 1:
        return a
    a1 = torch.roll(a, -1, dims=1)
    w = (torch.arange(k, dtype=a.dtype, device=a.device) / k).reshape(
        (1, 1, k) + (1,) * (a.dim() - 2))
    out = a[:, :, None] * (1.0 - w) + a1[:, :, None] * w
    return out.reshape(a.shape[:1] + (a.shape[1] * k,) + a.shape[2:])


class RRTMRadiation:
    """RRTMG-SW + grey-LW radiation, TwoStreamGray interface.

    Supports the reference adapter's radiation-grid cost controls: `lonstep`
    computes radiation every k-th longitude and linearly interpolates the
    heating/fluxes back; `do_zm_rad` returns the zonal mean; `do_zm_tracers`
    feeds zonally averaged humidity to radiation."""

    def __init__(self, config: RRTMConfig = RRTMConfig(), device=None):
        if config.lw_scheme != "grey":
            raise NotImplementedError(
                f"RRTMConfig(lw_scheme={config.lw_scheme!r}): RRTMG-LW is not "
                "ported yet (it comes with the radiation slice of the port); "
                "use lw_scheme='grey'")
        self.config = config
        C = config.constants
        self.sw = RRTMGSw(RRTMGSwConfig(
            scon=config.solr_cnst, co2vmr=config.co2ppmv * 1e-6,
            cp_air=C.cp_air, grav=C.grav), device=device)
        self.grey = TwoStreamGray(dataclasses.replace(config.lw, solar_constant=0.0))

    def down(self, lat, lon, p_half, t, q, albedo, gmt=0.0, time_since_ae=0.0,
             dt_rad_avg=None, carbon_conc=None, cloud_fields=None) -> RadDownResult:
        """The SW fluxes and the grey LW down sweep; what up() needs at the
        radiation (subsampled) resolution is kept on the instance, as
        isca_tpu's adapter keeps it: call up() after each down()."""
        if cloud_fields is not None:
            raise NotImplementedError(
                "RRTM radiation with cloud_fields (SimCloud -> cldprop_sw) is "
                "not ported yet; it comes with the SimCloud slice of the port")
        cfg = self.config
        # coszen with the same astronomy options as the reference adapter
        orbit = astro.Orbit()
        dtr = dt_rad_avg if cfg.use_time_average_coszen else None
        coszen, frac, rr = astro.diurnal_solar(orbit, lat, lon, gmt, time_since_ae, dtr)
        coszen = coszen * frac      # mean cos over the averaging window
        coszen_full = coszen

        o3 = torch.full_like(t, cfg.o3_mmr)
        if cfg.do_zm_tracers:
            q = torch.mean(q, dim=1, keepdim=True).expand(q.shape)

        # longitude subsampling (rrtm_radiation.F90 lonstep): radiation on
        # every k-th longitude column, interpolated back after the solve
        k = max(1, int(cfg.lonstep))
        if k > 1:
            if t.shape[1] % k:
                raise ValueError(f"lonstep={k} must divide nlon={t.shape[1]}")
            sub = lambda a: a[:, ::k]
            lat, lon, p_half, t, q, albedo, coszen, o3 = map(
                sub, (lat, lon, p_half, t, q, albedo, coszen, o3))

        p_full = 0.5 * (p_half[..., :-1] + p_half[..., 1:])
        co2 = carbon_conc * 1e-6 if carbon_conc is not None else None

        # input guards as the reference adapter applies before every RRTMG
        # call: the k-tables are only valid over a finite (T, q) range
        t = torch.clamp(t, cfg.temp_lower_limit, cfg.temp_upper_limit)
        q = torch.clamp(q, min=cfg.h2o_lower_limit)

        # ---- LW (grey) ----
        down_lw = self.grey.down(lat, lon, p_half, t, q, albedo,
                                 gmt=gmt, time_since_ae=time_since_ae,
                                 dt_rad_avg=dt_rad_avg)

        # ---- SW ----
        swf = self.sw(p_half, p_full, t, q, o3, coszen, albedo, albedo, co2vmr=co2)
        # Earth-sun distance factor scales incident flux (scalar rr)
        sw_down = swf.swdflx * rr
        sw_up = swf.swuflx * rr
        net_surf_sw_down = sw_down[..., -1] - sw_up[..., -1]
        self._k, self._grey_down = k, down_lw
        self._sw_heat, self._sw_up = swf.swhr * rr, sw_up
        ex = lambda a: _lon_expand(a, k, cfg.do_zm_rad)
        return RadDownResult(
            net_surf_sw_down=ex(net_surf_sw_down),
            surf_lw_down=ex(down_lw.surf_lw_down),
            lw_down=ex(down_lw.lw_down),
            sw_down=ex(sw_down),
            coszen=coszen_full,
            insolation=cfg.solr_cnst * coszen_full,
            lw_dtrans=ex(down_lw.lw_dtrans),
            lw_dtrans_win=ex(down_lw.lw_dtrans_win),
            b=ex(down_lw.b), b_win=ex(down_lw.b_win),
        )

    def up(self, down: RadDownResult, p_half, t_surf, albedo) -> RadResult:
        cfg = self.config
        k, sw_heat = self._k, self._sw_heat
        if k > 1:
            sub = lambda a: a[:, ::k]
            p_half, t_surf, albedo = map(sub, (p_half, t_surf, albedo))
        ex = lambda a: _lon_expand(a, k, cfg.do_zm_rad)
        lw = self.grey.up(self._grey_down, p_half, t_surf, albedo)
        # grey up() includes its own (zero-insolation) SW; add the RRTMG SW heating
        tdt_rad = lw.tdt_rad + sw_heat
        return RadResult(
            tdt_rad=ex(tdt_rad), tdt_solar=ex(sw_heat), olr=ex(lw.olr),
            lw_up=ex(lw.lw_up), sw_up=ex(self._sw_up), net_lw_surf=ex(lw.net_lw_surf))
