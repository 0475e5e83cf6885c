"""RRTM radiation adapter: RRTMG-SW with RRTMG-LW or the grey two-stream LW.

Port of isca_tpu/physics/rrtm_radiation.py (reference:
src/atmos_param/rrtm_radiation/rrtm_radiation.F90, the adapter that reshapes
model fields to RRTMG columns, manages ozone/CO2 inputs, the radiation-grid
cost controls and coszen averaging): RRTMG-SW (`physics/rrtmg_sw.py`) paired
with RRTMG-LW (`physics/rrtmg_lw.py`; `lw_scheme="rrtmg"`, or `"auto"`, the
default, which picks it when its k-tables are installed, as they are) or with
the Frierson/Byrne/Geen grey two-stream LW (`lw_scheme="grey"`). SimCloud
fields (`cloud_fields`) become in-cloud water paths that feed RRTMG-SW's
cloudy solve through `cldprop_sw` and RRTMG-LW's through `cldprop_lw`.

The adapter exposes the same down()/up() interface as TwoStreamGray so the
moist physics driver can switch schemes by configuration.
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np
import torch
from torch.profiler import record_function

import isca_tpu_torch.physics.astronomy as astro
from isca_tpu_torch.constants import Constants, EARTH
from isca_tpu_torch.physics.rrtmg_lw import KG_NPZ, RRTMGLw, RRTMGLwConfig, kg_available
from isca_tpu_torch.physics.rrtmg_sw import RRTMGSw, RRTMGSwConfig, cldprop_sw
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
    # trace gases for the LW bands (rrtm_radiation.F90 has fixed defaults)
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
    lw_scheme: str = "auto"
    lw_kg_path: str | None = None   # explicit k-table npz (tests)
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
    """RRTMG-SW + (RRTMG-LW | grey-LW) radiation, TwoStreamGray interface.

    Supports the reference adapter's radiation-grid cost controls: `lonstep`
    computes radiation every k-th longitude and linearly interpolates the
    heating/fluxes back; `do_zm_rad` returns the zonal mean; `do_zm_tracers`
    feeds zonally averaged humidity to radiation."""

    def __init__(self, config: RRTMConfig = RRTMConfig(), device=None):
        self.config = config
        C = config.constants
        self.sw = RRTMGSw(RRTMGSwConfig(
            scon=config.solr_cnst, co2vmr=config.co2ppmv * 1e-6,
            cp_air=C.cp_air, grav=C.grav), device=device)
        # LW scheme selection
        self.lw_rrtmg = None
        use = config.lw_scheme
        if use == "rrtmg" or (use == "auto" and (config.lw_kg_path or kg_available())):
            with np.load(config.lw_kg_path or KG_NPZ) as probe:
                synthetic = "synthetic" in probe.files
            if synthetic:
                logging.getLogger("isca_tpu_torch").warning(
                    "RRTMG-LW is using SYNTHETIC correlated-k tables "
                    "(shape-correct, physically plausible, NOT AER-accurate). "
                    "Supply AER's rrtmg_lw.nc via tools/extract_rrtmg_lw.py "
                    "for production radiation: the same external data file "
                    "the reference loads at runtime (rrtmg_lw_read_nc.f90).")
            self.lw_rrtmg = RRTMGLw(
                RRTMGLwConfig(co2vmr=config.co2ppmv * 1e-6,
                              n2ovmr=config.n2ovmr, ch4vmr=config.ch4vmr,
                              grav=C.grav, cp_air=C.cp_air),
                kg=config.lw_kg_path, device=device)
        self.grey = TwoStreamGray(dataclasses.replace(config.lw, solar_constant=0.0))
        self.o3_field = None        # optional (..., L) ozone mmr set by the driver

    def down(self, lat, lon, p_half, t, q, albedo, gmt=0.0, time_since_ae=0.0,
             dt_rad_avg=None, carbon_conc=None, cloud_fields=None) -> RadDownResult:
        """The SW fluxes and the LW down sweep (RRTMG-LW's down phase or the
        grey one); what up() needs at the radiation (subsampled) resolution
        is kept on the instance, as isca_tpu's adapter keeps it: call up()
        after each down().

        cloud_fields: optional (cf, reff_rad [um], qcl_rad [kg/kg],
        frac_liq) from SimCloud, converted to in-cloud water paths and fed
        through cldprop into the cloudy solvers (a coupling the reference
        stages but leaves commented out, idealized_moist_phys.F90:1175)."""
        cfg = self.config
        # coszen with the same astronomy options as the reference adapter
        orbit = astro.Orbit()
        dtr = dt_rad_avg if cfg.use_time_average_coszen else None
        coszen, frac, rr = astro.diurnal_solar(orbit, lat, lon, gmt, time_since_ae, dtr)
        coszen = coszen * frac      # mean cos over the averaging window
        coszen_full = coszen

        o3 = self.o3_field if self.o3_field is not None else torch.full_like(t, cfg.o3_mmr)
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
            if cloud_fields is not None:
                cloud_fields = tuple(map(sub, cloud_fields))

        p_full = 0.5 * (p_half[..., :-1] + p_half[..., 1:])
        co2 = carbon_conc * 1e-6 if carbon_conc is not None else None

        # input guards as the reference adapter applies before every RRTMG
        # call: the k-tables are only valid over a finite (T, q) range
        t = torch.clamp(t, cfg.temp_lower_limit, cfg.temp_upper_limit)
        q = torch.clamp(q, min=cfg.h2o_lower_limit)

        cloud_kw, lw_cloud_kw = {}, {}
        if cloud_fields is not None:
            cf, reff, qcl, frac_liq = cloud_fields
            dp = p_half[..., 1:] - p_half[..., :-1]
            # in-cloud water path [g/m2]: grid-mean qcl / cloud fraction
            cwp = qcl / torch.clamp(cf, min=1e-4) * dp / cfg.constants.grav * 1.0e3
            cwp = torch.where(cf > 1e-4, cwp, 0.0)
            clwp = cwp * frac_liq
            ciwp = cwp * (1.0 - frac_liq)
            tauc, ssac, asmc = cldprop_sw(cf, clwp, ciwp, reff, reff)
            cloud_kw = dict(cldfrac=cf, taucld=tauc, ssacld=ssac, asmcld=asmc)
            lw_cloud_kw = dict(cldfrac=cf, clwp=clwp, ciwp=ciwp,
                               rel=torch.clamp(reff, 2.5, 60.0),
                               rei=torch.clamp(reff, 5.0, 131.0))

        # ---- LW ----
        if self.lw_rrtmg is not None:
            # half-level temperatures: interior = mean of adjacent layers,
            # endpoints extrapolated (rrtm_radiation.F90 tz staging)
            t_half = torch.cat([
                t[..., :1],
                0.5 * (t[..., 1:] + t[..., :-1]),
                1.5 * t[..., -1:] - 0.5 * t[..., -2:-1]], dim=-1)
            t_half = torch.clamp(t_half, cfg.temp_lower_limit, cfg.temp_upper_limit)
            with record_function("rrtmg_lw"):
                lw_down, self._lw_stash = self.lw_rrtmg.down_phase(
                    p_half, p_full, t, t_half, q, o3, co2vmr=co2, **lw_cloud_kw)
            surf_lw_down = lw_down[..., -1]
            zl = torch.zeros_like(t)
            grey_fields = dict(lw_dtrans=zl, lw_dtrans_win=zl, b=zl, b_win=zl)
        else:
            down_lw = self.grey.down(lat, lon, p_half, t, q, albedo,
                                     gmt=gmt, time_since_ae=time_since_ae,
                                     dt_rad_avg=dt_rad_avg)
            surf_lw_down, lw_down = down_lw.surf_lw_down, down_lw.lw_down
            grey_fields = dict(lw_dtrans=down_lw.lw_dtrans,
                               lw_dtrans_win=down_lw.lw_dtrans_win,
                               b=down_lw.b, b_win=down_lw.b_win)
            self._grey_down = down_lw

        # ---- SW ----
        swf = self.sw(p_half, p_full, t, q, o3, coszen, albedo, albedo, co2vmr=co2,
                      **cloud_kw)
        # Earth-sun distance factor scales incident flux (scalar rr)
        sw_down = swf.swdflx * rr
        sw_up = swf.swuflx * rr
        net_surf_sw_down = sw_down[..., -1] - sw_up[..., -1]
        self._k = k
        self._sw_heat, self._sw_up = swf.swhr * rr, sw_up
        ex = lambda a: _lon_expand(a, k, cfg.do_zm_rad)
        return RadDownResult(
            net_surf_sw_down=ex(net_surf_sw_down),
            surf_lw_down=ex(surf_lw_down),
            lw_down=ex(lw_down),
            sw_down=ex(sw_down),
            coszen=coszen_full,
            insolation=cfg.solr_cnst * coszen_full,
            **{name: ex(v) for name, v in grey_fields.items()},
        )

    def up(self, down: RadDownResult, p_half, t_surf, albedo) -> RadResult:
        cfg = self.config
        k, sw_heat = self._k, self._sw_heat
        if k > 1:
            sub = lambda a: a[:, ::k]
            p_half, t_surf, albedo = map(sub, (p_half, t_surf, albedo))
        ex = lambda a: _lon_expand(a, k, cfg.do_zm_rad)
        if self.lw_rrtmg is not None:
            with record_function("rrtmg_lw"):
                lwf = self.lw_rrtmg.up_phase(self._lw_stash, t_surf)
            tdt_rad = lwf.hr + sw_heat
            net_lw_surf = lwf.uflx[..., -1] - lwf.lw_dn_surf
            return RadResult(
                tdt_rad=ex(tdt_rad), tdt_solar=ex(sw_heat), olr=ex(lwf.olr),
                lw_up=ex(lwf.uflx), sw_up=ex(self._sw_up), net_lw_surf=ex(net_lw_surf))
        lw = self.grey.up(self._grey_down, p_half, t_surf, albedo)
        # grey up() includes its own (zero-insolation) SW; add the RRTMG SW heating
        tdt_rad = lw.tdt_rad + sw_heat
        return RadResult(
            tdt_rad=ex(tdt_rad), tdt_solar=ex(sw_heat), olr=ex(lw.olr),
            lw_up=ex(lw.lw_up), sw_up=ex(self._sw_up), net_lw_surf=ex(lw.net_lw_surf))
