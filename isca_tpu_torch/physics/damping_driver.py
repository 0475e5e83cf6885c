"""Upper-atmosphere damping driver: Rayleigh sponge, gravity-wave drags and
constant drag.

Port of isca_tpu/physics/damping_driver.py (reference:
src/atmos_param/damping_driver/damping_driver.f90). The Rayleigh sponge
damps winds where p < sponge_pbottom with rate
rfactr * ((pb - p)/pb)^2, optionally returning the dissipative heating; the
orographic (`do_mg_drag`, with its own energy-conserving heating) and
convective (`do_cg_drag`) gravity-wave drags add their tendencies;
`const_drag` adds an empirical upper-level zonal drag. `do_topo_drag`
raises NotImplementedError as the reference's FATAL stub does.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
from torch.profiler import record_function

from isca_tpu_torch.constants import Constants, EARTH
from isca_tpu_torch.physics.gravity_wave_drag import (
    CgDrag,
    CgDragConfig,
    MgDragConfig,
    const_drag,
    mg_drag,
)


@dataclasses.dataclass(frozen=True)
class DampingDriverConfig:
    do_rayleigh: bool = True
    trayfric: float = -0.5          # days if negative (reference convention)
    sponge_pbottom: float = 50.0    # Pa
    do_conserve_energy: bool = True
    do_mg_drag: bool = False        # orographic GWD (mg_drag.f90)
    do_cg_drag: bool = False        # convective GWD (cg_drag.f90, AD99)
    do_const_drag: bool = False     # empirical drag (damping_driver.f90:283)
    # Garner (2001) topographic drag: the reference ships it as a FATAL stub
    # ("not supported as part of the public release", topo_drag.f90:62-63);
    # selecting it here raises the same way
    do_topo_drag: bool = False
    const_drag_amp: float = 3.0e-4
    const_drag_off: float = 0.0
    mg: MgDragConfig = MgDragConfig()
    cg: CgDragConfig = CgDragConfig()
    constants: Constants = EARTH


class DampingResult(NamedTuple):
    dt_u: torch.Tensor
    dt_v: torch.Tensor
    dt_t: torch.Tensor
    diagnostics: dict


def check_ported(cfg: DampingDriverConfig):
    """Raise for the topographic drag, which the reference does not ship."""
    if cfg.do_topo_drag:
        raise NotImplementedError(
            "topo_drag is not supported (the reference's topo_drag.f90 is a "
            "FATAL stub in the public release)")


def damping_driver(
    cfg: DampingDriverConfig, delta_t, p_full, u, v, dt_u, dt_v, dt_t,
    temp=None, p_half=None, z_full=None, z_half=None, hprime=None,
    cg: CgDrag | None = None, lat2d=None, day_of_year=0.0, days_per_year=360.0,
) -> DampingResult:
    """damping_driver.f90:168-330 sequencing: rayleigh -> mg_drag ->
    cg_drag -> const_drag. Level-last arrays (..., L); mg_drag needs temp,
    p_half, z_full, z_half and hprime, cg_drag a CgDrag and temp, z_full."""
    check_ported(cfg)
    C = cfg.constants
    diag = {}

    if cfg.do_rayleigh:
        tray = cfg.trayfric * (-86400.0 if cfg.trayfric < 0 else 1.0)
        rfactr = 1.0 / tray if tray != 0 else 0.0
        pb = cfg.sponge_pbottom
        fact = torch.where(p_full < pb, rfactr * (pb - p_full) ** 2 / pb**2, 0.0)
        du, dv = -u * fact, -v * fact
        dt_u, dt_v = dt_u + du, dt_v + dv
        if cfg.do_conserve_energy:
            diss = -((u + 0.5 * delta_t * du) * du
                     + (v + 0.5 * delta_t * dv) * dv) / C.cp_air
            dt_t = dt_t + diss
        diag["udt_rdamp"] = du

    if cfg.do_mg_drag:
        with record_function("mg_drag"):
            mg = mg_drag(cfg.mg, delta_t, u, v, temp, p_full, p_half,
                         z_full, z_half, hprime)
        dt_u, dt_v = dt_u + mg.dt_u, dt_v + mg.dt_v
        dt_t = dt_t + mg.dt_t
        diag.update(udt_gwd=mg.dt_u, vdt_gwd=mg.dt_v,
                    taubx=mg.taubx, tauby=mg.tauby)

    if cfg.do_cg_drag:
        with record_function("cg_drag"):
            res = cg(p_full, z_full, temp, u, v)
        dt_u, dt_v = dt_u + res.gwfcng_x, dt_v + res.gwfcng_y
        diag.update(gwfu_cgwd=res.gwfcng_x, gwfv_cgwd=res.gwfcng_y)

    if cfg.do_const_drag:
        du = const_drag(cfg.const_drag_amp, cfg.const_drag_off, lat2d,
                        p_full, day_of_year, days_per_year)
        dt_u = dt_u + du
        diag["udt_cnstd"] = du

    return DampingResult(dt_u, dt_v, dt_t, diag)
