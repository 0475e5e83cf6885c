"""Gravity-wave drag: the namelist configurations and the constant drag.

Port of the parts of isca_tpu/physics/gravity_wave_drag.py that
physics/damping_driver.py needs: `MgDragConfig` (mg_drag_nml) and
`CgDragConfig` (cg_drag_nml), copied as configuration dataclasses so a
`DampingDriverConfig` carries them as isca_tpu's does, and `const_drag`
(damping_driver.f90:283). The orographic (`mg_drag`, mg_drag.f90) and
convective (`CgDrag`, cg_drag.f90) schemes themselves are not ported
(ROADMAP A.5): the damping driver raises when either is switched on.

All arrays are level-last (..., L), index 0 = model top.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from isca_tpu_torch.constants import Constants, EARTH


@dataclasses.dataclass(frozen=True)
class MgDragConfig:
    """mg_drag_nml (mg_drag.f90:74-78)."""
    xl_mtn: float = 1.0e5        # mountain wavelength scale [m]
    gmax: float = 2.0
    acoef: float = 1.0
    rho: float = 1.13            # low-level air density [kg/m^3]
    low_lev_frac: float = 0.23   # fraction of ps defining the low layer
    flux_cut_level: float = 0.0  # Pa; >0 freezes flux above this level
    do_conserve_energy: bool = False
    constants: Constants = EARTH


@dataclasses.dataclass(frozen=True)
class CgDragConfig:
    """cg_drag_nml (cg_drag.f90:50-95)."""
    source_level_pressure: float = 315.0e2   # Pa
    nk: int = 1                              # number of wavelengths
    cmax: float = 99.6                       # max phase speed [m/s]
    dc: float = 1.2                          # spectral resolution [m/s]
    Bt_0: float = 0.004                      # total source stress / density
    Bt_nh: float = 0.001
    Bt_sh: float = -0.001
    phi0n: float = 30.0
    phi0s: float = -30.0
    dphin: float = 5.0
    dphis: float = -5.0
    Bw: float = 0.4                          # wide-spectrum amplitude
    Bn: float = 0.0                          # narrow-spectrum amplitude
    cw: float = 40.0                         # wide half-width [m/s]
    cn: float = 2.0                          # narrow half-width [m/s]
    flag: int = 1                            # 1: peak flux at c=0
    bflim: float = 2.5e-5                    # buoyancy-frequency floor [1/s^2]
    calculate_ked: bool = False
    constants: Constants = EARTH


def const_drag(amp, offset, lat2d, p_full, day_of_year, days_per_year):
    """Empirical constant upper-level zonal drag with annual cycle."""
    phase = 2.0 * math.pi * day_of_year / days_per_year
    cosday = torch.cos(phase) if torch.is_tensor(phase) else math.cos(phase)
    phPa = p_full * 0.01
    minp = torch.log(torch.min(phPa)) - 1.0
    utnd = torch.where(phPa < math.e, -amp * ((torch.log(phPa) - 1.0) / minp), 0.0)
    lat = lat2d[..., None]
    shape = (-1.65 * torch.abs(lat) ** 3 + 2.5 * lat**2 + 0.17 * torch.abs(lat)
             + offset)
    return torch.where(phPa < math.e,
                       utnd * torch.sign(lat) * cosday * shape, 0.0)
