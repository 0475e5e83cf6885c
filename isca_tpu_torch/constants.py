"""Physical constants as a configurable dataclass (port of isca_tpu/constants.py).

Equivalent of the reference's `src/shared/constants/constants.F90` with its
`constants_nml` (constants.F90:270): planetary parameters (radius, gravity, rotation
rate, gas constants, solar constant, ...) are runtime-configurable so the framework
supports non-Earth planets (giant planet, exoplanet test cases). A `Constants` instance
is threaded through model builds; its values enter the tensor code as Python
floats.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Constants:
    # Planetary (constants.F90:83-130)
    radius: float = 6371.0e3          # m
    omega: float = 7.292e-5           # s^-1
    grav: float = 9.80                # m s^-2
    pstd: float = 1.013250e5          # Pa (standard pressure)
    pstd_mks: float = 101325.0        # Pa

    # Dry air / water vapor thermodynamics
    rdgas: float = 287.04             # J kg^-1 K^-1
    rvgas: float = 461.50             # J kg^-1 K^-1
    cp_air: float = 1004.64           # J kg^-1 K^-1 (= 7/2 rdgas in the reference)
    cp_vapor: float = 4.0 * 461.50    # J kg^-1 K^-1
    kappa: float = 2.0 / 7.0          # rdgas / cp_air
    hlv: float = 2.500e6              # J kg^-1 latent heat of vaporization
    hlf: float = 3.34e5               # J kg^-1 latent heat of fusion
    hls: float = 2.834e6              # J kg^-1 latent heat of sublimation
    dens_h2o: float = 1000.0          # kg m^-3
    tfreeze: float = 273.16           # K
    es0: float = 1.0                  # humidity factor (constants_nml)

    # Radiation / astronomy
    stefan: float = 5.6734e-8         # W m^-2 K^-4
    solar_const: float = 1368.22      # W m^-2
    orbital_period: float = 365.25 * 86400.0  # s
    seconds_per_day: float = 86400.0

    # von Karman constant (Monin-Obukhov)
    vonkarm: float = 0.40

    @property
    def zvir(self) -> float:
        """rvgas/rdgas - 1, the virtual temperature factor."""
        return self.rvgas / self.rdgas - 1.0

    def replace(self, **kw) -> "Constants":
        return dataclasses.replace(self, **kw)


EARTH = Constants()

# Giant-planet example values used by the reference's test case
# (exp/test_cases/giant_planet/giant_planet_test_case.py:160-188).
JUPITER_LIKE = Constants(
    radius=69860.0e3,
    grav=26.0,
    omega=1.7587e-4,
    orbital_period=4332.589 * 86400.0,
)
