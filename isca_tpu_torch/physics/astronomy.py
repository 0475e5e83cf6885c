"""Orbital mechanics / insolation (astronomy).

Port of isca_tpu/physics/astronomy.py (reference:
src/shared/astronomy/astronomy.f90, diurnal_solar :1123): declination from
obliquity and orbital position (Kepler's equation by Newton iteration for
eccentric orbits), instantaneous and time-averaged coszen, daily-mean coszen.

Angles in radians; time_since_ae = orbital position since autumnal equinox
(2*pi = one year), gmt = greenwich time of day as angle (2*pi = one day).
time_since_ae and gmt may be Python floats or 0-d tensors.
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class Orbit:
    ecc: float = 0.0
    obliq_deg: float = 23.439
    per_deg: float = 102.932   # longitude of perihelion (from autumnal equinox)

    @property
    def obliq(self):
        return math.radians(self.obliq_deg)


def _scalar(x):
    """A Python float as a float64 0-d tensor (it then takes the dtype of
    the tensors it meets, as a JAX weakly-typed scalar does); tensors pass."""
    return x if torch.is_tensor(x) else torch.tensor(x, dtype=torch.float64)


def orbital_angle(orbit: Orbit, time_since_ae, iters: int = 8):
    """True anomaly measured from autumnal equinox for elliptical orbits.

    With ecc=0 this is just time_since_ae. Otherwise solve Kepler's equation
    M = E - e sin E by Newton, with M referenced to perihelion.
    """
    e = orbit.ecc
    if e == 0.0:
        return time_since_ae
    per = math.radians(orbit.per_deg)
    M = _scalar(time_since_ae) - per
    E = M
    for _ in range(iters):
        E = E - (E - e * torch.sin(E) - M) / (1.0 - e * torch.cos(E))
    nu = 2.0 * torch.atan(math.sqrt((1 + e) / (1 - e)) * torch.tan(E / 2.0))
    return nu + per


def declination(orbit: Orbit, time_since_ae):
    """Solar declination. time_since_ae = 0 at the autumnal equinox, so a
    quarter year later is the (northern) winter solstice: dec = -obliquity."""
    ang = _scalar(orbital_angle(orbit, time_since_ae))
    return torch.asin(-math.sin(orbit.obliq) * torch.sin(ang))


def earth_sun_distance_factor(orbit: Orbit, time_since_ae):
    """(a/r)^2 insolation scaling."""
    e = orbit.ecc
    if e == 0.0:
        return 1.0
    nu = orbital_angle(orbit, time_since_ae) - math.radians(orbit.per_deg)
    r_over_a = (1.0 - e * e) / (1.0 + e * torch.cos(nu))
    return 1.0 / (r_over_a * r_over_a)


def _half_day(a, b):
    """Half-day length H (cos H = -a/b), with polar day/night."""
    cosH = torch.clamp(-a / torch.where(b != 0, b, 1e-30), -1.0, 1.0)
    H = torch.acos(cosH)
    return torch.where(b <= 0, math.pi * (a > 0).to(H.dtype), H)


def diurnal_solar(orbit: Orbit, lat, lon, gmt, time_since_ae, dt_radians=None):
    """(coszen, fracday, rrsun).

    lat, lon broadcastable tensors (radians). If dt_radians is given, coszen
    is the mean cosine of the zenith angle over the SUNLIT part of
    [t, t + dt] and fracday the sunlit fraction of the interval.
    """
    dec = declination(orbit, time_since_ae)
    rr = earth_sun_distance_factor(orbit, time_since_ae)
    a = torch.sin(lat) * torch.sin(dec)
    b = torch.cos(lat) * torch.cos(dec)
    # hour angle: 0 at local noon; gmt measured from midnight -> h = gmt + lon - pi
    h = torch.remainder(gmt + lon - math.pi, 2.0 * math.pi)
    h = torch.where(h > math.pi, h - 2.0 * math.pi, h)
    H = _half_day(a, b)

    if dt_radians is None:
        cz = torch.clamp(a + b * torch.cos(h), min=0.0)
        frac = (cz > 0.0).to(cz.dtype)
        return cz, frac, rr

    # analytic average of max(0, a + b cos h') over h' in [h, h + dt]
    dt = dt_radians
    h1, h2 = h, h + dt

    def sunlit_integral(lo, hi):
        lo_c = torch.clamp(lo, -H, H)
        hi_c = torch.clamp(hi, -H, H)
        ints = a * (hi_c - lo_c) + b * (torch.sin(hi_c) - torch.sin(lo_c))
        return ints, hi_c - lo_c

    i1, t1 = sunlit_integral(h1, h2)
    # window of the following day (centered at h = 2 pi)
    i2, t2 = sunlit_integral(h1 - 2 * math.pi, h2 - 2 * math.pi)
    total_int = i1 + i2
    total_time = t1 + t2
    frac = total_time / dt
    lit = total_time > 0
    cz = torch.where(lit, total_int / torch.where(lit, total_time, 1.0), 0.0)
    return torch.clamp(cz, min=0.0), frac, rr


def daily_mean_solar(orbit: Orbit, lat, time_since_ae):
    """(coszen averaged over sunlit hours, fraction of day with sun up)."""
    dec = declination(orbit, time_since_ae)
    rr = earth_sun_distance_factor(orbit, time_since_ae)
    a = torch.sin(lat) * torch.sin(dec)
    b = torch.cos(lat) * torch.cos(dec)
    H = _half_day(a, b)
    frac = H / math.pi
    integ = a * H + b * torch.sin(H)
    cz = torch.where(H > 0, integ / torch.where(H > 0, H, 1.0), 0.0)
    return torch.clamp(cz, min=0.0), frac, rr


def annual_mean_p2_insolation(solar_constant, lat, del_sol=1.4, del_sw=0.0):
    """S/4 [1 + del_sol P2(sin lat) + del_sw sin lat] (two_stream default)."""
    p2 = (1.0 - 3.0 * torch.sin(lat) ** 2) / 4.0
    return 0.25 * solar_constant * (1.0 + del_sol * p2 + del_sw * torch.sin(lat))
