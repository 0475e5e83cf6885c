"""Saturation vapor pressure and saturation specific humidity.

Port of isca_tpu/physics/sat_vapor_pres.py (reference:
src/shared/sat_vapor_pres/sat_vapor_pres_k.F90). Two formulations:

* 'simple' (Frierson-style):
      es = es0 * 610.78 * exp(-(hlv/rvgas) (1/T - 1/Tfreeze))
  with constant latent heat; d(es)/dT follows analytically.
* 'full' (Goff-Gratch): water/ice formulations blended linearly between
  -20C and 0C, evaluated in closed form.

Saturation specific humidity:
      qs = rdgas/rvgas * es / (p - (1 - rdgas/rvgas) * es)
"""

from __future__ import annotations

import dataclasses
import math

import torch

from isca_tpu_torch.constants import Constants, EARTH


@dataclasses.dataclass(frozen=True)
class SatVaporPres:
    constants: Constants = EARTH
    do_simple: bool = False

    def es(self, t):
        C = self.constants
        if self.do_simple:
            return C.es0 * 610.78 * torch.exp(-(C.hlv / C.rvgas) * (1.0 / t - 1.0 / C.tfreeze))
        return _goff_gratch_es(t, C.tfreeze) * C.es0

    def des_dt(self, t, eps_t: float = 0.01):
        C = self.constants
        if self.do_simple:
            return self.es(t) * C.hlv / (C.rvgas * t * t)
        # centered difference, as the reference's table derivative effectively is
        return (self.es(t + 0.5 * eps_t) - self.es(t - 0.5 * eps_t)) / eps_t

    def qs(self, t, p):
        """Saturation specific humidity (kg/kg)."""
        C = self.constants
        eps = C.rdgas / C.rvgas
        es = self.es(t)
        denom = p - (1.0 - eps) * es
        return eps * es / torch.clamp(denom, min=torch.finfo(es.dtype).tiny)

    def qs_and_dqsdt(self, t, p):
        C = self.constants
        eps = C.rdgas / C.rvgas
        es = self.es(t)
        des = self.des_dt(t)
        denom = torch.clamp(p - (1.0 - eps) * es, min=torch.finfo(es.dtype).tiny)
        qs = eps * es / denom
        dqsdt = eps * p * des / (denom * denom)
        return qs, dqsdt


def _goff_gratch_es(t, tfreeze):
    """Goff-Gratch es with ice/water blend (compute_es_k)."""
    ESBASW = 101324.60
    ESBASI = 610.71
    tbasw = tfreeze + 100.0
    tbasi = tfreeze

    x_i = (
        -9.09718 * (tbasi / t - 1.0)
        - 3.56654 * torch.log10(tbasi / t)
        + 0.876793 * (1.0 - t / tbasi)
        + math.log10(ESBASI)
    )
    esice = 10.0**x_i
    x_w = (
        -7.90298 * (tbasw / t - 1.0)
        + 5.02808 * torch.log10(tbasw / t)
        - 1.3816e-07 * (10.0 ** ((1.0 - t / tbasw) * 11.344) - 1.0)
        + 8.1328e-03 * (10.0 ** ((tbasw / t - 1.0) * (-3.49149)) - 1.0)
        + math.log10(ESBASW)
    )
    esh2o = 10.0**x_w
    blend = 0.05 * ((tbasi - t) * esice + (t - tbasi + 20.0) * esh2o)
    return torch.where(t <= tbasi - 20.0, esice,
                       torch.where(t >= tbasi, esh2o, blend))
