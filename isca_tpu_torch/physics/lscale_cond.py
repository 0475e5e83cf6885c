"""Large-scale condensation.

Port of isca_tpu/physics/lscale_cond.py (reference:
src/atmos_param/lscale_cond/lscale_cond.F90:79-). Saturated points condense
to exactly saturation (with the latent-heat feedback denominator); optional
re-evaporation of falling precipitation into subsaturated layers below
(top-down loop); rain/snow split by coldT (or all rain with do_simple).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from isca_tpu_torch.constants import Constants, EARTH
from isca_tpu_torch.physics.sat_vapor_pres import SatVaporPres


@dataclasses.dataclass(frozen=True)
class LscaleCondConfig:
    hc: float = 1.0            # relative-humidity threshold for condensation
    do_evap: bool = False
    do_simple: bool = False    # constant L (no snow)
    constants: Constants = EARTH


class CondResult(NamedTuple):
    tdel: torch.Tensor
    qdel: torch.Tensor
    rain: torch.Tensor
    snow: torch.Tensor


class LscaleCond:
    def __init__(self, config: LscaleCondConfig, svp: SatVaporPres):
        self.config = config
        self.svp = svp
        self.C = config.constants

    def __call__(self, tin, qin, p_full, p_half, coldT=None) -> CondResult:
        """Level-last tensors (..., L)."""
        cfg, C = self.config, self.C
        qsat, dqsat = self.svp.qs_and_dqsdt(tin, p_full)
        qsat = qsat * cfg.hc
        dqsat = dqsat * cfg.hc
        if cfg.do_simple or coldT is None:
            hlcp = torch.full(tin.shape[:-1], C.hlv / C.cp_air, dtype=tin.dtype,
                              device=tin.device)
        else:
            hlcp = torch.where(
                coldT, torch.full(coldT.shape, C.hls / C.cp_air, dtype=tin.dtype,
                                  device=tin.device), C.hlv / C.cp_air)
        hl = hlcp[..., None]

        do_adjust = (qin - qsat) * qsat > 0.0
        qdel = torch.where(do_adjust, (qsat - qin) / (1.0 + hl * dqsat), 0.0)
        tdel = -hl * qdel
        pmass = (p_half[..., 1:] - p_half[..., :-1]) / C.grav

        if cfg.do_evap:
            # top-down loop re-evaporating excess condensate into dry layers
            exq = torch.zeros(tin.shape[:-1], dtype=tin.dtype, device=tin.device)
            qdels, tdels = [], []
            for k in range(tin.shape[-1]):
                qd, td, pm = qdel[..., k], tdel[..., k], pmass[..., k]
                qs, qi, dqs = qsat[..., k], qin[..., k], dqsat[..., k]
                exq = torch.where(qd < 0.0, exq - qd * pm, exq)
                cond = (qd >= 0.0) & (exq > 0.0)
                exq_l = exq / pm
                deficit = torch.clamp((qs - qi) / (1.0 + hlcp * dqs),
                                      torch.zeros_like(exq_l), exq_l)
                qdels.append(torch.where(cond, qd + deficit, qd))
                tdels.append(torch.where(cond, td - deficit * hlcp, td))
                exq = torch.where(cond, (exq_l - deficit) * pm, exq)
            qdel = torch.stack(qdels, dim=-1)
            tdel = torch.stack(tdels, dim=-1)

        precip = torch.clamp(-torch.sum(pmass * qdel, dim=-1), min=0.0)
        if cfg.do_simple or coldT is None:
            return CondResult(tdel, qdel, precip, torch.zeros_like(precip))
        rain = torch.where(coldT, 0.0, precip)
        snow = torch.where(coldT, precip, 0.0)
        return CondResult(tdel, qdel, rain, snow)
