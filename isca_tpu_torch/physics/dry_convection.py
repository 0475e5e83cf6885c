"""Dry convective adjustment (Schneider & Walker 2006).

Port of isca_tpu/physics/dry_convection.py (reference:
src/atmos_param/dry_convection/dry_convection.f90). Lift a parcel from the
lowest level along a gamma-adiabat (gamma=1: dry adiabat); find the first
unstable run above the surface (CIN below it, CAPE within it, LZB at its top);
relax T toward the parcel profile shifted by a uniform increment that
conserves column enthalpy over [LZB..surface]; no convection if CIN > CAPE.

isca_tpu's two scans over levels (the parcel lift and the bookkeeping) are
loops from the surface upward over the fixed level count, batched over all
columns. Level-last tensors (..., L), index 0 = top.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from isca_tpu_torch.constants import Constants, EARTH


@dataclasses.dataclass(frozen=True)
class DryConvectionConfig:
    tau: float = 14400.0     # relaxation timescale (s)
    gamma: float = 1.0       # fraction of the dry-adiabatic lapse rate
    constants: Constants = EARTH


class DryConvectionResult(NamedTuple):
    dt_tg: torch.Tensor
    cape: torch.Tensor
    cin: torch.Tensor
    lzb: torch.Tensor     # int32 level of zero buoyancy
    lcl: torch.Tensor     # int32 lifting condensation level


def dry_convection(cfg: DryConvectionConfig, tg, p_full, p_half) -> DryConvectionResult:
    """Level-last (..., L)."""
    C = cfg.constants
    cons1 = C.rdgas / C.cp_air
    L = tg.shape[-1]

    # parcel profile: upward from the surface
    ratio = (p_full[..., :-1] / p_full[..., 1:]) ** cons1   # (..., L-1), level k vs k+1
    tp = tg[..., -1]
    lifted = [tp]
    for k in range(L - 2, -1, -1):
        tp = tp + cfg.gamma * (tp * ratio[..., k] - tp)
        lifted.append(tp)
    tp_lift = torch.stack(lifted[::-1], dim=-1)

    unstable = tp_lift > tg
    dlnp = torch.log(p_half[..., 1:] / p_half[..., :-1])   # (..., L)

    # upward bookkeeping (k = L-2 .. 0)
    shape = tg.shape[:-1]
    cape = torch.zeros(shape, dtype=tg.dtype, device=tg.device)
    cin = torch.zeros_like(cape)
    lcl = torch.full(shape, L - 1, dtype=torch.int32, device=tg.device)
    lzb = torch.full_like(lcl, L - 1)
    in_cloud = torch.zeros(shape, dtype=torch.bool, device=tg.device)
    done = torch.zeros_like(in_cloud)
    for k in range(L - 2, -1, -1):
        uns, uns_below = unstable[..., k], unstable[..., k + 1]
        contrib = C.rdgas * (tp_lift[..., k] - tg[..., k]) * dlnp[..., k]
        start = uns & ~in_cloud & ~done
        cape = cape + torch.where((in_cloud | start) & uns & ~done, contrib, 0.0)
        # LCL: first unstable level whose lower neighbor was stable
        lcl = torch.where(start & ~uns_below, k, lcl)
        cin = cin + torch.where(~uns & ~in_cloud & ~done, -contrib, 0.0)
        # LZB: when the run ends (stable above an unstable run) or model top
        end = in_cloud & ~uns
        lzb = torch.where(end & ~done, k + 1, lzb)
        if k == 0:
            lzb = torch.where((in_cloud | start) & ~done, 0, lzb)
        done = done | end
        in_cloud = (in_cloud | start) & ~end

    convecting = (cape > cin) & (lzb < L - 1)
    kidx = torch.arange(L, device=tg.device)
    in_layer = convecting[..., None] & (kidx >= lzb[..., None])
    # inside the layer: lifted profile where unstable, else environment
    tp = torch.where(in_layer & unstable, tp_lift, tg)

    dp_half = p_half[..., 1:] - p_half[..., :-1]
    ener = torch.sum(torch.where(in_layer, dp_half * (tg - tp), 0.0), dim=-1)
    dp_tot = torch.sum(torch.where(in_layer, dp_half, 0.0), dim=-1)
    shift = ener / torch.where(dp_tot > 0, dp_tot, 1.0)
    tp = torch.where(in_layer, tp + shift[..., None], tp)

    dt_tg = (tp - tg) / cfg.tau
    return DryConvectionResult(dt_tg=dt_tg, cape=cape, cin=cin, lzb=lzb, lcl=lcl)
