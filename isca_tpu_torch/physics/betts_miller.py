"""Full Betts-Miller convection scheme.

Port of isca_tpu/physics/betts_miller.py (reference:
src/atmos_param/betts_miller/betts_miller.f90, defaults :41-56). Shares the
parcel-ascent/CAPE machinery with the simple quasi-equilibrium scheme
(`QEMoistConvection.ascent`); differs in the adjustment logic:

* q_ref = rhbm * r_sat(parcel) (or rhbm * e_sat(environment) with do_envsat)
* optional CAPE-dependent relaxation time (do_taucape)
* deep with P_q > P_T: rescale the moisture relaxation rate (as SBM)
* deep with P_q <= P_T: do_simp (default) rescales the TEMPERATURE tendency;
  otherwise shift T_ref to conserve enthalpy
* P_T > 0 but P_q <= 0: do_shallower (reduce depth to zero precipitation,
  rescaling the top layer and shifting tdel), do_changeqref (rescale q_ref to
  zero net precipitation + tdel shift), or (default) no convection.

Level-last tensors (..., L), index 0 = top.
"""

from __future__ import annotations

import dataclasses

import torch

from isca_tpu_torch.constants import Constants, EARTH
from isca_tpu_torch.physics.qe_moist_convection import (
    ConvectionResult,
    QEMoistConvection,
    QEMoistConvectionConfig,
    _take,
)
from isca_tpu_torch.physics.sat_vapor_pres import SatVaporPres


@dataclasses.dataclass(frozen=True)
class BettsMillerConfig:
    tau_bm: float = 7200.0
    rhbm: float = 0.8
    do_simp: bool = True
    do_shallower: bool = False
    do_changeqref: bool = False
    do_envsat: bool = False
    do_taucape: bool = False
    capetaubm: float = 900.0
    tau_min: float = 2400.0
    Tmin: float = 173.0
    constants: Constants = EARTH


class BettsMiller:
    def __init__(self, config: BettsMillerConfig, svp: SatVaporPres):
        self.config = config
        self.svp = svp
        self.C = config.constants
        # reuse the SBM parcel-ascent machinery
        self._qe = QEMoistConvection(
            QEMoistConvectionConfig(tau_bm=config.tau_bm, rhbm=config.rhbm,
                                    Tmin=config.Tmin, constants=config.constants),
            svp)

    def __call__(self, dt, tin, qin, p_full, p_half) -> ConvectionResult:
        cfg, C, svp = self.config, self.C, self.svp
        L = tin.shape[-1]
        eps = C.rdgas / C.rvgas
        tp, rp, cape, cin, klzb = self._qe.ascent(tin, qin, p_full, p_half)
        has_cape = (cape > 0.0) & (klzb > 0)

        kidx = torch.arange(L, device=tin.device)
        in_conv = has_cape[..., None] & (kidx >= klzb[..., None])

        # reference profiles
        tref = torch.where(in_conv, tp, tin)
        if cfg.do_envsat:
            es = svp.es(tin) * cfg.rhbm
            rref = eps * es / p_full
        else:
            rref = cfg.rhbm * rp
        qref = torch.where(in_conv, rref / (1.0 + rref), qin)

        # relaxation time (optionally CAPE-dependent)
        if cfg.do_taucape:
            tau = (cfg.capetaubm ** 0.5) * cfg.tau_bm / torch.sqrt(
                torch.clamp(cape, min=1e-10))
            tau = torch.clamp(tau, min=cfg.tau_min)[..., None]
        else:
            tau = cfg.tau_bm

        dp = p_half[..., 1:] - p_half[..., :-1]
        tdel = torch.where(in_conv, -(tin - tref) / tau * dt, 0.0)
        qdel = torch.where(in_conv, -(qin - qref) / tau * dt, 0.0)
        Pq = torch.sum(torch.where(in_conv, -qdel * dp, 0.0), dim=-1) / C.grav
        Pt = torch.sum(torch.where(in_conv, (C.cp_air / C.hlv) * tdel * dp, 0.0),
                       dim=-1) / C.grav

        deep = has_cape & (Pq > 0) & (Pt > 0)
        pt_only = has_cape & (Pt > 0) & (Pq <= 0)

        # ---- deep branch ----
        scale_q = torch.where(Pq > Pt, Pt / torch.where(Pq != 0, Pq, 1.0), 1.0)
        qdel_deep = torch.where((deep & (Pq > Pt))[..., None],
                                scale_q[..., None] * qdel, qdel)
        if cfg.do_simp:
            scale_t = torch.where(Pt != 0, Pq / torch.where(Pt != 0, Pt, 1.0), 1.0)
            tdel_deep = torch.where((deep & (Pq <= Pt))[..., None],
                                    scale_t[..., None] * tdel, tdel)
            tref_deep = tref
        else:
            dknum = -torch.sum(
                torch.where(in_conv, (tdel + C.hlv / C.cp_air * qdel_deep) * dp, 0.0),
                dim=-1)
            dp_conv = torch.sum(torch.where(in_conv, dp, 0.0), dim=-1)
            deltak = dknum / torch.where(dp_conv > 0, dp_conv, 1.0)
            mshift = (deep & (Pq <= Pt))[..., None] & in_conv
            tdel_deep = torch.where(mshift, tdel + deltak[..., None], tdel)
            tref_deep = torch.where(mshift, tref + (deltak * cfg.tau_bm / dt)[..., None],
                                    tref)
        rain_deep = torch.where(Pq > Pt, Pt, Pq)

        # ---- Pt>0, Pq<=0 branch ----
        if cfg.do_shallower:
            # remove levels from klzb downward until cumulative precip >= 0
            contrib = torch.where(in_conv, -qdel * dp / C.grav, 0.0)
            csum = torch.cumsum(contrib, dim=-1)
            total = csum[..., -1:]
            pq_after = total - csum
            found = pq_after > 0.0
            any_found = torch.any(found, dim=-1)
            ktop = torch.argmax(found.to(torch.uint8), dim=-1)     # first True
            in_sh = kidx >= ktop[..., None]
            is_ktop = kidx == ktop[..., None]
            pq_rem = _take(pq_after, ktop)
            qdel_kt = _take(qdel, ktop)
            dp_kt = _take(dp, ktop)
            # ptopfrac: fraction of the ktop layer needed for exactly zero precip
            frac = pq_rem * C.grav / torch.where(qdel_kt * dp_kt != 0,
                                                 -qdel_kt * dp_kt, 1.0)
            frac = torch.clamp(frac, 0.0, 1.0)
            mask_sh = (pt_only & any_found)[..., None]
            qdel_sh = torch.where(mask_sh & ~in_sh, 0.0, qdel)
            qdel_sh = torch.where(mask_sh & is_ktop, frac[..., None] * qdel, qdel_sh)
            tdel_sh = torch.where(mask_sh & ~in_sh, 0.0, tdel)
            tdel_sh = torch.where(mask_sh & is_ktop, frac[..., None] * tdel, tdel_sh)
            dknum = -torch.sum(torch.where(in_sh, tdel_sh * dp, 0.0), dim=-1)
            dpsh = torch.sum(torch.where(in_sh, dp, 0.0), dim=-1)
            deltak = dknum / torch.where(dpsh > 0, dpsh, 1.0)
            tdel_sh = torch.where(mask_sh & in_sh, tdel_sh + deltak[..., None], tdel_sh)
            tref_sh = torch.where(mask_sh & in_sh,
                                  tref + (deltak * cfg.tau_bm / dt)[..., None], tref)
            qref_sh = torch.where(mask_sh & ~in_sh, qin, qref)
            sh_ok = any_found
        elif cfg.do_changeqref:
            # rescale q_ref so net precipitation is exactly zero; shift tdel
            dq_int = torch.sum(torch.where(in_conv, -qdel * cfg.tau_bm / dt * (-dp), 0.0),
                               dim=-1)
            dk_int = torch.sum(torch.where(in_conv, tdel * (-dp), 0.0), dim=-1)
            qref_int = torch.sum(torch.where(in_conv, -qref * (-dp), 0.0), dim=-1)
            dp_conv = torch.sum(torch.where(in_conv, dp, 0.0), dim=-1)
            deltak = -dk_int / torch.where(dp_conv > 0, dp_conv, 1.0)
            safe_qint = torch.where(qref_int != 0, qref_int, 1.0)
            dqfrac = 1.0 - dq_int / safe_qint
            dqfrac2 = -dq_int / safe_qint * dt / cfg.tau_bm
            mask_sh = pt_only[..., None] & in_conv
            qdel_sh = torch.where(mask_sh, qdel + dqfrac2[..., None] * qref, qdel)
            qref_sh = torch.where(mask_sh, dqfrac[..., None] * qref, qref)
            tdel_sh = torch.where(mask_sh, tdel + deltak[..., None], tdel)
            tref_sh = torch.where(mask_sh, tref + (deltak * cfg.tau_bm / dt)[..., None], tref)
            sh_ok = torch.ones_like(pt_only)
        else:
            qdel_sh = torch.zeros_like(qdel)
            tdel_sh = torch.zeros_like(tdel)
            qref_sh, tref_sh = qref, tref
            sh_ok = torch.zeros_like(pt_only)

        # ---- combine ----
        dead = ~has_cape | (~deep & ~pt_only) | (pt_only & ~sh_ok)
        tdel_out = torch.where(deep[..., None], tdel_deep,
                               torch.where(pt_only[..., None], tdel_sh, tdel))
        qdel_out = torch.where(deep[..., None], qdel_deep,
                               torch.where(pt_only[..., None], qdel_sh, qdel))
        tdel_out = torch.where(dead[..., None], 0.0, tdel_out)
        qdel_out = torch.where(dead[..., None], 0.0, qdel_out)
        tref_out = torch.where(dead[..., None], tin,
                               torch.where(pt_only[..., None], tref_sh,
                                           tref_deep if not cfg.do_simp else tref))
        qref_out = torch.where(dead[..., None], qin,
                               torch.where(pt_only[..., None], qref_sh, qref))
        rain = torch.where(deep, torch.clamp(rain_deep, min=0.0), 0.0)
        bmflag = torch.where(deep, 2, torch.where(has_cape, 1, 0))
        return ConvectionResult(
            deltaT=tdel_out, deltaq=qdel_out, rain=rain, cape=cape, cin=cin,
            convflag=bmflag, tref=tref_out, qref=qref_out,
        )
