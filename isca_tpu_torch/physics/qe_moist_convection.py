"""Simple Betts-Miller quasi-equilibrium convection (Frierson 2007).

Port of isca_tpu/physics/qe_moist_convection.py (reference:
src/atmos_param/qe_moist_convection/qe_moist_convection.F90, with the
O'Gorman & Schneider 2008 virtual-temperature modifications). Per column:

1. Lift a parcel from the lowest level: dry adiabat to the LCL (Newton solve
   for T_LCL), then pseudo-adiabatic ascent via the predictor-corrector
   dT/dlnp step; accumulate CIN below the level of free convection and CAPE
   above; find the level of zero buoyancy kLZB.
2. If CAPE > 0: reference profiles T_ref = T_parcel, q_ref = from
   rhbm * e_sat; relaxation increments deltaT/deltaq over tau_bm;
   precipitation checks select deep convection, the "shallower" shallow
   scheme, or none.

The ascent is a loop from the surface upward over the fixed level count with
carried phase flags, batched over all columns. Level-last tensors (..., L),
index 0 = top.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from isca_tpu_torch.constants import Constants, EARTH
from isca_tpu_torch.physics.sat_vapor_pres import SatVaporPres


@dataclasses.dataclass(frozen=True)
class QEMoistConvectionConfig:
    tau_bm: float = 7200.0
    rhbm: float = 0.8
    Tmin: float = 173.0
    newton_iters: int = 25
    constants: Constants = EARTH


class ConvectionResult(NamedTuple):
    deltaT: torch.Tensor      # (..., L) temperature increment over dt
    deltaq: torch.Tensor      # (..., L) humidity increment over dt
    rain: torch.Tensor        # (...,) kg/m^2 accumulated over dt
    cape: torch.Tensor
    cin: torch.Tensor
    convflag: torch.Tensor    # 0 none, 1 cape>0, 2 deep
    tref: torch.Tensor
    qref: torch.Tensor


def _take(a, idx):
    """a[..., idx[...]] along the last axis."""
    return torch.gather(a, -1, idx[..., None])[..., 0]


class QEMoistConvection:
    def __init__(self, config: QEMoistConvectionConfig, svp: SatVaporPres):
        self.config = config
        self.svp = svp
        self.C = config.constants

    # -- helpers ------------------------------------------------------
    def _mixing_ratio(self, e, p):
        C = self.C
        return (C.rdgas / C.rvgas) * e / (p - e)

    def _virtual_temp_r(self, t, r):
        C = self.C
        q = r / (1.0 + r)
        return t * (1.0 + q * (C.rvgas / C.rdgas - 1.0))

    def _lcl_temp(self, value, t_guess):
        """Newton solve of value = log(es(T) T^(-1/kappa)) (reference lcl_temp)."""
        C = self.C
        kappa = C.rdgas / C.cp_air
        t = t_guess
        for _ in range(self.config.newton_iters):
            es = self.svp.es(t)
            f = value - torch.log(es) + (1.0 / kappa) * torch.log(t)
            dfdt = -self.svp.des_dt(t) / es + 1.0 / (kappa * t)
            t = torch.clamp(t - f / dfdt, 100.0, 400.0)
        return t

    def _moist_dtdlnp(self, t, r):
        C = self.C
        kappa = C.rdgas / C.cp_air
        a = kappa * t + (C.hlv / C.cp_air) * r
        b = (C.hlv**2) * r / (C.cp_air * C.rvgas * t * t)
        return a / (1.0 + b)

    # -- parcel ascent ---------------------------------------------------
    def ascent(self, tin, qin, p_full, p_half):
        """Parcel ascent from the lowest level.

        Returns (tp, rp, cape, cin, klzb) with tp/rp the parcel profile
        (environment values where the ascent is inactive), klzb = 0 where no
        convection (no cape / failed columns).
        """
        cfg, C, svp = self.config, self.C, self.svp
        kappa = C.rdgas / C.cp_air
        pref = 1.0e5
        L = tin.shape[-1]
        rin = qin / (1.0 - qin)
        tin_v = self._virtual_temp_r(tin, rin)

        t0 = tin[..., -1]
        r0 = torch.clamp(rin[..., -1], min=0.0)
        p0 = p_full[..., -1]
        es0 = svp.es(t0)
        rs0 = self._mixing_ratio(es0, p0)
        saturated = rin[..., -1] >= rs0

        # LCL (unsaturated columns)
        theta0 = t0 * (pref / p0) ** kappa
        r0_safe = torch.clamp(r0, min=1.0e-10)
        value = torch.log(
            theta0 ** (-1.0 / kappa) * pref * r0_safe / (C.rdgas / C.rvgas + r0_safe))
        tlcl = self._lcl_temp(value, torch.full_like(t0, 260.0))
        plcl = pref * (tlcl / theta0) ** (1.0 / kappa)
        # clamp LCL to the model top and handle r0 <= 0 (-> no convection)
        top_hit = plcl < p_full[..., 0]
        plcl = torch.where(top_hit, p_full[..., 0], plcl)
        tlcl = torch.where(top_hit, theta0 * (plcl / pref) ** kappa, tlcl)
        no_moisture = r0 <= 0.0
        # saturated columns: LCL at the surface with latent adjustment
        t0_sat = t0 + (r0 - rs0) / (
            C.cp_air / C.hlv + C.hlv * rs0 / (C.rvgas * t0 * t0))
        plcl = torch.where(saturated, p0, plcl)

        # ---- parcel ascent (surface -> top) ----
        tp_prev, rp_prev, p_prev = t0, r0, p0
        passed_lcl = saturated.clone()
        cape = torch.zeros_like(t0)
        cin = torch.zeros_like(t0)
        nocape = torch.ones_like(saturated)
        stopped = torch.zeros_like(saturated)
        klzb = torch.zeros(t0.shape, dtype=torch.int64, device=t0.device)
        failed = no_moisture.clone()
        tp_out = [None] * L
        rp_out = [None] * L
        for k in range(L - 1, -1, -1):
            pf = p_full[..., k]
            ph_lo = p_half[..., k + 1]         # below
            ph_hi = p_half[..., k]             # above
            t_env_v = tin_v[..., k]
            dlnph = torch.log(ph_lo / ph_hi)

            is_surface = k == L - 1
            below_lcl = ~passed_lcl & (pf > plcl)

            # (a) dry-adiabat branch (below LCL)
            tp_dry = theta0 * (pf / pref) ** kappa
            es_dry = svp.es(tp_dry)
            rp_dry = self._mixing_ratio(es_dry, pf)
            cin_dry = cin + C.rdgas * (t_env_v - self._virtual_temp_r(tp_dry, r0)) * dlnph

            # (b) LCL-crossing branch: two-step from (tlcl, plcl)
            dtdlnp1 = self._moist_dtdlnp(tlcl, r0_safe)
            tp_half = tlcl + dtdlnp1 * torch.log(pf / plcl) / 2.0
            rp_half = self._mixing_ratio(svp.es(tp_half), (pf + plcl) / 2.0)
            dtdlnp2 = self._moist_dtdlnp(tp_half, rp_half)
            tp_lcl = tlcl + dtdlnp2 * torch.log(pf / plcl)

            # (c) moist-ascent branch from the previous level
            dtdlnp1m = self._moist_dtdlnp(tp_prev, rp_prev)
            tp_mh = tp_prev + dtdlnp1m * torch.log(pf / p_prev) / 2.0
            rp_mh = self._mixing_ratio(svp.es(tp_mh), (pf + p_prev) / 2.0)
            dtdlnp2m = self._moist_dtdlnp(tp_mh, rp_mh)
            tp_moist = tp_prev + dtdlnp2m * torch.log(pf / p_prev)

            at_lcl = ~passed_lcl & ~below_lcl
            tp_k = torch.where(below_lcl, tp_dry, torch.where(at_lcl, tp_lcl, tp_moist))
            if is_surface:
                # saturated-surface special case
                tp_k = torch.where(saturated, t0_sat, tp_k)
            use_moist = ~below_lcl
            rp_k = torch.where(use_moist, self._mixing_ratio(svp.es(tp_k), pf), rp_dry)
            if is_surface:
                rp_sat0 = self._mixing_ratio(svp.es(t0_sat), p0)
                rp_k = torch.where(saturated, rp_sat0, rp_k)

            # Tmin guard -> whole column marked failed (no cape) if still nocape
            failed = failed | ((tp_k < cfg.Tmin) & nocape)

            # buoyancy bookkeeping (moist region only; dry region handled above)
            tp_v = self._virtual_temp_r(tp_k, rp_k)
            buoyant = tp_v >= t_env_v
            # the surface level never accumulates
            active = ~stopped & ~failed
            in_moist = use_moist & active & (not is_surface)
            add_cape = in_moist & buoyant
            add_cin = in_moist & ~buoyant & nocape
            hit_lzb = in_moist & ~buoyant & ~nocape

            cape = cape + torch.where(add_cape, C.rdgas * (tp_v - t_env_v) * dlnph, 0.0)
            cin = torch.where(below_lcl & active, cin_dry, cin)
            cin = cin + torch.where(add_cin, C.rdgas * (t_env_v - tp_v) * dlnph, 0.0)
            nocape = torch.where(add_cape, False, nocape)
            klzb = torch.where(hit_lzb & (klzb == 0), k + 1, klzb)
            stopped = stopped | hit_lzb

            passed_lcl = passed_lcl | use_moist
            tp_out[k] = torch.where(active, tp_k, tin[..., k])
            rp_out[k] = torch.where(active, rp_k, rin[..., k])
            tp_prev = torch.where(active, tp_k, tp_prev)
            rp_prev = torch.where(active, rp_k, rp_prev)
            p_prev = torch.where(active, pf, p_prev)
        tp = torch.stack(tp_out, dim=-1)
        rp = torch.stack(rp_out, dim=-1)

        cape = torch.where(failed, 0.0, cape)
        cin = torch.where(failed, 0.0, cin)
        klzb = torch.where(failed | nocape, 0, klzb)
        tp = torch.where(failed[..., None], tin, tp)
        rp = torch.where(failed[..., None], rin, rp)
        return tp, rp, cape, cin, klzb

    # -- main ---------------------------------------------------------
    def __call__(self, dt, tin, qin, p_full, p_half) -> ConvectionResult:
        """All inputs level-last (..., L) / (..., L+1)."""
        cfg, C = self.config, self.C
        L = tin.shape[-1]
        tp, rp, cape, cin, klzb = self.ascent(tin, qin, p_full, p_half)

        has_cape = (cape > 0.0) & (klzb > 0)

        # ---- reference profiles ----
        kidx = torch.arange(L, device=tin.device)
        in_conv = has_cape[..., None] & (kidx >= klzb[..., None])
        eref = cfg.rhbm * p_full * rp / (rp + C.rdgas / C.rvgas)
        rref = self._mixing_ratio(eref, p_full)
        qref = torch.where(in_conv, rref / (1.0 + rref), qin)
        tref = torch.where(in_conv, tp, tin)

        dp = p_half[..., 1:] - p_half[..., :-1]   # positive
        deltaq = torch.where(in_conv, -(qin - qref) * dt / cfg.tau_bm, 0.0)
        deltaT = torch.where(in_conv, -(tin - tref) * dt / cfg.tau_bm, 0.0)
        Pq = torch.sum(torch.where(in_conv, deltaq * (-dp), 0.0), dim=-1) / C.grav
        Pt = torch.sum(
            torch.where(in_conv, (C.cp_air / C.hlv) * deltaT * dp, 0.0), dim=-1
        ) / C.grav

        deep = has_cape & (Pq > 0) & (Pt > 0)
        shallow = has_cape & (Pt > 0) & (Pq <= 0)
        none = ~deep & ~shallow

        # ---- deep convection ----
        # Pq > Pt: rescale moisture timescale; else shift Tref (enthalpy)
        scale_q = torch.where(Pq > Pt, Pt / torch.where(Pq != 0, Pq, 1.0), 1.0)
        deltaq_deep = torch.where(
            (deep & (Pq > Pt))[..., None], scale_q[..., None] * deltaq, deltaq)
        dk_num = -torch.sum(
            torch.where(in_conv, (deltaT + (C.hlv / C.cp_air) * deltaq_deep) * dp, 0.0),
            dim=-1)
        dp_conv = torch.sum(torch.where(in_conv, dp, 0.0), dim=-1)
        deltak = dk_num / torch.where(dp_conv > 0, dp_conv, 1.0)
        apply_shift = (deep & (Pq <= Pt))[..., None] & in_conv
        deltaT_deep = torch.where(apply_shift, deltaT + deltak[..., None], deltaT)
        tref = torch.where(apply_shift, tref + (deltak * cfg.tau_bm / dt)[..., None], tref)
        rain_deep = torch.where(Pq > Pt, Pt, Pq)

        # ---- shallow convection: find the zero-precipitation depth ----
        # remove levels from kLZB downward while cumulative Pq < 0
        contrib = torch.where(in_conv, deltaq * (-dp) / C.grav, 0.0)
        csum = torch.cumsum(contrib, dim=-1)
        total = csum[..., -1:]
        pq_after_removing = total - csum  # removing rows klzb..j leaves rows j+1..
        found_j = pq_after_removing > 0.0
        any_found = torch.any(found_j, dim=-1)
        k_top = torch.argmax(found_j.to(torch.uint8), dim=-1)  # first True
        in_shallow = kidx >= k_top[..., None]
        # rescale deltaq at k_top so the remaining precipitation is exactly zero
        pq_rem = _take(pq_after_removing, k_top)
        dq_ktop = _take(deltaq, k_top)
        dp_ktop = _take(dp, k_top)
        c_fac = pq_rem * C.grav / torch.where(
            dq_ktop * dp_ktop != 0, dq_ktop * dp_ktop, 1.0)
        is_ktop = kidx == k_top[..., None]
        sh_mask = shallow[..., None] & any_found[..., None]
        deltaq_sh = torch.where(sh_mask & ~in_shallow, 0.0, deltaq)
        deltaq_sh = torch.where(sh_mask & is_ktop, deltaq * c_fac[..., None], deltaq_sh)
        deltaT_sh = torch.where(sh_mask & ~in_shallow, 0.0, deltaT)
        deltaT_sh = torch.where(sh_mask & is_ktop, deltaT * c_fac[..., None], deltaT_sh)
        # enthalpy shift over k_top..surface
        dknum_sh = torch.sum(torch.where(in_shallow, deltaT_sh * (-dp), 0.0), dim=-1)
        dp_sh = torch.sum(torch.where(in_shallow, dp, 0.0), dim=-1)
        deltak_sh = dknum_sh / torch.where(dp_sh > 0, dp_sh, 1.0)
        deltaT_sh = torch.where(
            sh_mask & in_shallow, deltaT_sh + deltak_sh[..., None], deltaT_sh)
        tref_sh = torch.where(
            sh_mask & in_shallow, tref + (deltak_sh * cfg.tau_bm / dt)[..., None], tref)

        # ---- combine branches ----
        deltaT_out = torch.where(
            deep[..., None], deltaT_deep,
            torch.where(sh_mask, deltaT_sh, torch.where(none[..., None], 0.0, deltaT)))
        deltaq_out = torch.where(
            deep[..., None], deltaq_deep,
            torch.where(sh_mask, deltaq_sh, torch.where(none[..., None], 0.0, deltaq)))
        # shallow-without-zero-level and 'none' -> no convection at all
        dead = none | (shallow & ~any_found)
        deltaT_out = torch.where(dead[..., None], 0.0, deltaT_out)
        deltaq_out = torch.where(dead[..., None], 0.0, deltaq_out)
        tref_out = torch.where(dead[..., None], tin, torch.where(sh_mask, tref_sh, tref))
        qref_out = torch.where(dead[..., None], qin, qref)
        rain = torch.where(deep, rain_deep, 0.0)
        convflag = torch.where(deep, 2, torch.where(has_cape, 1, 0))

        return ConvectionResult(
            deltaT=deltaT_out, deltaq=deltaq_out, rain=torch.clamp(rain, min=0.0),
            cape=cape, cin=cin, convflag=convflag, tref=tref_out, qref=qref_out,
        )
