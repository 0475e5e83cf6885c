"""Relaxed Arakawa-Schubert (RAS) deep convection.

Port of isca_tpu/physics/ras.py (reference: src/atmos_param/ras/ras.f90,
Moorthi & Suarez 1992 as implemented in FMS):
  - RAS driver (:491-1309): parcel LCL cloud base, ensemble of cloud types
    (one per detrainment level, bottom-up by default), sequential relaxation
    (each cloud updates theta/qvap before the next), convective-scale
    precipitation evaporation.
  - RAS_CLOUD (:1315-1939): entrainment parameter from cloud-top neutral
    buoyancy, normalized mass-flux profile eta, cloud work function against
    the Arakawa-Schubert climatological critical value (a(p) table), kernel
    akm, and the resulting theta/q/(u,v) tendencies and precipitation.
  - COMP_LCL (:1944-2009), RAS_CEVAP (:2014-2112), RAS_CLOUD_EXIST (:2179).

The reference's per-column level recurrences telescope into masked suffix
cumulative sums over the level axis, so each cloud type is closed-form
tensor arithmetic over every column at once. The relaxed part, each cloud
modifying the sounding the next one sees, is a Python loop over the ~L-3
cloud types (each with a static detrainment level), and the precipitation
re-evaporation's downward accumulation is a loop over the levels below the
cloud top (above it nothing evaporates). The quantities that do not change
from one cloud to the next are computed once per call. Not ported, as in
isca_tpu: random cloud ordering (ncrnd>0; off by default), the do_strat
ql/qi/qa detrainment couplings and modify_pbl (off by default).

Levels are (..., L), index 0 = top, as everywhere in the physics layer.
Every level index taken per column (klcl, klcl-1) lies in [0, L) by
construction: comp_lcl returns at least L//2-1, also for a column without
an LCL.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from isca_tpu_torch.constants import Constants, EARTH

# Arakawa-Schubert climatological critical cloud work function
# (ras.f90:43-48 data, scaled by facm=0.01 at init :294-298)
_PH = 100.0 * np.array([150.0, 200.0, 250.0, 300.0, 350.0, 400.0, 450.0,
                        500.0, 550.0, 600.0, 650.0, 700.0, 750.0, 800.0, 850.0])
_A = 0.01 * np.array([1.6851, 1.1686, 0.7663, 0.5255, 0.4100, 0.3677,
                      0.3151, 0.2216, 0.1521, 0.1082, 0.0750, 0.0664,
                      0.0553, 0.0445, 0.0633])
_ACTOP = 1.7 * 0.01


@dataclasses.dataclass(frozen=True)
class RASConfig:
    """ras_nml (ras.f90:71-176)."""
    fracs: float = 0.25
    rasal0: float = 0.25
    puplim: float = 20.0e2
    aratio: float = 1.4
    cufric: bool = False
    rh_trig: float = 0.0
    alm_min: float = 0.0
    tokioka_on: bool = False
    tokioka_con: float = 0.05
    tokioka_plim: float = 500.0e2
    krmax: int = 2               # shallowest detrainment level (1-based)
    botop: bool = True           # bottom-up cloud ordering
    rn_ptop: float = 500.0e2
    rn_pbot: float = 800.0e2
    rn_frac_bot: float = 0.8
    rn_frac_top: float = 1.0
    evap_on: bool = True
    cfrac: float = 0.05
    hcevap: float = 0.80
    constants: Constants = EARTH


class RASResult(NamedTuple):
    dt_t: torch.Tensor      # (..., L) temperature increment over dtime [K]
    dt_q: torch.Tensor
    dt_u: torch.Tensor
    dt_v: torch.Tensor
    rain: torch.Tensor      # (...,) kg/m2 over the step
    snow: torch.Tensor
    klcl: torch.Tensor      # (...,) int32 cloud-base level index (0-based)
    precip_ev: torch.Tensor


def _suffix_sum(x, mask):
    """S(l) = sum_{j >= l} x_j mask_j along the last axis (inclusive)."""
    xm = torch.where(mask, x, 0.0)
    return torch.flip(torch.cumsum(torch.flip(xm, (-1,)), -1), (-1,))


def _take(a, idx):
    return torch.gather(a, -1, idx[..., None]).squeeze(-1)


def _shift_up(a):
    """a(l+1) -> slot l (value below); last slot repeats (masked anyway)."""
    return torch.cat([a[..., 1:], a[..., -1:]], dim=-1)


def _shift_dn(a):
    """a(l-1) -> slot l (value above); first slot repeats (masked anyway)."""
    return torch.cat([a[..., :1], a[..., :-1]], dim=-1)


def _set(a, i, value):
    """a with a[..., i] = value (a copy)."""
    out = a.clone()
    out[..., i] = value
    return out


class _Fixed(NamedTuple):
    """What every cloud type of one call shares: the frozen linearization,
    the Exner layers and the per-column level picks."""
    klcl: torch.Tensor
    kex: torch.Tensor
    lidx: torch.Tensor
    le_k: torch.Tensor          # lidx <= klcl
    lt_k: torch.Tensor          # lidx < klcl
    eq_k: torch.Tensor          # lidx == klcl
    pres_int: torch.Tensor
    pi_int: torch.Tensor
    pi: torch.Tensor
    dpi: torch.Tensor
    dpib: torch.Tensor
    dpit: torch.Tensor
    pi_m1: torch.Tensor
    psfc: torch.Tensor
    alf: torch.Tensor
    bet: torch.Tensor
    gam: torch.Tensor
    gam_up: torch.Tensor        # gam(l-1) * (pi_int(l) - pi(l-1))
    cp_by_dp: torch.Tensor
    cp_by_dp_m1: torch.Tensor
    zbase: torch.Tensor
    hl: torch.Tensor
    pk_int: torch.Tensor        # pres_int(klcl)
    akm_base: torch.Tensor      # gam(k-1) * (pi_int(k) - pi(k-1))
    # the precipitation re-evaporation's fixed inputs
    qsat: torch.Tensor
    mass: torch.Tensor
    sqrt_p: torch.Tensor        # sqrt(p_full / psfc)
    evap_den: torch.Tensor      # 1 + hl hcevap dqsat / cp


class RAS:
    def __init__(self, config: RASConfig, svp):
        self.config = config
        self.svp = svp
        tem = np.zeros(15)
        au = np.zeros(15)
        ad = np.zeros(15)
        ac = np.zeros(15)
        tem[1:] = _PH[1:] - _PH[:-1]
        au[1:] = _A[:-1] / tem[1:]
        ad[1:] = _A[1:] / tem[1:]
        ac[1:] = _PH[1:] * au[1:] - _PH[:-1] * ad[1:]
        ad[1:] = ad[1:] - au[1:]
        self.ac_np, self.ad_np = ac, ad
        self._tables = {}
        self.rn_pfac = (config.rn_frac_top - config.rn_frac_bot) / (
            config.rn_pbot - config.rn_ptop)

    def _table(self, like):
        """The a(p) table's (ac, ad) on `like`'s device and dtype, made once."""
        key = (like.device, like.dtype)
        if key not in self._tables:
            on = lambda x: torch.as_tensor(x).to(device=like.device, dtype=like.dtype)
            self._tables[key] = (on(self.ac_np), on(self.ad_np))
        return self._tables[key]

    def _qsat(self, t, p):
        """qsat and dqsat/dT with the pressure-broadening denominator
        (ras.f90:614-618)."""
        C = self.config.constants
        es = self.svp.es(t)
        des = self.svp.des_dt(t)
        d622 = C.rdgas / C.rvgas
        d378 = 1.0 - d622
        denom = torch.maximum(es, p - d378 * es)
        return d622 * es / denom, d622 * des * p / denom**2

    def comp_lcl(self, t_parc, q_parc, p_parc, p_full):
        """Cloud-base level (COMP_LCL, ras.f90:1944-2009), 0-based int64."""
        C = self.config.constants
        es = self.svp.es(t_parc)
        qsat = (C.rdgas / C.rvgas) * es / p_parc
        rhum = torch.clamp(q_parc / qsat, 1e-10, 1.0)
        chi = t_parc / (1669.0 - 122.0 * rhum - t_parc)
        p_lcl = p_parc * torch.exp(chi * torch.log(rhum))
        p_lcl = torch.minimum(torch.maximum(p_lcl, p_full[..., 0]), p_parc)
        L = p_full.shape[-1]
        hit = (p_lcl[..., None] >= p_full[..., :-1]) & (
            p_lcl[..., None] <= p_full[..., 1:])
        kidx = torch.arange(1, L, device=p_full.device)
        klcl = torch.amax(torch.where(hit, kidx, 0), dim=-1)
        return torch.clamp(klcl, min=L // 2 - 1)   # k_lcl_min = kmax/2

    # ------------------------------------------------------------------
    def _ras_cloud(self, ib, f: _Fixed, theta, qvap, uwnd, vwnd, rasal, frac):
        """One cloud type with STATIC detrainment level `ib` (0-based),
        vectorized over columns (RAS_CLOUD, ras.f90:1315-1939). klcl varies
        per column; all level recurrences are masked suffix sums.

        Returns (dtheta/dt, dq/dt, du/dt, dv/dt, precip rate)."""
        cfg = self.config
        C = cfg.constants
        L = theta.shape[-1]
        lidx, kex, klcl = f.lidx, f.kex, f.klcl
        pres_int, pi_int, pi, gam, cp_by_dp = f.pres_int, f.pi_int, f.pi, f.gam, f.cp_by_dp
        dpib, dpit = f.dpib, f.dpit
        rhmax = 0.9999
        cp = C.cp_air
        hl = f.hl
        hlL = hl[..., None]

        ge_ib = lidx >= ib
        gt_ib = lidx > ib
        in_cloud = ge_ib & f.le_k
        interior = gt_ib & f.lt_k
        in_below = in_cloud & f.lt_k          # l in [ib, k-1]
        above_k = gt_ib & f.le_k              # l in [ib+1, k]

        qs1 = f.alf + f.bet * theta
        qol = torch.minimum(qs1 * rhmax, qvap)

        # dry static energy with the suffix-accumulated zzl (:1412-1441)
        dpi_th_cp = f.dpi * theta * cp
        zzl_incl = _suffix_sum(dpi_th_cp, f.le_k)
        ssl = (zzl_incl - dpi_th_cp) + pi_int[..., 1:] * theta * cp
        hol = ssl + qol * hlL
        hst = ssl + qs1 * hlL

        # eta pre-entrainment: suffix sums of cp/g * dtheta; the ic layer
        # uses (pi_int(ic+1) - pi(ic)) (:1438-1441)
        deta_base = torch.where(lidx == ib, (pi_int[..., 1:] - pi) * theta,
                                f.dpi * theta) * (cp / C.grav)
        eta0 = _suffix_sum(deta_base, in_below)
        eta0 = torch.where(lidx > kex - 1, 0.0, eta0)

        hol_k = _take(hol, klcl)
        hst_ic = hst[..., ib]
        hst_ic1 = hst[..., ib + 1]
        hol_ic = hol[..., ib]
        hol_ic1 = hol[..., ib + 1]
        qol_ic = qol[..., ib]
        qol_ic1 = qol[..., ib + 1]

        xx1 = hol_k - hst_ic
        xx2 = torch.sum(torch.where(in_below, (hst_ic[..., None] - hol) * deta_base, 0.0),
                        dim=-1)
        lcase1 = (xx2 > 0.0) & (xx1 > 0.0)
        lcase2 = (xx1 <= 0.0) & (hol_k > hst_ic1) & (ib + 1 < klcl)

        alm = torch.where(lcase1, xx1 / torch.where(xx2 != 0.0, xx2, 1.0), 0.0)
        alm_floor = torch.full_like(alm, cfg.alm_min)
        if cfg.tokioka_on:
            pmid = 0.5 * (pres_int[..., ib] + pres_int[..., ib + 1])
            alm_floor = torch.where(pmid <= cfg.tokioka_plim,
                                    cfg.tokioka_con / f.zbase, alm_floor)
        active = (lcase1 | lcase2) & (alm >= alm_floor)

        eta = torch.where(in_below, 1.0 + alm[..., None] * eta0,
                          torch.where(f.eq_k, 1.0, 0.0))
        eta_p1 = _shift_up(eta)
        deta = torch.where(in_below, eta - eta_p1, 0.0)
        eta_ic = eta[..., ib]
        eta_ic1 = eta[..., ib + 1]

        # --- cloud work function (:1178-1215) ------------------------------
        # hcc(l) = hol(k) + sum_{j=l..k-1} deta_j hol_j
        hcc = hol_k[..., None] + _suffix_sum(deta * hol, f.lt_k)
        hcc_p1 = _shift_up(hcc)
        wfn = torch.sum(torch.where(
            interior,
            (hcc_p1 * dpib + hcc * dpit
             - (eta_p1 * dpib + eta * dpit) * hst) * gam, 0.0), dim=-1)
        wfn = wfn + torch.where(
            lcase1,
            gam[..., ib] * dpib[..., ib] * (hcc[..., ib + 1] - hst_ic * eta_ic1),
            0.0)

        # --- critical work function (:1216-1241) ---------------------------
        pmid0 = 0.5 * (pres_int[..., ib] + pres_int[..., ib + 1])
        if ib + 2 < L:
            ftop = torch.where(
                hst_ic1 < hst_ic,
                (hst_ic1 - hol_k) / torch.where(hst_ic1 != hst_ic, hst_ic1 - hst_ic, 1.0),
                0.0)
            p_alt = 0.5 * (pres_int[..., ib + 1] + pres_int[..., ib + 2])
            pmid = torch.where(lcase2, p_alt * (1.0 - ftop) + pmid0 * ftop, pmid0)
            ftop = torch.where(lcase2, ftop, 1.0)
        else:
            ftop = torch.ones_like(pmid0)
            pmid = pmid0
        ac, ad = self._table(pmid)
        iwk = (pmid * 0.02e-2 - 0.999999999).to(torch.int32)   # 1-based
        it = torch.clamp(iwk - 1, 0, 14).long()
        tab = ac[it] + pmid * ad[it]
        wfn_crit = torch.where(iwk <= 1, _ACTOP,
                               torch.where(iwk > 15, float(_A[14]), tab))
        wfn = wfn - cfg.aratio * wfn_crit * (f.pk_int - pmid)
        lcase1 = lcase1 & (wfn > 0.0)
        lcase2 = lcase2 & (wfn > 0.0) & (ftop > 0.0)
        active = active & (lcase1 | lcase2)

        # --- detrainment-level properties (:1246-1266) ---------------------
        dhic = torch.where(lcase1, hst_ic - hol_ic,
                           (hol_k - hol_ic1) - (hol_ic - hol_ic1) * ftop)
        mix_h = ftop * (hol_ic - hol_ic1) + hol_ic1
        mix_q = ftop * (qol_ic - qol_ic1) + qol_ic1
        sic = mix_h - mix_q * hl
        qs1_ic = torch.where(lcase2, mix_q + dhic / hl, qs1[..., ib])

        # --- updraft totals (:1268-1285) -----------------------------------
        def updraft(x):
            return _take(x, klcl) + torch.sum(torch.where(in_below, deta * x, 0.0), dim=-1)
        wlq = updraft(qol) - qs1_ic * eta_ic
        uht = updraft(uwnd) - uwnd[..., ib] * eta_ic
        vht = updraft(vwnd) - vwnd[..., ib] * eta_ic

        # --- theta-transport kernel array ("hol" reuse, :1689-1713) --------
        th_m1 = _shift_dn(theta)
        pi_m1 = f.pi_m1
        grad = torch.where(f.eq_k, (th_m1 - theta) / (pi - pi_m1),
                           (th_m1 - theta) * eta / (pi - pi_m1))
        A = grad * (pi_int[..., :-1] - pi_m1) * pi * cp_by_dp
        B = grad * (pi - pi_int[..., :-1]) * pi_m1 * f.cp_by_dp_m1
        B_above = _shift_up(B)
        holT = (torch.where(above_k, A, 0.0)
                + torch.where(ge_ib & f.lt_k, B_above, 0.0))
        akm = -torch.sum(torch.where(
            interior, holT * (eta * dpit + eta_p1 * dpib) / pi, 0.0), dim=-1)

        # --- precipitation fraction (:1720-1745) ---------------------------
        rn_frac = torch.where(
            pmid0 > cfg.rn_pbot, cfg.rn_frac_bot,
            torch.where(pmid0 >= cfg.rn_ptop,
                        (cfg.rn_pbot - pmid0) * self.rn_pfac + cfg.rn_frac_bot,
                        cfg.rn_frac_top))
        wdet = (1.0 - rn_frac) * wlq
        wlq = rn_frac * wlq

        # xx1 starts from the KERNEL array's ic slot (B deposited from above),
        # not the original moist static energy (ras.f90:1749 'xx1 = hol(ic)'
        # after the kernel overwrite; hic saved the original earlier)
        xx1d = holT[..., ib] + torch.where(
            lcase2, (sic - hol_ic + qol_ic * hl) * (cp_by_dp[..., ib] / cp), 0.0)
        holT = _set(holT, ib, xx1d - wdet * hl * cp_by_dp[..., ib] / cp)
        akm = akm - torch.where(
            lcase1, eta_ic1 * dpib[..., ib] * xx1d / pi[..., ib], 0.0)

        # --- moist-static transport gmh (:1764-1806) -----------------------
        qol_m1 = _shift_dn(qol)
        dq_eta = torch.where(f.eq_k, qol_m1 - qol, (qol_m1 - qol) * eta)
        dq_eta = torch.where(above_k, dq_eta, 0.0)
        xx3 = dq_eta + _shift_up(dq_eta) * ((lidx + 1) <= kex)
        gmh = holT + xx3 * cp_by_dp * hlL * 0.5 / cp
        gmh = torch.where(above_k, gmh, 0.0)

        dq_ic1 = dq_eta[..., ib + 1]
        xx2g = dq_ic1 + torch.where(
            lcase2, 2.0 * (hol_k - dhic - sic - qol_ic * hl) / hl, 0.0)
        gmh = _set(gmh, ib,
                   xx1d + cp_by_dp[..., ib] / cp * (xx2g * hl * 0.5 + eta_ic * dhic))

        # akm from gmh (:1794-1806): gsum(l) = gmh(k) + sum_{j=l..k-1} deta gmh
        gmh_k = _take(gmh, klcl)
        gsum = gmh_k[..., None] + _suffix_sum(deta * gmh, f.lt_k)
        gam_up_term = _set(f.gam_up, ib + 1, torch.where(lcase2, 0.0, f.gam_up[..., ib + 1]))
        akm = akm + torch.sum(torch.where(
            interior, gsum * (gam_up_term + gam * dpit), 0.0), dim=-1)
        akm = akm + f.akm_base * gmh_k

        # --- lcase2 ftop re-evaluation + level shuffle (:1824-1847) --------
        if ib + 2 < L:
            xx1f = pmid0 + 0.5 * (pres_int[..., ib + 2] - pres_int[..., ib]) \
                * (1.0 - ftop)
            xx2f = pres_int[..., ib + 1]
            xx3f = 0.5 * (pres_int[..., ib + 1] + pres_int[..., ib + 2])
            in_band = (xx1f >= xx2f) & (xx1f < xx3f)
            ftop_new = torch.where(in_band, 1.0 - (xx1f - xx2f) / (xx3f - xx2f),
                                   torch.where(xx1f < xx2f, 1.0, 0.0))
            shuffle = lcase2 & in_band
            ratio = cp_by_dp[..., ib + 1] / cp_by_dp[..., ib]
            holT = _set(holT, ib + 1, holT[..., ib + 1]
                        + torch.where(shuffle, holT[..., ib] * ratio, 0.0))
            gmh = _set(gmh, ib + 1, gmh[..., ib + 1]
                       + torch.where(shuffle, gmh[..., ib] * ratio, 0.0))
            holT = _set(holT, ib, torch.where(shuffle, 0.0, holT[..., ib]))
            gmh = _set(gmh, ib, torch.where(shuffle, 0.0, gmh[..., ib]))
            ftop = torch.where(lcase2, ftop_new, ftop)

        # --- relaxation amplitude (:1849-1872) -----------------------------
        rasalf = torch.clamp(
            rasal * (pres_int[..., ib + 1] - cfg.puplim) / (f.psfc - cfg.puplim), min=0.0)
        ok = (akm < 0.0) & (wlq >= 0.0) & active
        wfn_f = torch.where(ok, -ftop * wfn * rasalf
                            / torch.where(akm != 0.0, akm, -1.0), 0.0)
        wfn_f = torch.minimum(wfn_f, (f.psfc - f.pk_int) * frac)
        wfn_f = torch.where(ok, torch.clamp(wfn_f, min=0.0), 0.0)

        dpcu = wlq * wfn_f / C.grav
        wfnL = wfn_f[..., None]
        dtcu = torch.where(in_cloud, wfnL / cp * holT / pi, 0.0)
        dqcu = torch.where(in_cloud, wfnL / hlL * (gmh - holT), 0.0)

        if cfg.cufric:
            # (:1908-1936) in-cloud momentum mixing
            u_m1, v_m1 = _shift_dn(uwnd), _shift_dn(vwnd)
            dut = torch.where(f.eq_k, u_m1 - uwnd, (u_m1 - uwnd) * eta)
            dvt = torch.where(f.eq_k, v_m1 - vwnd, (v_m1 - vwnd) * eta)
            dut = torch.where(above_k, dut, 0.0)
            dvt = torch.where(above_k, dvt, 0.0)
            xxm = 0.5 * wfnL / cp * cp_by_dp
            ducu = torch.where(interior | f.eq_k, (dut + _shift_up(dut)) * xxm, 0.0)
            dvcu = torch.where(interior | f.eq_k, (dvt + _shift_up(dvt)) * xxm, 0.0)
            ducu = _set(ducu, ib, (dut[..., ib + 1] + 2.0 * uht) * xxm[..., ib])
            dvcu = _set(dvcu, ib, (dvt[..., ib + 1] + 2.0 * vht) * xxm[..., ib])
        else:
            ducu = dvcu = None
        return dtcu, dqcu, ducu, dvcu, dpcu

    # ------------------------------------------------------------------
    def _cevap(self, ib, qvap, f: _Fixed, dtime, dpcu):
        """Evaporation of convective precip (RAS_CEVAP, ras.f90:2014-2112):
        sequential downward drawdown of the precip flux over the levels below
        the cloud top (l > ib); nothing evaporates at or above it. What does
        not depend on the flux is computed for all levels at once."""
        cfg = self.config
        cem, ceta = 0.054, -544.0e-6
        L = qvap.shape[-1]
        hq = cfg.hcevap * f.qsat
        deficit_base = (hq - qvap) / f.evap_den
        room = hq >= qvap
        dpevap = torch.zeros_like(dpcu)
        defs = [torch.zeros_like(dpcu)] * (ib + 1)
        for k in range(ib + 1, L):
            m_k = f.mass[..., k]
            prec = torch.clamp(dpcu - dpevap, min=0.0)
            prec_mmph = prec * 3600.0 / dtime
            emx = torch.sqrt(cem * cfg.cfrac * prec_mmph * f.sqrt_p[..., k])
            evef = 1.0 - torch.exp(ceta * dtime * emx)
            deficit = torch.minimum(evef * deficit_base[..., k], prec / m_k)
            deficit = torch.where(room[..., k] & (prec > 0.0), deficit, 0.0)
            dpevap = dpevap + deficit * m_k
            defs.append(deficit)
        dq = torch.stack(defs, dim=-1)
        dt = -dq * f.hl[..., None] / cfg.constants.cp_air
        return dt, dq, dpevap

    # ------------------------------------------------------------------
    def _cloud_exist(self, ic, f: _Fixed, qvap, qsat, theta):
        """Instability for the deepest cloud (RAS_CLOUD_EXIST, :2179-2229)."""
        C = self.config.constants
        cp = C.cp_air
        klcl, hl = f.klcl, f.hl
        dpi_th_cp = f.dpi * theta * cp
        zzl_incl = _suffix_sum(dpi_th_cp, f.le_k)
        ssl = (zzl_incl - dpi_th_cp) + f.pi_int[..., 1:] * theta * cp
        hst = ssl + qsat * hl[..., None]
        qol_k = torch.minimum(_take(qsat, klcl) * 0.9999, _take(qvap, klcl))
        hol_k = _take(f.pi_int[..., 1:], klcl) * _take(theta, klcl) * cp + qol_k * hl
        hst_min = torch.amin(torch.where((f.lidx >= ic) & f.le_k, hst, torch.inf), dim=-1)
        return hol_k > hst_min

    # ------------------------------------------------------------------
    def __call__(self, dtime, temp0, qvap0, uwnd0, vwnd0, p_full, p_half,
                 z_half, coldT=None) -> RASResult:
        """Full RAS step. Level-last (..., L), top-down; p in Pa.
        Returns increments over dtime (add to the state)."""
        cfg = self.config
        C = cfg.constants
        L = temp0.shape[-1]
        shape2d = temp0.shape[:-1]
        dev = temp0.device
        if coldT is None:
            coldT = torch.zeros(shape2d, dtype=torch.bool, device=dev)
        full2 = lambda x: torch.full(shape2d, x, dtype=temp0.dtype, device=dev)
        hl = torch.where(coldT, full2(C.hls), full2(C.hlv))

        frac = cfg.fracs / dtime
        rasal = cfg.rasal0 / dtime

        qsat0, dqsat0 = self._qsat(temp0, p_full)

        t_parc, q_parc, p_parc = temp0[..., -1], qvap0[..., -1], p_full[..., -1]
        klcl = self.comp_lcl(t_parc, q_parc, p_parc, p_full)
        qs_parc = self._qsat(t_parc, p_parc)[0]
        rhtrig = q_parc >= cfg.rh_trig * qs_parc

        psfc = p_half[..., -1]
        mass_p = torch.clamp(p_half[..., 1:] - p_half[..., :-1], min=1e-5)
        pi_int = (p_half / 1.0e5) ** C.kappa
        pi = (pi_int[..., 1:] * p_half[..., 1:]
              - pi_int[..., :-1] * p_half[..., :-1]) / (mass_p * (1.0 + C.kappa))
        pi = torch.clamp(pi, min=1e-5)
        cp_by_dp = C.cp_air / mass_p
        mass = mass_p / C.grav
        zbase = _take(z_half, klcl) - z_half[..., -1]

        theta = temp0 / pi
        # frozen linearization about the input sounding (setras once)
        alf = qsat0 - dqsat0 * temp0
        bet = dqsat0 * pi
        gam = 1.0 / ((1.0 + hl[..., None] * dqsat0 / C.cp_air) * pi)

        lidx = torch.arange(L, device=dev)
        kex = klcl[..., None]
        pi_m1 = _shift_dn(pi)
        km1 = torch.clamp(klcl - 1, min=0)
        f = _Fixed(
            klcl=klcl, kex=kex, lidx=lidx, le_k=lidx <= kex, lt_k=lidx < kex,
            eq_k=lidx == kex, pres_int=p_half, pi_int=pi_int, pi=pi,
            dpi=pi_int[..., 1:] - pi_int[..., :-1],
            dpib=pi_int[..., 1:] - pi, dpit=pi - pi_int[..., :-1], pi_m1=pi_m1,
            psfc=psfc, alf=alf, bet=bet, gam=gam,
            gam_up=_shift_dn(gam) * (pi_int[..., :-1] - pi_m1),
            cp_by_dp=cp_by_dp, cp_by_dp_m1=_shift_dn(cp_by_dp), zbase=zbase, hl=hl,
            pk_int=_take(p_half, klcl),
            akm_base=_take(gam, km1) * (_take(pi_int[..., :-1], klcl) - _take(pi, km1)),
            qsat=qsat0, mass=mass, sqrt_p=torch.sqrt(p_full / psfc[..., None]),
            evap_den=1.0 + hl[..., None] * cfg.hcevap * dqsat0 / C.cp_air)

        ic_min = cfg.krmax            # 0-based index of the deepest cloud top
        exist = self._cloud_exist(ic_min, f, qvap0, qsat0, theta)
        col_ok = rhtrig & exist

        ibs = list(range(L - 2, cfg.krmax - 1, -1))
        if not cfg.botop:
            ibs = ibs[::-1]

        qvap = qvap0
        uwnd, vwnd = uwnd0, vwnd0
        zeros3 = torch.zeros_like(temp0)
        d_t, d_q, d_u, d_v = zeros3, zeros3, zeros3, zeros3
        precip = precip_ev = full2(0.0)

        for ib in ibs:
            valid = col_ok & (ib < klcl)
            dtcu, dqcu, ducu, dvcu, dpcu = self._ras_cloud(
                ib, f, theta, qvap, uwnd, vwnd, rasal, frac)
            v3 = valid[..., None]
            dtcu = dtcu * dtime * v3
            dqcu = dqcu * dtime * v3
            dpcu = dpcu * dtime * valid

            if cfg.evap_on:
                dtev, dqev, dpev = self._cevap(ib, qvap, f, dtime, dpcu)
                dtev = dtev * v3
                dqev = dqev * v3
                dpev = dpev * valid
                dtcu = dtcu + dtev / pi
                dqcu = dqcu + dqev
                dpcu = torch.clamp(dpcu - dpev, min=0.0)
                precip_ev = precip_ev + dpev

            theta = theta + dtcu
            qvap = qvap + dqcu
            d_t = d_t + dtcu * pi
            d_q = d_q + dqcu
            if ducu is not None:
                ducu = ducu * dtime * v3
                dvcu = dvcu * dtime * v3
                uwnd = uwnd + ducu
                vwnd = vwnd + dvcu
                d_u = d_u + ducu
                d_v = d_v + dvcu
            precip = precip + dpcu

        rain = torch.where(coldT, 0.0, precip)
        snow = torch.where(coldT, precip, 0.0)
        return RASResult(dt_t=d_t, dt_q=d_q, dt_u=d_u, dt_v=d_v,
                         rain=rain, snow=snow, klcl=klcl.to(torch.int32),
                         precip_ev=precip_ev)
