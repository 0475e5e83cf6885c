"""EDT: entrainment-diffusivity turbulence (Grenier-Bretherton moist TKE BL).

Port of isca_tpu/physics/edt.py (reference: src/atmos_param/edt/edt.F90 -
edt :715-1534, driver; trbintd :1935-2263, interior N2/S2/Ri from
liquid-water static energy; exacol :2276-2398, convective-layer detection;
zisocl :2409-3027, layer extension/merging + bulk TKE closure; caleddy
:3041-4500, diffusivities; galperin :4511-4552, stability functions;
lengthscale :4563-4592). Selected by `vert_turb_driver_nml do_edt`
(vert_turb_driver.F90:107).

Physics (Grenier & Bretherton 2001, MWR), with isca_tpu's documented
deviations (zisocl's incremental CL extension replaced by one entrainment
interface at top and base with merging of touching CLs; the cloud-top
radiative production entering the bulk TKE budget linearly):
  - moist conserved variables sl, qt; buoyancy coefficients blended between
    unsaturated and saturated limits by the interface saturated fraction
  - N2, S2, Ri at interfaces; convective layers (CLs) where Ri < rimaxentr
  - bulk CL TKE from galperin stability functions and l(z) = kz/(1+kz/(tunl
    depth)); per-interface TKE shape, entrainment K at CL edges with
    evaporative enhancement at cloudy tops
  - stable turbulent layers (Ri < ricrit outside CLs): local equilibrium.

All columns batched. A connected run of interfaces is a segment; the
segment sums are sums of masked one-hot products over the (small) level
axis in the field's dtype (exact FP32 on the card: no matrix unit is
involved). The segment maxima and minima fill the cells outside a segment
with -inf/inf through `torch.where` and replace an empty segment's result
before it is used, so no infinity reaches a product.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from isca_tpu_torch.constants import Constants, EARTH
from isca_tpu_torch.physics.sat_vapor_pres import SatVaporPres

# constants (edt.F90:240-279)
B1 = 5.8
TUNL = 0.085
ALPH1, ALPH2, ALPH3, ALPH4, ALPH5 = 0.5562, -4.3640, -34.6764, -6.1272, 0.6986
RICRIT = 0.19
MU = 70.0
A1L = 0.10
A2L = 15.0
A3L = 0.8
EVHCMAX = 10.0
RIMAXENTR = 0.0
TKEMAX = 20.0
TKEMIN = 1.0e-6
NTZERO = 1.0e-10
VONKARM = 0.4
B123 = B1 ** (2.0 / 3.0)


@dataclasses.dataclass(frozen=True)
class EDTConfig:
    qcminfrac: float = 1.0e-3
    constants: Constants = EARTH
    svp: SatVaporPres = SatVaporPres()


class EDTResult(NamedTuple):
    k_m: torch.Tensor      # (..., L) diffusivity at half level k (interface k)
    k_t: torch.Tensor
    tke: torch.Tensor      # (..., L+1) turbulent kinetic energy at interfaces
    ri: torch.Tensor       # (..., L+1)
    pblh: torch.Tensor     # (...,)


def galperin(ri):
    """Galperin (1988) stability functions (edt.F90:4511-4552)."""
    ri = torch.clamp(ri, max=0.163)
    trma = ALPH3 * ALPH4 * ri + 2.0 * B1 * (ALPH2 - ALPH4 * ALPH5 * ri)
    trmb = ri * (ALPH3 + ALPH4) + 2.0 * B1 * (-ALPH5 * ri + ALPH1)
    det = torch.clamp(trmb * trmb - 4.0 * trma * ri, min=0.0)
    gh = torch.clamp((-trmb + torch.sqrt(det)) / (2.0 * trma), -0.28, 0.0233)
    sh = ALPH5 / (1.0 + ALPH3 * gh)
    sm = (ALPH1 + ALPH2 * gh) / ((1.0 + ALPH3 * gh) * (1.0 + ALPH4 * gh))
    return gh, sh, sm


def _lengthscale(height, depth):
    return VONKARM * height / (1.0 + VONKARM * height / (TUNL * torch.clamp(depth, min=1.0)))


def _segments(mask, dtype):
    """Connected runs of True along the last axis -> onehot (..., N, S) in
    `dtype`, 1 where interface n lies in segment s (1..nseg)."""
    n = mask.shape[-1]
    prev = torch.cat([torch.zeros_like(mask[..., :1]), mask[..., :-1]], dim=-1)
    start = mask & ~prev
    segid = torch.cumsum(start.to(torch.int32), dim=-1) * mask      # 0 outside
    nseg_max = (n + 1) // 2 + 1
    ids = torch.arange(1, nseg_max + 1, device=mask.device, dtype=torch.int32)
    return (segid[..., None] == ids).to(dtype)


def _to_seg(onehot, x):
    """Per-segment sums of x (..., N): (..., S)."""
    return torch.sum(onehot * x[..., None], dim=-2)


def _from_seg(onehot, s):
    """Each interface's segment value of s (..., S): (..., N)."""
    return torch.sum(onehot * s[..., None, :], dim=-1)


def _seg_extent(onehot, member, zi):
    """(top, bottom) interface height of each segment (-inf/inf where the
    segment is empty)."""
    inside = onehot > 0
    ztop = torch.amax(torch.where(inside, torch.where(member, zi, -torch.inf)[..., None],
                                  -torch.inf), dim=-2)
    zbot = torch.amin(torch.where(inside, torch.where(member, zi, torch.inf)[..., None],
                                  torch.inf), dim=-2)
    return ztop, zbot


def edt(cfg: EDTConfig, tdtlw, u_star, b_star, t, qv, ql, qi, qa,
        u, v, z_full, p_full, z_half, p_half) -> EDTResult:
    """All (..., L) top-down; z/p_half (..., L+1). tdtlw LW heating [K/s].
    Returns diffusivities at half levels (interface k above full level k)."""
    C = cfg.constants
    L = t.shape[-1]
    dtype = t.dtype
    karr = torch.arange(L + 1, device=t.device)

    zsurf = z_half[..., -1]
    zm = z_full - zsurf[..., None]                      # full heights AGL
    zi = z_half - zsurf[..., None]                      # interface heights

    qc = ql + qi
    qt = qv + qc
    hleff = (torch.clamp(0.05 * (t - C.tfreeze + 20.0), 0.0, 1.0) * C.hlv
             + torch.clamp(0.05 * (C.tfreeze - t), 0.0, 1.0) * C.hls)
    sl = C.cp_air * t + C.grav * zm - hleff * qc
    slv = sl * (1.0 + C.zvir * qt)

    # saturation at the liquid-water temperature (edt.F90 sfdiag inputs)
    tl = t - hleff * qc / C.cp_air
    esl = cfg.svp.es(tl)
    d622 = C.rdgas / C.rvgas
    qsl = d622 * esl / torch.clamp(p_full - (1.0 - d622) * esl, min=1.0)
    dqsldtl = qsl * hleff / (C.rvgas * tl * tl)

    # buoyancy coefficients (trbintd :2010-2022)
    bfact = C.grav / (t * (1.0 + C.zvir * qv - qc))
    chu = (1.0 + C.zvir * qt) * bfact / C.cp_air
    chs = ((1.0 + (1.0 + C.zvir) * dqsldtl * t)
           / (1.0 + hleff * dqsldtl / C.cp_air)) * bfact / C.cp_air
    cmu = C.zvir * bfact * t
    cms = hleff * chs - bfact * t

    # interface values (average adjacent layers); saturated fraction from
    # the prognosed/diagnosed cloud fraction (simplified sfdiag)
    def iface(a):
        return 0.5 * (a[..., :-1] + a[..., 1:])        # (..., L-1): k=1..L-1

    sfi = torch.clamp(iface(qa), 0.0, 1.0)
    ch = iface(chu) * (1.0 - sfi) + iface(chs) * sfi
    cm = iface(cmu) * (1.0 - sfi) + iface(cms) * sfi
    rdz = 1.0 / (zm[..., :-1] - zm[..., 1:])
    dsldz = (sl[..., :-1] - sl[..., 1:]) * rdz
    dqtdz = (qt[..., :-1] - qt[..., 1:]) * rdz
    n2_i = ch * dsldz + cm * dqtdz
    s2_i = torch.clamp(((u[..., :-1] - u[..., 1:]) ** 2
                        + (v[..., :-1] - v[..., 1:]) ** 2) * rdz ** 2, min=NTZERO)
    ri_i = n2_i / s2_i

    # pad to (..., L+1) interfaces: index 0 = model top, L = surface
    pad0 = torch.zeros_like(ri_i[..., :1])
    n2 = torch.cat([pad0, n2_i, pad0], dim=-1)
    s2 = torch.cat([pad0, s2_i, pad0 + NTZERO], dim=-1)
    ri = torch.cat([pad0, ri_i, pad0], dim=-1)

    bflxs = u_star * b_star                            # surface buoy flux
    tkes = torch.clamp(B123 * u_star ** 2, TKEMIN, TKEMAX)

    # riex: surface interface treated via rimaxentr - bflxs (exacol :2319)
    riex = torch.cat([ri[..., :-1], (RIMAXENTR - bflxs)[..., None]], dim=-1)
    core = (riex < RIMAXENTR) & (karr >= 1)
    # entrainment interfaces: one above and one below each core run;
    # touching CLs merge (zisocl fixed point)
    nothing = torch.zeros_like(core[..., :1])
    up = torch.cat([core[..., 1:], nothing], dim=-1)
    dn = torch.cat([nothing, core[..., :-1]], dim=-1)
    belongcv = (core | up | dn) & (karr >= 1)

    onehot = _segments(belongcv, dtype)                # (..., L+1, S)
    seg_any = torch.sum(onehot, dim=-2) > 0            # (..., S)

    # per-interface geometry
    dz_int = torch.cat([torch.zeros_like(zm[..., :1]), zm[..., :-1] - zm[..., 1:],
                        zm[..., -1:]], dim=-1)         # dz around iface k

    # segment top/base interface heights -> lbulk
    seg_ztop, seg_zbot = _seg_extent(onehot, belongcv, zi)
    seg_ztop = torch.where(seg_any, seg_ztop, 1.0)
    seg_zbot = torch.where(seg_any, seg_zbot, 0.0)
    has_sfc = onehot[..., -1, :] > 0                   # segment touches sfc
    zm_low = zm[..., -1]                               # lowest full level

    lbulk = seg_ztop - seg_zbot
    # surface segment: lbulk measured to the lowest full level when the
    # surface buoyancy flux is negative (zisocl :2470-2490)
    lbulk = torch.where(has_sfc & (bflxs <= 0)[..., None],
                        seg_ztop - zm_low[..., None], lbulk)
    lbulk = torch.clamp(lbulk, min=1.0)

    # per-interface length scale with its segment's lbulk
    lbulk_k = _from_seg(onehot, lbulk)
    leng = _lengthscale(torch.clamp(zi, min=1.0), torch.clamp(lbulk_k, min=1.0))

    # integrals over interior CL interfaces (exclude entrainment edges at
    # the segment top/base; interior = core interfaces)
    interior = core & belongcv & (karr >= 1) & (karr <= L - 1)
    w_int = torch.where(interior, dz_int, 0.0)
    l2n2 = _to_seg(onehot, w_int * leng ** 2 * n2)
    l2s2 = _to_seg(onehot, w_int * leng ** 2 * s2)
    lint = _to_seg(onehot, w_int)
    # surface TKE contribution (zisocl :2462-2466)
    sfc_up = has_sfc & (bflxs > 0)[..., None]
    dwsurf = torch.where(sfc_up, (tkes / B1 * zm_low)[..., None], 0.0)
    lint = lint + torch.where(sfc_up, zm_low[..., None], 0.0)
    lint = torch.clamp(lint, min=1.0)

    ricl = torch.clamp(l2n2 / torch.clamp(l2s2, min=NTZERO), max=RICRIT)
    ghc, shc, smc = galperin(ricl)

    # cloud-top radiative production: LW flux divergence at the CL top
    dpg = (p_half[..., 1:] - p_half[..., :-1]) / C.grav    # (..., L)
    radflux = -tdtlw * C.cp_air * dpg                      # W/m2 per layer
    rho = p_full / (C.rdgas * t * (1.0 + C.zvir * qv - qc))
    buoy_rad = C.grav * torch.clamp(radflux, min=0.0) / (rho * C.cp_air * t)
    # attribute a layer's radiative buoyancy production to the interface
    # above it when that interface is a CL top edge
    prev_cv = torch.cat([nothing, belongcv[..., :-1]], dim=-1)
    is_top_edge = belongcv & ~prev_cv
    buoy_rad_i = torch.cat([buoy_rad, pad0], dim=-1)
    radf_seg = _to_seg(onehot, torch.where(is_top_edge, buoy_rad_i * leng * dz_int, 0.0))

    wint = torch.clamp(-shc * l2n2 + smc * l2s2 + dwsurf + radf_seg, min=0.0)
    wbrk = wint / lint
    ebrk = torch.clamp(B1 * wbrk, TKEMIN, TKEMAX)

    # per-interface TKE and diffusivities inside CLs (caleddy :3940-3990)
    shc_k = _from_seg(onehot, shc)
    smc_k = _from_seg(onehot, smc)
    ebrk_k = _from_seg(onehot, ebrk)
    wbrk_k = torch.clamp(ebrk_k / B1, min=TKEMIN)
    wcap = leng ** 2 * (-shc_k * n2 + smc_k * s2)
    mull = MU * leng / torch.clamp(lbulk_k, min=1.0)
    rcap = (mull + wcap / wbrk_k) / (mull + 1.0)
    tke_cv = torch.clamp(ebrk_k * torch.clamp(rcap, min=0.0), TKEMIN, TKEMAX)
    kvh_cv = leng * torch.sqrt(tke_cv) * shc_k
    kvm_cv = leng * torch.sqrt(tke_cv) * smc_k

    # entrainment interfaces (caleddy :4060-4170): replace K at the edges
    next_cv = torch.cat([belongcv[..., 1:], nothing], dim=-1)
    is_base_edge = belongcv & ~next_cv & (karr < L)    # surface not an edge
    jzm = dz_int
    jbu = torch.clamp(n2 * dz_int, min=1.0e-6)
    # evaporative enhancement at cloudy tops: ql just below the top edge
    ql_below = torch.cat([ql, ql[..., -1:]], dim=-1)
    slv_ext = torch.cat([slv, slv[..., -1:]], dim=-1)
    slv_2up = torch.cat([slv_ext[..., :2], slv_ext[..., :-2]], dim=-1)
    jt2slv = torch.clamp(slv_2up - slv_ext, min=1.0)
    hleff_i = torch.cat([hleff, hleff[..., -1:]], dim=-1)
    evhc = torch.where(ql_below > cfg.qcminfrac * 1.0e-3,
                       torch.clamp(1.0 + A2L * A3L * hleff_i * ql_below / jt2slv,
                                   max=EVHCMAX), 1.0)
    kentr_top = (jzm * A1L * torch.sqrt(ebrk_k)
                 * torch.clamp(evhc * ebrk_k / (jbu * torch.clamp(leng, min=1.0)), max=1.0))
    kentr_base = (jzm * A1L * torch.sqrt(ebrk_k)
                  * torch.clamp(ebrk_k / (jbu * torch.clamp(leng, min=1.0)), max=1.0))
    kvh_cv = torch.where(is_top_edge, kentr_top, kvh_cv)
    kvm_cv = torch.where(is_top_edge, kentr_top, kvm_cv)
    kvh_cv = torch.where(is_base_edge, kvh_cv + kentr_base, kvh_cv)
    kvm_cv = torch.where(is_base_edge, kvm_cv + kentr_base, kvm_cv)

    # ---- stable turbulent layers (caleddy :4318-4412) ----
    belongst = (ri < RICRIT) & ~belongcv & (karr >= 1)
    belongst = torch.cat([belongst[..., :-1], belongst[..., -1:] | ~belongcv[..., -1:]],
                         dim=-1)
    onehot_s = _segments(belongst, dtype)
    seg_ztop_s, seg_zbot_s = _seg_extent(onehot_s, belongst, zi)
    seg_ztop_s = torch.where(torch.isfinite(seg_ztop_s), seg_ztop_s, 1.0)
    seg_zbot_s = torch.where(torch.isfinite(seg_zbot_s), seg_zbot_s, 0.0)
    lbulk_s = torch.clamp(seg_ztop_s - seg_zbot_s, min=1.0)
    lbulk_sk = _from_seg(onehot_s, lbulk_s)
    leng_s = _lengthscale(torch.clamp(zi, min=1.0), torch.clamp(lbulk_sk, min=1.0))
    _, sh_s, sm_s = galperin(ri)
    tke_st = torch.clamp(B1 * leng_s ** 2 * (-sh_s * n2 + sm_s * s2), TKEMIN, TKEMAX)
    kvh_st = leng_s * torch.sqrt(tke_st) * sh_s
    kvm_st = leng_s * torch.sqrt(tke_st) * sm_s

    kvh = torch.where(belongcv, kvh_cv, torch.where(belongst, kvh_st, 0.0))
    kvm = torch.where(belongcv, kvm_cv, torch.where(belongst, kvm_st, 0.0))
    kvh = torch.clamp(torch.nan_to_num(kvh), 0.0, 1.0e4)
    kvm = torch.clamp(torch.nan_to_num(kvm), 0.0, 1.0e4)
    tke = torch.where(belongcv, tke_cv, torch.where(belongst, tke_st, 0.0))
    tke = torch.cat([tke[..., :-1], tkes[..., None]], dim=-1)

    turb = belongcv | belongst
    pblh = torch.amax(torch.where(turb[..., 1:], zi[..., 1:], 0.0), dim=-1)

    # diffusivities at our half-level convention (interface k = K[..., k])
    return EDTResult(k_m=kvm[..., :L], k_t=kvh[..., :L], tke=tke, ri=ri, pblh=pblh)
