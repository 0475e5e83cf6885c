"""Entrainment-closure boundary layer (Bretherton-style `entrain` module).

Port of isca_tpu/physics/entrain.py (reference:
src/atmos_param/entrain/entrain.F90 - entrain :786-1853, pbl_depth
:1901-1964, radml_depth :2160-2224, diffusivity_pbl :2266-2305). Selected by
`vert_turb_driver_nml do_entrain` (vert_turb_driver.F90:110).

The scheme diagnoses two kinds of mixed layers and replaces the
boundary-layer diffusivities within them:

1. *Surface-driven convective PBL* (b_star > 0): PBL top from a lifted
   surface parcel with Monin-Obukhov-scaled excess buoyancy; K profile = MO
   similarity in the inner `frac_inner` fraction, cubic Troen-Mahrt outer
   profile above it; entrainment K at the inversion from the closure
   w_e = beta_surf (V_surf^3 + V_shear^3)/h / (g dslv/slv + W^2/h).
2. *Radiatively-driven mixed layer* (stratocumulus): cloud top located from
   the longwave cooling maximum below `zcldtopmax`; mixed-layer base from a
   cloud-top parcel (radml_depth); radiative velocity scale
   v_rad^3 = g h dR / (rho slv); entrainment K at cloud top with beta_rad,
   interior K ~ 0.85 k v_rad z'^2 sqrt(1-z') profile.

All columns batched; the reference's per-column level searches are masked
argmax reductions over the level axis (on a uint8 mask: the first hit wins,
index 0 when there is none, as jnp.argmax on a boolean). Every level index
taken per column lies in [0, L) by construction (a column without a parcel
crossing falls back to level 1). Level convention: (..., L) top-down.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from isca_tpu_torch.constants import Constants, EARTH
from isca_tpu_torch.physics.diffusivity import _mo_diff
from isca_tpu_torch.physics.monin_obukhov import MOConfig


@dataclasses.dataclass(frozen=True)
class EntrainConfig:
    """entrain_nml (entrain.F90:142-185)."""
    akmax: float = 1.0e4
    wentrmax: float = 0.05
    parcel_buoy: float = 1.0
    frac_inner: float = 0.1
    beta_surf: float = 0.23
    ashear: float = 25.0
    beta_rad: float = 0.23
    radfmin: float = 30.0
    qdotmin: float = 10.0       # K/day
    radperturb: float = 0.3
    critjump: float = 0.3
    parcel_option: int = 1
    zcldtopmax: float = 3.0e3
    pr: float = 0.75
    qamin: float = 0.3
    do_jump_exit: bool = True
    apply_entrain: bool = True
    convect_shutoff: bool = False
    mo: MOConfig = MOConfig()
    constants: Constants = EARTH


class EntrainResult(NamedTuple):
    k_m: torch.Tensor        # (..., L) merged diffusivities at half levels
    k_t: torch.Tensor
    zsml: torch.Tensor       # (...,) surface mixed layer depth [m]
    use_entr: torch.Tensor   # (..., L) 1 where the scheme set the K
    zradbase: torch.Tensor
    zradtop: torch.Tensor
    wentr_pbl: torch.Tensor
    wentr_rad: torch.Tensor


SMALL = 1.0e-4
VONKARM = 0.4


def _first(cond):
    """Index of the first True along the last axis (0 if none)."""
    return torch.argmax(cond.to(torch.uint8), dim=-1)


def _bottom_most_true(cond):
    """Largest level index with cond True (first hit scanning up from the
    bottom); returns (idx, found). cond (..., L)."""
    L = cond.shape[-1]
    return L - 1 - _first(torch.flip(cond, (-1,))), torch.any(cond, dim=-1)


def _top_most_true(cond):
    """Smallest level index with cond True; (idx, found)."""
    return _first(cond), torch.any(cond, dim=-1)


def _take(a, idx):
    return torch.gather(a, -1, idx[..., None]).squeeze(-1)


def entrain(cfg: EntrainConfig, tdtlw, convect, u_star, b_star,
            t, qv, ql, qi, qa, u, v, z_full, p_full, z_half, p_half,
            diff_m, diff_t) -> EntrainResult:
    """tdtlw: LW heating rate [K/s]; convect bool (...,); diff_m/diff_t the
    incoming diffusivities (overwritten inside detected mixed layers when
    apply_entrain). All (..., L) top-down, z/p_half (..., L+1)."""
    C = cfg.constants
    L = t.shape[-1]
    karr = torch.arange(L, device=t.device)
    onehot = lambda idx: karr == idx[..., None]

    zsurf = z_half[..., -1]
    zf = z_full - zsurf[..., None]
    zh = z_half - zsurf[..., None]          # (..., L+1)

    # liquid-water virtual static energy (entrain.F90:905-911)
    hleff = (torch.clamp(0.05 * (t - C.tfreeze + 20.0), 0.0, 1.0) * C.hlv
             + torch.clamp(0.05 * (C.tfreeze - t), 0.0, 1.0) * C.hls)
    slv = C.cp_air * t + C.grav * zf - hleff * (ql + qi)
    slv = slv * (1.0 + C.zvir * (qv + ql + qi))
    density = p_full / (C.rdgas * t * (1.0 + C.zvir * qv - ql - qi))
    tcp = slv / C.cp_air                    # (..., L)

    # ================= surface-driven convective PBL =================
    conv_active = b_star > 0.0
    conv3 = conv_active[..., None]

    tb = tcp[..., -1]
    h1 = zf[..., -1]
    km_ref, _ = _mo_diff(cfg.mo, h1, u_star, b_star)
    ws = torch.clamp(km_ref / (VONKARM * h1), min=SMALL)
    excess = cfg.parcel_buoy * u_star * b_star / C.grav / ws
    svp = tb * (1.0 + excess)

    # bottom-most level k in [1, L-2] with tcp[k] > svp (pbl_depth :1944-1952)
    cond = (tcp > svp[..., None]) & (karr >= 1) & (karr <= L - 2)
    kfound, found = _bottom_most_true(cond)
    kfound = torch.where(found, kfound, 1)
    t2 = _take(tcp, kfound)
    h2 = _take(zf, kfound)
    t1 = _take(tcp, kfound + 1)
    h1b = _take(zf, kfound + 1)
    zsml = h2 + (h1b - h2) * (t2 - svp) / torch.where(t2 != t1, t2 - t1, 1.0)
    ipbl = kfound + 1

    # strong-inversion adjustment (entrain.F90:1006-1015): bottom-most level
    # k in [ipbl+1, L-1] whose jump exceeds critjump caps the PBL there
    jump = torch.cat([torch.zeros_like(tcp[..., :1]), tcp[..., :-1] - tcp[..., 1:]], dim=-1)
    condj = (jump > cfg.critjump) & (karr > ipbl[..., None]) & (karr <= L - 1)
    kj, foundj = _bottom_most_true(condj)
    ipbl = torch.where(foundj, kj, ipbl)
    zsml = torch.where(foundj, _take(zh, kj), zsml)
    zsml = torch.clamp(zsml, min=SMALL)

    vsurf3 = u_star * b_star * zsml
    vshear3 = cfg.ashear * u_star ** 3
    tcp_ipbl = _take(tcp, ipbl)
    dslv = torch.clamp(_take(tcp, ipbl - 1) - tcp_ipbl, min=0.1)
    tmp1 = C.grav * dslv / tcp_ipbl
    tmp2 = (vsurf3 + vshear3) ** (2.0 / 3.0) / zsml
    wentr_pbl = torch.clamp(cfg.beta_surf * (vsurf3 + vshear3) / zsml
                            / (tmp1 + tmp2), 0.0, cfg.wentrmax)
    k_entr_sfc = torch.clamp(wentr_pbl * (_take(zf, ipbl - 1) - _take(zf, ipbl)),
                             max=cfg.akmax)
    if cfg.convect_shutoff:
        shut = convect & conv_active
        wentr_pbl = torch.where(shut, 0.0, wentr_pbl)
        k_entr_sfc = torch.where(shut, 0.0, k_entr_sfc)

    oh_ipbl = onehot(ipbl) & conv3
    k_sfc_ipbl = torch.where(oh_ipbl, k_entr_sfc[..., None], 0.0)

    # Troen-Mahrt profile below the entrainment level (diffusivity_pbl)
    hinner = cfg.frac_inner * zsml
    zin = zh[..., :L]                       # half level k (above full k)
    km_i, kt_i = _mo_diff(cfg.mo, torch.clamp(zin, min=SMALL),
                          u_star[..., None], b_star[..., None])
    km_h, kt_h = _mo_diff(cfg.mo, torch.clamp(hinner, min=SMALL), u_star, b_star)
    denom = torch.clamp(zsml - hinner, min=SMALL)[..., None]
    factor = torch.clamp((zin / hinner[..., None])
                         * (1.0 - (zin - hinner[..., None]) / denom) ** 2, min=0.0)
    inner = zin < hinner[..., None]
    km_prof = torch.where(inner, km_i, torch.clamp(km_h[..., None] * factor, max=cfg.akmax))
    kt_prof = torch.where(inner, kt_i, torch.clamp(kt_h[..., None] * factor, max=cfg.akmax))
    below = (karr > ipbl[..., None]) & conv3
    k_t_entr = k_sfc_ipbl + torch.where(below, kt_prof, 0.0)
    k_m_entr = k_sfc_ipbl + torch.where(below, km_prof, 0.0)
    use_entr = (karr >= ipbl[..., None]) & conv3
    convpbl = conv_active

    # ================= radiatively-driven mixed layer =================
    dpg = (p_half[..., 1:] - p_half[..., :-1]) / C.grav
    radf_lay = -tdtlw * C.cp_air * dpg          # W/m2 per layer
    eligible = zh[..., :L] < cfg.zcldtopmax
    # primary criterion: integrated cooling above radfmin (entrain.F90:1060)
    cand1 = eligible & (radf_lay > cfg.radfmin)
    k1, f1 = _top_most_true(
        cand1 & (radf_lay >= torch.amax(torch.where(cand1, radf_lay, -torch.inf),
                                        dim=-1, keepdim=True)))
    # fallback: cooling rate above qdotmin K/day (entrain.F90:1073)
    qdot = -tdtlw * 86400.0
    cand2 = eligible & (qdot > cfg.qdotmin)
    k2, f2 = _top_most_true(
        cand2 & (qdot >= torch.amax(torch.where(cand2, qdot, -torch.inf),
                                    dim=-1, keepdim=True)))
    kcld = torch.where(f1, k1, k2)
    rad_active = f1 | f2
    maxradf = torch.where(f1, _take(radf_lay, torch.where(f1, k1, 0)),
                          _take(radf_lay, torch.where(f2, k2, 0)))

    # move the top down one level if slv decreases upward there (:1085-1090)
    kcld = torch.clamp(kcld, 1, L - 1)
    unstable = _take(tcp, kcld - 1) < _take(tcp, kcld)
    kcld = torch.where(unstable, kcld - 1, kcld)
    kcld = torch.clamp(kcld, 1, L - 1)
    tcp_kcld = _take(tcp, kcld)
    tcp_km1 = _take(tcp, kcld - 1)
    still_unstable = tcp_km1 < tcp_kcld
    rad_active = rad_active & ~(unstable & still_unstable)

    # require cloud at/near the top (:1094-1096)
    kp1 = torch.clamp(kcld + 1, max=L - 1)
    has_cloud = ((_take(qa, kcld) >= cfg.qamin)
                 | (_take(qa, kcld - 1) >= cfg.qamin)
                 | (_take(qa, kp1) >= cfg.qamin))
    rad_active = rad_active & has_cloud
    rad3 = rad_active[..., None]

    tcp_kp1 = _take(tcp, kp1)
    svpcp = torch.minimum(tcp_kcld, tcp_kp1)
    if cfg.parcel_option != 1:
        svpcp = torch.minimum(tcp_kcld, tcp_kp1 + cfg.radperturb)
    zradtop = _take(zh, kcld)

    # radml_depth: first level below cloud top where tcp < svpcp - radperturb,
    # or a critjump stable interface (vectorized :2160-2224)
    svpar = svpcp - cfg.radperturb
    condb = (tcp < svpar[..., None]) & (karr > kcld[..., None])
    kb, fb = _top_most_true(condb)
    kb = torch.where(fb, kb, L - 1)
    t2b = _take(tcp, kb)
    t1bb = _take(tcp, torch.clamp(kb - 1, min=0))
    h2b = _take(zf, kb)
    h1bb = _take(zf, torch.clamp(kb - 1, min=0))
    zb_parcel = h2b + (h1bb - h2b) * (svpar - t2b) / torch.where(
        t1bb != t2b, t1bb - t2b, 1.0)
    if cfg.do_jump_exit:
        condjump = (jump > cfg.critjump) & (karr > (kcld + 1)[..., None])
        kjmp, fjmp = _top_most_true(condjump)
        use_jump = fjmp & (~fb | (kjmp < kb))
        zb_parcel = torch.where(use_jump, _take(zh, kjmp), zb_parcel)
        fb = fb | fjmp
    zradbase = torch.where(fb, torch.clamp(zb_parcel, min=0.0), 0.0)
    zradml = torch.clamp(zradtop - zradbase, min=SMALL)

    vrad3 = C.grav * zradml * maxradf / (_take(density, kcld) * _take(slv, kcld))
    vrad3 = torch.clamp(vrad3, min=0.0)
    vrad = vrad3 ** (1.0 / 3.0)
    dslv_r = torch.clamp(tcp_km1 - svpcp, min=0.1)
    tmp1r = C.grav * dslv_r / tcp_kcld
    tmp2r = vrad ** 2 / zradml
    wentr_rad = torch.clamp(cfg.beta_rad * vrad3 / zradml / (tmp1r + tmp2r),
                            0.0, cfg.wentrmax)
    dz_top = _take(zf, kcld - 1) - _take(zf, kcld)
    k_entr_rad = torch.clamp(wentr_rad * dz_top, max=cfg.akmax)

    # combined surface+radiative inversion (:1125-1140)
    same = rad_active & convpbl & (ipbl == kcld)
    tmp2c = (vrad3 + vsurf3 + vshear3) ** (2.0 / 3.0) / zradml
    wentr_c = torch.clamp(
        (cfg.beta_surf * (vsurf3 + vshear3) + cfg.beta_rad * vrad3)
        / zradml / (tmp1r + tmp2c), 0.0, cfg.wentrmax)
    k_entr_c = torch.clamp(wentr_c * dz_top, max=cfg.akmax)
    wentr_rad = torch.where(same, wentr_c, wentr_rad)

    oh_kcld = onehot(kcld) & rad3
    k_rad_top = torch.where(oh_kcld, torch.where(same, k_entr_c, k_entr_rad)[..., None], 0.0)
    # when combined, the cloud-top K REPLACES the surface entrainment K there
    replaced = same[..., None] & oh_kcld
    k_t_entr = torch.where(replaced, 0.0, k_t_entr) + k_rad_top
    k_m_entr = torch.where(replaced, 0.0, k_m_entr) + k_rad_top
    use_entr = use_entr | oh_kcld

    # interior radiative-ML profile (:1148-1166)
    ztmp = torch.clamp((zh[..., :L] - zradbase[..., None]) / zradml[..., None], 0.0, 1.0)
    k_rad_in = torch.clamp(
        0.85 * VONKARM * vrad[..., None] * ztmp ** 2
        * zradml[..., None] * torch.sqrt(torch.clamp(1.0 - ztmp, min=0.0)),
        max=cfg.akmax)
    in_radml = (karr > kcld[..., None]) & (ztmp > 0.0) & rad3
    k_t_entr = k_t_entr + torch.where(in_radml, k_rad_in, 0.0)
    k_m_entr = k_m_entr + torch.where(in_radml, cfg.pr * k_rad_in, 0.0)
    use_entr = use_entr | in_radml

    # decoupled-layer guard (:1170-1181): kill surface entrainment when the
    # radiative base undercuts the surface layer from above
    kill = (zradbase < zsml) & convpbl & (ipbl > kcld) & rad_active
    killed = torch.where(kill[..., None], k_sfc_ipbl, 0.0)
    k_t_entr = k_t_entr - killed
    k_m_entr = k_m_entr - killed
    wentr_pbl = torch.where(kill, 0.0, wentr_pbl)

    k_t_entr = torch.clamp(k_t_entr, min=0.0)
    k_m_entr = torch.clamp(k_m_entr, min=0.0)

    if cfg.apply_entrain:
        sel = use_entr & (karr >= 1)
        k_m = torch.where(sel, k_m_entr, diff_m)
        k_t = torch.where(sel, k_t_entr, diff_t)
    else:
        k_m, k_t = diff_m, diff_t

    return EntrainResult(
        k_m=k_m, k_t=k_t, zsml=torch.where(conv_active, zsml, 0.0),
        use_entr=use_entr.to(t.dtype),
        zradbase=torch.where(rad_active, zradbase, 0.0),
        zradtop=torch.where(rad_active, zradtop, 0.0),
        wentr_pbl=torch.where(conv_active, wentr_pbl, 0.0),
        wentr_rad=torch.where(rad_active, wentr_rad, 0.0))
