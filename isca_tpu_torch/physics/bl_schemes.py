"""Shallow-convection and stable-boundary-layer diffusivity companions.

Port of isca_tpu/physics/bl_schemes.py, two vert_turb_driver plug-ins:
  - src/atmos_param/shallow_conv/shallow_conv.F90 (SHALLOW_CONV + MYLCL):
    enhanced heat/moisture diffusivity akhsc through buoyant shallow-cumulus
    layers between the LCL and pshalow, with detrainment-edge tapering.
  - src/atmos_param/stable_bl_turb/stable_bl_turb.F90 (STABLE_BL_TURB):
    Louis-type local mixing with Monin-Obukhov stable phi (stable_option=1,
    monin_obukhov_kernel.F90 monin_obukhov_stable_mix), a blended length
    scale vonkarm z / (1 + vonkarm z / als), and a u*/f PBL cap.

Both are whole-tensor mask formulations of the reference's per-column level
loops; the MYLCL Newton solve is a Python loop over its 10 iterations.
Levels (..., L) top-down, diffusivities on half levels like diffusivity/my25.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from isca_tpu_torch.constants import Constants, EARTH


def _max_below(akhsc, x):
    """akhsc with slots 1.. raised to at least x (..., L-1)."""
    return torch.cat([akhsc[..., :1], torch.maximum(akhsc[..., 1:], x)], dim=-1)


# ---------------------------------------------------------------------------
# shallow convection
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShallowConvConfig:
    """shalconv_nml (shallow_conv.F90:35-42)."""
    lipps: bool = False
    ldetran: bool = True
    theqvcr: float = 0.0
    pshalow: float = 750.0e2
    akhsc0: float = 5.0
    kctop: int = 3               # 1-based highest level allowed to convect
    constants: Constants = EARTH


def mylcl(cfg: ShallowConvConfig, svp, t_parc, q_parc, p_parc, p_half,
          iters: int = 10):
    """Parcel LCL pressure + the half-level index just above it
    (MYLCL, shallow_conv.F90; Newton iteration on T_lcl)."""
    C = cfg.constants
    d622 = C.rdgas / C.rvgas
    kappa = C.kappa
    clclo = t_parc * ((1.0 + d622 / torch.clamp(q_parc, min=1e-10)) / p_parc) ** kappa

    tlcl = t_parc
    for _ in range(iters):
        es = svp.es(tlcl)
        des = svp.des_dt(tlcl)
        xy1 = kappa * clclo * des
        xy2 = es ** (1.0 - kappa)
        tlcl = (xy1 * tlcl - clclo * es) / (xy1 - xy2)
    plcl = (1.0 + d622 / torch.clamp(q_parc, min=1e-10)) * svp.es(tlcl)
    plcl = torch.minimum(torch.maximum(plcl, torch.full_like(plcl, cfg.pshalow)), p_parc)
    L = p_half.shape[-1] - 1
    hit = (plcl[..., None] >= p_half[..., 1:-1]) & (plcl[..., None] <= p_half[..., 2:])
    kidx = torch.arange(1, L, device=p_half.device)
    kbase = torch.amax(torch.where(hit, kidx, 1), dim=-1)
    return plcl, kbase


def shallow_conv(cfg: ShallowConvConfig, svp, temp, qmix0, p_full, p_half):
    """akhsc (..., L) heat/moisture diffusivity on half levels
    (SHALLOW_CONV, shallow_conv.F90; non-Lipps branch)."""
    C = cfg.constants
    L = temp.shape[-1]
    lidx = torch.arange(L, device=temp.device)
    qmix = torch.clamp(qmix0, 1e-6, 0.2)
    qsat = svp.qs(temp, p_full)
    theta = temp * (1.0e5 / p_full) ** C.kappa

    t_p = temp[..., -1]
    q_p = torch.minimum(qmix[..., -1], qsat[..., -1])
    p_p = p_full[..., -1]
    plcl, ksiglcl = mylcl(cfg, svp, t_p, q_p, p_p, p_half)
    plcl_l = plcl[..., None]

    # thetav buoyancy gradient on half levels (:~70-85)
    thetav = theta * torch.exp(C.hlv / C.cp_air * qmix / temp)
    dph = p_full[..., 1:] - p_full[..., :-1]
    grad = (thetav[..., 1:] - thetav[..., :-1]) / dph     # index k ~ half k+1
    zero1 = torch.zeros_like(temp[..., :1])
    buoy = torch.cat([zero1, 0.5 * (grad[..., :-1] + grad[..., 1:]), zero1], dim=-1)

    crtkons = 0.0 if cfg.lipps else -cfg.theqvcr * C.rdgas / C.grav
    kc1 = cfg.kctop - 1 - 1      # kctopm1, 0-based
    valid_rng = (lidx >= max(kc1, 1)) & (lidx <= L - 2)

    # buoyant levels between pshalow and the LCL
    kbuoy_is_k = valid_rng & (p_full >= cfg.pshalow) & (p_full <= plcl_l) & (buoy >= crtkons)

    # prune buoyant level k-1 when the level below (k) is non-buoyant and
    # above the LCL (second loop, shallow_conv.F90: kbuoy(k-1)=kxp)
    cond = (p_full < plcl_l) & ~kbuoy_is_k
    kill = torch.cat([cond[..., 1:], torch.zeros_like(cond[..., :1])], dim=-1)
    kbuoy_is_k = kbuoy_is_k & ~kill

    akhsc = torch.zeros_like(temp)
    # the constants as tensors of temp's dtype where a mask selects them
    fill = lambda mask, x: torch.where(mask, x, torch.zeros_like(mask, dtype=temp.dtype))
    # main assignment: buoyant above the LCL half-level index -> akhsc(k+1)
    deep = kbuoy_is_k & (lidx <= ksiglcl[..., None])
    akhsc = _max_below(akhsc, fill(deep[..., :-1], cfg.akhsc0))

    if cfg.ldetran:
        # detrainment tapers at cloud top (:~110-125): kbuoy(k)==k while
        # kbuoy(k-1) off, below pshalow
        above_off = torch.cat([torch.ones_like(kbuoy_is_k[..., :1]), ~kbuoy_is_k[..., :-1]],
                              dim=-1)
        top_edge = kbuoy_is_k & above_off & (p_full >= cfg.pshalow)
        akhsc = torch.maximum(akhsc, fill(top_edge, 0.2 * cfg.akhsc0))
        akhsc = _max_below(akhsc, fill(top_edge[..., :-1], 0.6 * cfg.akhsc0))
        # LCL-crossing taper
        below = torch.cat([p_full[..., 1:], p_full[..., -1:]], dim=-1)
        crossing = (p_full <= plcl_l) & (below > plcl_l) & kbuoy_is_k
        akhsc = _max_below(akhsc, fill(crossing[..., :-1], 0.2 * cfg.akhsc0))

    # zero outside [pshalow, plcl] (final loop)
    off = (p_full <= cfg.pshalow) | (p_full >= plcl_l)
    akhsc = torch.cat([akhsc[..., :1], torch.where(off[..., :-1], 0.0, akhsc[..., 1:])],
                      dim=-1)
    return akhsc, plcl


# ---------------------------------------------------------------------------
# stable boundary layer
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StableBLConfig:
    """stable_bl_turb_nml (stable_bl_turb.F90:30-42)."""
    akmax: float = 1.0e4
    alpha: float = 0.5
    alsm: float = 150.0
    alsh: float = 150.0
    fmin: float = 5.0e-5
    hpbl_cap: float = 1000.0
    ri_crit: float = 0.2
    diff_min: float = 0.001
    winddifmin: float = 0.01
    small: float = 1.0e-5
    b_louis: float = 9.4
    cmstar_louis: float = 7.4
    chstar_louis: float = 5.3
    mo_rich_crit: float = 2.0     # monin_obukhov stable_option=1 default
    vonkarm: float = 0.4
    constants: Constants = EARTH


class StableBLResult(NamedTuple):
    akm: torch.Tensor     # (..., L) on half levels (index k = half level k)
    akh: torch.Tensor
    z_sbl: torch.Tensor
    f_sbl: torch.Tensor


def _stable_mix(rich, rich_crit):
    """1/phi^2 for stable Ri (monin_obukhov_kernel.F90
    monin_obukhov_stable_mix, stable_option=1)."""
    b_stab = 1.0 / rich_crit
    r = 1.0 / torch.clamp(rich, min=1e-10)
    a = r - b_stab
    b = r - 6.0
    disc = torch.clamp(b * b + 4.0 * a, min=0.0)
    zeta = (-b + torch.sqrt(disc)) / (2.0 * torch.where(a != 0.0, a, 1e-10))
    phi = 1.0 + b_stab * zeta + (5.0 - b_stab) * zeta / (1.0 + zeta)
    mix = 1.0 / (phi * phi)
    return torch.where((rich > 0.0) & (rich < rich_crit), mix, 0.0)


def stable_bl_turb(cfg: StableBLConfig, lat, temp, qv, um, vm, z_full,
                   z_half, u_star, b_star, ql=None, qi=None) -> StableBLResult:
    """Louis/MO local diffusivities (STABLE_BL_TURB). z above ground."""
    C = cfg.constants
    L = um.shape[-1]
    ql = torch.zeros_like(temp) if ql is None else ql
    qi = torch.zeros_like(temp) if qi is None else qi

    fcor = torch.clamp(torch.abs(2.0 * C.omega * torch.sin(lat)), min=cfg.fmin)
    hpbl = torch.clamp(cfg.alpha * u_star / fcor, max=cfg.hpbl_cap)

    # liquid-water virtual static energy (:~150)
    hleff = (torch.clamp(0.05 * (temp - C.tfreeze + 20.0), 0.0, 1.0) * C.hlv
             + torch.clamp(0.05 * (C.tfreeze - temp), 0.0, 1.0) * C.hls)
    d608 = C.rvgas / C.rdgas - 1.0
    slv = (C.cp_air * temp + C.grav * z_full - hleff * (ql + qi)) \
        * (1.0 + d608 * (qv + ql + qi))

    dsdzh = 1.0 / (z_full[..., :-1] - z_full[..., 1:])    # (..., L-1), >0
    du = dsdzh * (um[..., :-1] - um[..., 1:])
    dv = dsdzh * (vm[..., :-1] - vm[..., 1:])
    shear = du * du + dv * dv
    shear = torch.maximum(shear, (dsdzh * cfg.winddifmin) ** 2)
    dslv = slv[..., :-1] - slv[..., 1:]
    sbar = 0.5 * (slv[..., :-1] + slv[..., 1:])
    buoync = C.grav * dsdzh * dslv / sbar
    ri = buoync / shear

    zh_int = z_half[..., 1:L]                              # half levels 1..L-1
    zfunc_pbl = torch.where(
        (b_star < 0.0)[..., None],
        torch.clamp(zh_int / torch.clamp(hpbl, min=0.1)[..., None], 0.0, 1.0), 1.0)

    inv_kz = 1.0 / (cfg.vonkarm * zh_int)
    lm = 1.0 / (inv_kz + 1.0 / cfg.alsm)
    lh = 1.0 / (inv_kz + 1.0 / cfg.alsh)

    # stable side: MO phi blended with the (1-Ri/Ricrit)^2 outer form
    ri_pos = torch.clamp(ri, min=cfg.small)
    phi = _stable_mix(ri_pos, cfg.mo_rich_crit)
    phi = (1.0 - zfunc_pbl) * phi + zfunc_pbl * (
        1.0 - torch.clamp(ri_pos / cfg.ri_crit, max=1.0)) ** 2
    fm = phi
    fh = phi

    # unstable side: Louis 1979
    ri_neg = torch.clamp(ri, max=0.0)
    zfl = (1.0 + 1.0 / (dsdzh * zh_int)) ** (1.0 / 3.0) - 1.0
    zfl = zfl ** 1.5 / torch.sqrt(zh_int) * dsdzh ** 1.5
    cm = cfg.cmstar_louis * lm * lm * cfg.b_louis * zfl
    ch = cfg.chstar_louis * lh * lh * cfg.b_louis * zfl
    fm_l = 1.0 - cfg.b_louis * ri_neg / (1.0 + cm * torch.sqrt(-ri_neg))
    fh_l = 1.0 - cfg.b_louis * ri_neg / (1.0 + ch * torch.sqrt(-ri_neg))
    fm = torch.where(ri < cfg.small, fm_l, fm)
    fh = torch.where(ri < cfg.small, fh_l, fh)

    smag = torch.sqrt(shear)
    akm_i = torch.clamp(lm * lm * fm * smag, 0.0, cfg.akmax)
    akh_i = torch.clamp(lh * lh * fh * smag, 0.0, cfg.akmax)
    akm_i = torch.where(akm_i < cfg.diff_min, 0.0, akm_i)
    akh_i = torch.where(akh_i < cfg.diff_min, 0.0, akh_i)

    pad = lambda a: torch.cat([torch.zeros_like(a[..., :1]), a], dim=-1)
    unstable = (b_star < 0.0) & (hpbl > 0.0)
    return StableBLResult(
        akm=pad(akm_i), akh=pad(akh_i),
        z_sbl=torch.where(unstable, hpbl, 0.0),
        f_sbl=torch.where(unstable, 1.0, 0.0).to(hpbl.dtype))
