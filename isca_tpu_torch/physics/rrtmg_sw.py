"""RRTMG-SW: correlated-k shortwave radiation on torch tensors.

Port of isca_tpu/physics/rrtmg_sw.py, a re-implementation of the AER
RRTMG-SW column model (rrtmg_sw_setcoef/taumol/reftra/vrtqdr/spcvrt.f90).
Every (column, layer, g-point) is batched: table lookups are one-hot weighted
matmuls, the two-stream is closed-form elementwise math, and the vertical
adding sweeps run level by level.

The broadband flux solve `sw_flux_solve` (delta scaling, two-stream, both
adding sweeps, flux combine and the incident-flux-weighted g-point sum) is a
hand-written CUDA kernel on CUDA tensors (csrc/sw_flux.cu) and its plain
PyTorch version, `sw_flux_solve_reference`, on CPU tensors.

The k-tables are isca_tpu's extracted copy of the reference's own data
(data/rrtmg_sw.npz), held in float32 whatever the run's dtype, as isca_tpu
holds them: arithmetic between table entries alone stays in float32, and
a table meets the run's tensors in the run's dtype.

Layer index convention inside this module: layers on the last (or, for
per-g-point arrays, second-to-last) axis, index 0 = BOTTOM (surface) for
setcoef/taumol; the public `RRTMGSw` takes top-down arrays and flips.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from isca_tpu_torch import resolve_device

DATA = Path(__file__).resolve().parent.parent / "data" / "rrtmg_sw.npz"

NBND = 14
NGPT = 112
NGC = [6, 12, 8, 8, 10, 10, 2, 10, 8, 6, 6, 8, 6, 12]
RRSW_SCON = 1.36822e3        # W/m2 (parrrsw.f90:115)
AMD = 28.9660                # g/mol dry air
AMW = 18.0160                # g/mol water vapor
AVOGAD = 6.02214199e23
GRAV_CGS = 9.8066

# per-band recipe entries (rrtmg_sw_taumol.f90):
#   lo: ('2key', sp1, sp2, strrat) | ('1key', sp) | 'zero'
#   up: same, ('2key5', ...) or 'zero'
#   layreffr, solfr_region ('lower'|'upper'|'laytrop'), sflux interp ('1d'|'lo_js'|'up_js')
#   minor terms handled explicitly in taumol_sw.
BAND_META = {
    16: dict(lo=("2key", "h2o", "ch4", 252.131), up=("1key", "ch4"),
             layreffr=18, solfr="upper", sflux="1d", self_lo=True, for_lo=True,
             for_up=False),
    17: dict(lo=("2key", "h2o", "co2", 0.364641), up=("2key5", "h2o", "co2", 0.364641),
             layreffr=30, solfr="upper", sflux="up_js", self_lo=True, for_lo=True,
             for_up=True),
    18: dict(lo=("2key", "h2o", "ch4", 38.9589), up=("1key", "ch4"),
             layreffr=6, solfr="lower", sflux="lo_js", self_lo=True, for_lo=True,
             for_up=False),
    19: dict(lo=("2key", "h2o", "co2", 5.49281), up=("1key", "co2"),
             layreffr=3, solfr="lower", sflux="lo_js", self_lo=True, for_lo=True,
             for_up=False),
    20: dict(lo=("1key", "h2o"), up=("1key", "h2o"),
             layreffr=3, solfr="lower", sflux="1d", self_lo=True, for_lo=True,
             for_up=True),
    21: dict(lo=("2key", "h2o", "co2", 0.0045321), up=("2key5", "h2o", "co2", 0.0045321),
             layreffr=8, solfr="lower", sflux="lo_js", self_lo=True, for_lo=True,
             for_up=True),
    22: dict(lo=("2key", "h2o", "o2", 0.022708 * 1.6), up=("1key", "o2"),
             layreffr=2, solfr="lower", sflux="lo_js", self_lo=True, for_lo=True,
             for_up=False),
    23: dict(lo=("1key", "h2o"), up="zero",
             layreffr=6, solfr="lower", sflux="1d", self_lo=True, for_lo=True,
             for_up=False),
    24: dict(lo=("2key", "h2o", "o2", 0.124692), up=("1key", "o2"),
             layreffr=1, solfr="lower", sflux="lo_js", self_lo=True, for_lo=True,
             for_up=False),
    25: dict(lo=("1key", "h2o"), up="zero",
             layreffr=2, solfr="lower", sflux="1d", self_lo=False, for_lo=False,
             for_up=False),
    26: dict(lo="zero", up="zero",
             layreffr=0, solfr="laytrop", sflux="1d", self_lo=False,
             for_lo=False, for_up=False),
    27: dict(lo=("1key", "o3"), up=("1key", "o3"),
             layreffr=32, solfr="upper", sflux="1d", self_lo=False,
             for_lo=False, for_up=False),
    28: dict(lo=("2key", "o3", "o2", 6.67029e-7), up=("2key5", "o3", "o2", 6.67029e-7),
             layreffr=58, solfr="upper", sflux="up_js", self_lo=False,
             for_lo=False, for_up=False),
    29: dict(lo=("1key", "h2o"), up=("1key", "co2"),
             layreffr=49, solfr="upper", sflux="1d", self_lo=True, for_lo=True,
             for_up=False),
}


@dataclasses.dataclass(frozen=True)
class RRTMGSwConfig:
    scon: float = 1368.22          # solar constant [W/m2]
    co2vmr: float = 300.0e-6
    ch4vmr: float = 0.0
    n2ovmr: float = 0.0
    o2vmr: float = 0.209488
    cp_air: float = 1004.64
    grav: float = 9.80


class SwFluxes(NamedTuple):
    swdflx: torch.Tensor      # (..., L+1) downward flux, TOP-DOWN half levels
    swuflx: torch.Tensor      # (..., L+1) upward flux
    swdflxc: torch.Tensor     # clear-sky downward
    swuflxc: torch.Tensor     # clear-sky upward
    swhr: torch.Tensor        # (..., L) heating rate [K/s], top-down
    dirdflx: torch.Tensor     # (..., L+1) direct-beam downward


class _Tables:
    """The reduced k-tables on one device, in float32."""

    def __init__(self, device):
        with np.load(DATA) as d:
            self.t = {k: torch.as_tensor(d[k].astype(np.float32)).to(device)
                      for k in d.files}

    def band(self, b, name, default=None):
        return self.t.get(f"b{b}_{name}", default)


def _wsum(pairs, nrow):
    """One-hot weighted scatter: [(idx (...,), w (...,)), ...] -> (..., nrow).

    Out-of-range indices contribute zero rows (the reference clips instead;
    both regions are masked by `tropo` before use, so the values agree where
    they are read)."""
    iota = torch.arange(nrow, device=pairs[0][0].device)
    W = None
    for idx, w in pairs:
        t = torch.where(idx[..., None] == iota, w[..., None], 0.0)
        W = t if W is None else W + t
    return W


def _argmax_first(mask):
    """Index of the first True along the last axis (0 if none)."""
    return torch.argmax(mask.to(torch.uint8), dim=-1)


# ---------------------------------------------------------------------------
# setcoef (rrtmg_sw_setcoef.f90:40-287)
# ---------------------------------------------------------------------------

class SetcoefResult(NamedTuple):
    tropo: torch.Tensor      # bool (..., L): plog > 4.56 (troposphere)
    laytrop: torch.Tensor    # int (...,): number of tropospheric layers
    jp: torch.Tensor         # int 0-based (1..58)-1
    jt: torch.Tensor
    jt1: torch.Tensor
    fac00: torch.Tensor
    fac01: torch.Tensor
    fac10: torch.Tensor
    fac11: torch.Tensor
    col: dict                # colh2o, colco2, colo3, colch4, colo2, colmol
    selffac: torch.Tensor
    selffrac: torch.Tensor
    indself: torch.Tensor    # 0-based
    forfac: torch.Tensor
    forfrac: torch.Tensor
    indfor: torch.Tensor     # 0-based


def _trunc(x):
    """Float -> int toward zero (Fortran INT)."""
    return x.to(torch.int64)


def setcoef_sw(pavel, tavel, wkl, coldry, preflog, tref):
    """pavel [hPa], tavel [K], wkl dict of molecular columns, bottom-up."""
    stpfac = 296.0 / 1013.0
    plog = torch.log(pavel)
    jp = torch.clamp(_trunc(36.0 - 5.0 * (plog + 0.04)), 1, 58) - 1
    jp1 = jp + 1
    fp = 5.0 * (preflog[jp] - plog)

    tref_jp = tref[jp]
    jt = torch.clamp(_trunc(3.0 + (tavel - tref_jp) / 15.0), 1, 4) - 1
    ft = (tavel - tref_jp) / 15.0 - (jt + 1 - 3)
    tref_jp1 = tref[jp1]
    jt1 = torch.clamp(_trunc(3.0 + (tavel - tref_jp1) / 15.0), 1, 4) - 1
    ft1 = (tavel - tref_jp1) / 15.0 - (jt1 + 1 - 3)

    water = wkl["h2o"] / coldry
    scalefac = pavel * stpfac / tavel
    tropo = plog > 4.56
    laytrop = torch.sum(tropo, dim=-1)

    forfac = scalefac / (1.0 + water)
    factor_t = (332.0 - tavel) / 36.0
    indfor_lo = torch.clamp(_trunc(factor_t), 1, 2)
    forfrac_lo = factor_t - indfor_lo
    factor_s = (tavel - 188.0) / 36.0
    indfor = torch.where(tropo, indfor_lo, 3) - 1
    forfrac = torch.where(tropo, forfrac_lo, factor_s - 1.0)

    selffac = torch.where(tropo, water * forfac, 0.0)
    factor2 = (tavel - 188.0) / 7.2
    indself = torch.where(
        tropo, torch.clamp(_trunc(factor2) - 7, 1, 9), 1) - 1
    selffrac = torch.where(tropo, factor2 - (indself + 1 + 7), 0.0)

    col = {}
    for name in ("h2o", "co2", "o3", "n2o", "ch4", "o2"):
        c = 1.0e-20 * wkl[name]
        if name in ("co2", "n2o", "ch4", "o2"):
            c = torch.where(c == 0.0, 1.0e-32 * coldry, c)
        col[name] = c
    col["mol"] = 1.0e-20 * coldry + col["h2o"]

    compfp = 1.0 - fp
    return SetcoefResult(
        tropo=tropo, laytrop=laytrop, jp=jp, jt=jt, jt1=jt1,
        fac00=compfp * (1.0 - ft), fac10=compfp * ft,
        fac01=fp * (1.0 - ft1), fac11=fp * ft1,
        col=col,
        selffac=selffac, selffrac=selffrac, indself=indself,
        forfac=forfac, forfrac=forfrac, indfor=indfor)


# ---------------------------------------------------------------------------
# taumol (rrtmg_sw_taumol.f90)
# ---------------------------------------------------------------------------

ONEMINUS = 1.0 - 1.0e-6


def _species_frac(col1, col2, strrat, nmult):
    """Binary species parameter -> (speccomb, js 0-based, fs)."""
    speccomb = col1 + strrat * col2
    specparm = torch.clamp(col1 / speccomb, max=ONEMINUS)
    specmult = nmult * specparm
    js = _trunc(specmult)                  # 0-based (Fortran js-1)
    fs = specmult - js
    return speccomb, js, fs


# Table interpolation as one-hot weighted matmuls: the (p,T) 4-point
# interpolant is identical across all 14 bands, so its one-hot weight matrix
# over the flattened (jt,jp) row space is built once per taumol call and
# every band's lookup becomes W @ table. Out-of-region rows follow the
# clamped gather they replace; both regions are masked by `tropo` before use.

class _SwWeights(NamedTuple):
    q_lo: torch.Tensor    # (..., L, 65)  lower-region (jt*13+jp) interpolant
    q_up: torch.Tensor    # (..., L, 235) upper-region (jt*47+jp0) interpolant
    selfw: torch.Tensor   # (..., L, 10)  self continuum incl. selffac
    forw3: torch.Tensor   # (..., L, 3)   foreign continuum incl. forfac
    forw4: torch.Tensor   # (..., L, 4)


def _build_sw_weights(c: SetcoefResult) -> _SwWeights:
    jp = torch.clamp(c.jp, max=12)         # clamp like the gathers it replaces
    jpp = torch.clamp(jp + 1, max=12)
    q_lo = _wsum([(c.jt * 13 + jp, c.fac00), ((c.jt + 1) * 13 + jp, c.fac10),
                  (c.jt1 * 13 + jpp, c.fac01),
                  ((c.jt1 + 1) * 13 + jpp, c.fac11)], 65)
    jp0 = torch.clamp(c.jp - 12, 0, 46)    # kb row for ind0
    jp1 = torch.clamp(c.jp - 11, 0, 46)    # kb row for ind1
    q_up = _wsum([(c.jt * 47 + jp0, c.fac00), ((c.jt + 1) * 47 + jp0, c.fac10),
                  (c.jt1 * 47 + jp1, c.fac01),
                  ((c.jt1 + 1) * 47 + jp1, c.fac11)], 235)
    selfw = c.selffac[..., None] * _wsum(
        [(c.indself, 1.0 - c.selffrac), (c.indself + 1, c.selffrac)], 10)

    def forw(n):
        return c.forfac[..., None] * _wsum(
            [(c.indfor, 1.0 - c.forfrac),
             (torch.clamp(c.indfor + 1, max=n - 1), c.forfrac)], n)
    return _SwWeights(q_lo=q_lo, q_up=q_up, selfw=selfw,
                      forw3=forw(3), forw4=forw(4))


def _js_weights(js, fs, nspa):
    """Species-dimension 2-point interpolation weights (..., L, nspa)."""
    return _wsum([(js, 1.0 - fs), (js + 1, fs)], nspa)


def _continuum(W, selfref, forref, with_self):
    """H2O self+foreign continuum terms, x colh2o outside."""
    dt = W.q_lo.dtype
    for_term = (W.forw3 if forref.shape[0] == 3 else W.forw4) @ forref.to(dt)
    if not with_self:
        return for_term
    return W.selfw @ selfref.to(dt) + for_term


def _laysolfr(meta, c):
    """Per-column solar-source layer index (bottom-up, 0-based)."""
    jp_f = c.jp + 1                       # Fortran 1-based
    L = jp_f.shape[-1]
    layreffr = meta["layreffr"]
    laytrop_idx = torch.clamp(c.laytrop - 1, min=0)
    if meta["solfr"] == "laytrop":
        return laytrop_idx
    cross = (jp_f[..., :-1] < layreffr) & (jp_f[..., 1:] >= layreffr)
    any_cross = torch.any(cross, dim=-1)
    first = _argmax_first(cross) + 1
    if meta["solfr"] == "lower":
        return torch.where(any_cross, torch.minimum(first, laytrop_idx),
                           laytrop_idx)
    # upper: default top layer
    return torch.where(any_cross, first, L - 1)


def taumol_sw(c: SetcoefResult, tables: _Tables):
    """Returns taug, taur (..., L, 112) bottom-up and sfluxzen (..., 112)."""
    col = c.col
    W = _build_sw_weights(c)
    taugs, taurs, sfluxes = [], [], []
    for b in range(16, 30):
        meta = BAND_META[b]
        ka = tables.band(b, "ka")
        kb = tables.band(b, "kb")
        selfref = tables.band(b, "selfref")
        forref = tables.band(b, "forref")
        sfluxref = tables.band(b, "sfluxref")
        rayl = tables.band(b, "rayl")
        ng = NGC[b - 16]
        h2o = col["h2o"]
        dtype = h2o.dtype
        shape_g = h2o.shape + (ng,)

        js_lo = fs_lo = js_up = fs_up = wj_lo = None
        # ---- lower (troposphere) optical depth ----
        if meta["lo"] == "zero":
            taug_lo = h2o.new_zeros(shape_g)
        elif meta["lo"][0] == "2key":
            _, sp1, sp2, strrat = meta["lo"]
            speccomb, js_lo, fs_lo = _species_frac(col[sp1], col[sp2], strrat, 8.0)
            wj_lo = _js_weights(js_lo, fs_lo, 9)
            tab = ka.reshape(9, 65, -1).to(dtype)
            taug_lo = speccomb[..., None] * torch.einsum(
                "...q,...j,jqg->...g", W.q_lo, wj_lo, tab)
        else:  # 1key
            sp = meta["lo"][1]
            base = W.q_lo @ ka.reshape(65, -1).to(dtype)
            if b == 23:
                base = 1.029 * base       # givfac (taumol23)
            taug_lo = col[sp][..., None] * base

        if meta["self_lo"] or meta["for_lo"]:
            cont = _continuum(W, selfref, forref, meta["self_lo"])
            taug_lo = taug_lo + h2o[..., None] * cont

        # band-specific minor absorbers, lower
        if b == 20:
            taug_lo = taug_lo + col["ch4"][..., None] * tables.band(20, "absch4")
        if b == 22:
            o2cont = 4.35e-4 * col["o2"] / 700.0
            taug_lo = taug_lo + o2cont[..., None]
        if b == 24:
            taug_lo = taug_lo + col["o3"][..., None] * tables.band(24, "abso3a")
        if b == 25:
            taug_lo = taug_lo + col["o3"][..., None] * tables.band(25, "abso3a")
        if b == 29:
            taug_lo = taug_lo + col["co2"][..., None] * tables.band(29, "absco2")

        # ---- upper (stratosphere) optical depth ----
        if meta["up"] == "zero":
            taug_up = h2o.new_zeros(shape_g)
        elif meta["up"][0] == "2key5":
            _, sp1, sp2, strrat = meta["up"]
            speccomb, js_up, fs_up = _species_frac(col[sp1], col[sp2], strrat, 4.0)
            wj_up = _js_weights(js_up, fs_up, 5)
            tab = kb.reshape(5, 235, -1).to(dtype)
            taug_up = speccomb[..., None] * torch.einsum(
                "...q,...j,jqg->...g", W.q_up, wj_up, tab)
        else:
            sp = meta["up"][1]
            base = W.q_up @ kb.reshape(235, -1).to(dtype)
            if b == 22:
                base = 1.6 * base         # o2adj
            taug_up = col[sp][..., None] * base

        if meta["for_up"]:
            for_term = _continuum(W, selfref, forref, with_self=False)
            taug_up = taug_up + h2o[..., None] * for_term
        if b == 22:
            taug_up = taug_up + (4.35e-4 * col["o2"] / 700.0)[..., None]
        if b == 24:
            taug_up = taug_up + col["o3"][..., None] * tables.band(24, "abso3b")
        if b == 25:
            taug_up = col["o3"][..., None] * tables.band(25, "abso3b")
        if b == 29:
            taug_up = taug_up + h2o[..., None] * tables.band(29, "absh2o")
        if b == 20:
            taug_up = taug_up + col["ch4"][..., None] * tables.band(20, "absch4")

        taug = torch.where(c.tropo[..., None], taug_lo, taug_up)

        # ---- Rayleigh ----
        if b == 24:
            ra = wj_lo @ tables.band(24, "rayla").T.to(dtype)
            taur = col["mol"][..., None] * torch.where(
                c.tropo[..., None], ra, tables.band(24, "raylb"))
        elif rayl.ndim == 0:
            taur = col["mol"][..., None] * rayl * h2o.new_ones((ng,))
        else:
            taur = col["mol"][..., None] * rayl

        # ---- solar source at laysolfr ----
        lsf = _laysolfr(meta, c)[..., None]
        take_s = lambda a: torch.gather(a, -1, lsf)[..., 0]
        if meta["sflux"] == "1d":
            sf = sfluxref.expand(h2o.shape[:-1] + (ng,))
            if b == 27:
                sf = sf * (50.15 / 48.37)     # scalekur
        else:
            if meta["sflux"] == "lo_js":
                js_l, fs_l = take_s(js_lo), take_s(fs_lo)
            else:
                js_l, fs_l = take_s(js_up), take_s(fs_up)
            sfT = sfluxref.T               # (njs, ng)
            js_l = torch.clamp(js_l, max=sfT.shape[0] - 2)
            sf = sfT[js_l] + fs_l[..., None] * (sfT[js_l + 1] - sfT[js_l])
        taugs.append(taug)
        taurs.append(taur)
        sfluxes.append(sf)
    return (torch.cat(taugs, dim=-1), torch.cat(taurs, dim=-1),
            torch.cat(sfluxes, dim=-1))


# ---------------------------------------------------------------------------
# two-stream (rrtmg_sw_reftra.f90, kmodts=2 PIFM)
# ---------------------------------------------------------------------------

def reftra_sw(tau, w0, g, mu0):
    """Returns (ref, refd, tra, trad) for direct/diffuse beams."""
    eps = 1e-8
    w0 = torch.clamp(w0, 0.0, 1.0)
    g = torch.clamp(g, 0.0, 1.0 - 1e-6)
    gamma1 = (8.0 - w0 * (5.0 + 3.0 * g)) * 0.25
    gamma2 = 3.0 * (w0 * (1.0 - g)) * 0.25
    gamma3 = (2.0 - 3.0 * g * mu0) * 0.25
    gamma4 = 1.0 - gamma3

    gr = g / (1.0 - g)
    zwo = w0 / (1.0 - (1.0 - w0) * (gr * gr))
    conservative = zwo >= 0.9999995

    # --- conservative branch ---
    za = gamma1 * mu0
    za1 = za - gamma3
    zgt = gamma1 * tau
    ze1c = torch.clamp(tau / mu0, max=500.0)
    ze2c = torch.exp(-ze1c)
    ref_c = torch.clamp((zgt - za1 * (1.0 - ze2c)) / (1.0 + zgt), 0.0, 1.0)
    tra_c = 1.0 - ref_c
    refd_c = zgt / (1.0 + zgt)
    trad_c = 1.0 - refd_c

    # --- non-conservative branch ---
    zrk = torch.sqrt(torch.clamp(gamma1 * gamma1 - gamma2 * gamma2, min=1e-12))
    zrp = zrk * mu0
    zrp1, zrm1 = 1.0 + zrp, 1.0 - zrp
    zrk2 = 2.0 * zrk
    zrpp_raw = 1.0 - zrp * zrp
    # secular singularity mu0 ~ 1/k (reference relies on table rounding)
    zrpp = torch.where(torch.abs(zrpp_raw) < 1e-12,
                       torch.sign(zrpp_raw + 1e-30) * 1e-12, zrpp_raw)
    zrkg = zrk + gamma1
    za1n = gamma1 * gamma4 + gamma2 * gamma3
    za2n = gamma1 * gamma3 + gamma2 * gamma4
    zr1 = zrm1 * (za2n + zrk * gamma3)
    zr2 = zrp1 * (za2n - zrk * gamma3)
    zr3 = zrk2 * (gamma3 - za2n * mu0)
    zr4 = zrpp * zrkg
    zr5 = zrpp * (zrk - gamma1)
    zt1 = zrp1 * (za1n + zrk * gamma4)
    zt2 = zrm1 * (za1n - zrk * gamma4)
    zt3 = zrk2 * (gamma4 + za1n * mu0)
    zbeta = (gamma1 - zrk) / zrkg

    # exponents capped at 40 so the zr*zep products stay finite in float32
    ze1 = torch.clamp(zrk * tau, max=40.0)
    ze2 = torch.clamp(tau / mu0, max=40.0)
    zem1 = torch.exp(-ze1)
    zep1 = torch.exp(ze1)
    zem2 = torch.exp(-ze2)
    zep2 = torch.exp(ze2)
    zden = zr4 * zep1 + zr5 * zem1
    small_den = torch.abs(zden) <= eps
    safe_den = torch.where(small_den, 1.0, zden)
    ref_n = torch.where(
        small_den, eps, w0 * (zr1 * zep1 - zr2 * zem1 - zr3 * zem2) / safe_den)
    tra_n = torch.where(
        small_den, zem2,
        zem2 - zem2 * w0 * (zt1 * zep1 - zt2 * zem1 - zt3 * zep2) / safe_den)
    zemm = zem1 * zem1
    zdend = 1.0 / ((1.0 - zbeta * zemm) * zrkg)
    refd_n = gamma2 * (1.0 - zemm) * zdend
    trad_n = zrk2 * zem1 * zdend

    ref = torch.where(conservative, ref_c, ref_n)
    tra = torch.where(conservative, tra_c, tra_n)
    refd = torch.where(conservative, refd_c, refd_n)
    trad = torch.where(conservative, trad_c, trad_n)
    return ref, refd, tra, trad


# ---------------------------------------------------------------------------
# vertical adding (rrtmg_sw_vrtqdr.f90) — top-down, loops over layers
# ---------------------------------------------------------------------------

def vrtqdr_sw(ref, refd, tra, trad, dbt, tdbt, alb_dir, alb_dif):
    """Layer arrays (..., L, g) top-down; tdbt (..., L+1, g); albedos
    (..., g).  Returns fd, fu at (..., L+1, g) levels."""
    L = ref.shape[-2]
    lay = lambda a, l: a[..., l, :]

    # up sweep: rup/rupd from the surface upward
    rup = [None] * L + [alb_dir]
    rupd = [None] * L + [alb_dif]
    for l in range(L - 1, -1, -1):
        rf, rfd, tr, trd, db = (lay(a, l) for a in (ref, refd, tra, trad, dbt))
        reflect = 1.0 / (1.0 - rupd[l + 1] * rfd)
        rup[l] = rf + (trd * ((tr - db) * rupd[l + 1] + db * rup[l + 1])) * reflect
        rupd[l] = rfd + trd * trd * rupd[l + 1] * reflect

    # down sweep: tdn/rdnd from the top downward
    tdn = [torch.ones_like(rup[0])]
    rdnd = [torch.zeros_like(rup[0])]
    for l in range(L):
        rf, rfd, tr, trd, tdb = (lay(a, l) for a in (ref, refd, tra, trad, tdbt))
        reflect = 1.0 / (1.0 - rfd * rdnd[l])
        tdn.append(tdb * tr + (trd * ((tdn[l] - tdb) + tdb * rf * rdnd[l])) * reflect)
        rdnd.append(rfd + trd * trd * rdnd[l] * reflect)

    stack = lambda xs: torch.stack(torch.broadcast_tensors(*xs), dim=-2)
    rup, rupd, tdn, rdnd = stack(rup), stack(rupd), stack(tdn), stack(rdnd)
    reflect = 1.0 / (1.0 - rdnd * rupd)
    fu = (tdbt * rup + (tdn - tdbt) * rupd) * reflect
    fd = tdbt + (tdn - tdbt + tdbt * rup * rdnd) * reflect
    return fd, fu


# ---------------------------------------------------------------------------
# full column solver
# ---------------------------------------------------------------------------

def _delta_scale(tau, w0, g):
    f = g * g
    wf = w0 * f
    tau_s = (1.0 - wf) * tau
    w0_s = (w0 - wf) / (1.0 - wf)
    g_s = (g - f) / (1.0 - f)
    return tau_s, w0_s, g_s


def _layer_properties(tau, w0, g, mu0):
    """Delta-scale + reftra + direct-beam transmission of a layer set."""
    tau, w0, g = _delta_scale(tau, w0, g)
    ref, refd, tra, trad = reftra_sw(tau, w0, g, mu0)
    dbt = torch.exp(-torch.clamp(tau / mu0, max=500.0))
    return ref, refd, tra, trad, dbt


def sw_solve(tau, w0, g, mu0, alb_dir_g, alb_dif_g, cloud=None):
    """Two-stream solve: delta-scale + reftra_sw + vertical adding.
    tau/w0/g: (..., L, G) PRE-delta-scaling; mu0 (..., 1, 1); albedos
    (..., G).  cloud = (tau_o, w0_o, g_o, cf) blends a total-sky property set
    by cloud fraction before the sweeps (spcvrt icpr=0).
    Returns (fd, fu, tdbt) at (..., L+1, G).
    """
    props = _layer_properties(tau, w0, g, mu0)
    if cloud is not None:
        tau_o, w0_o, g_o, cf = cloud
        props_o = _layer_properties(tau_o, w0_o, g_o, mu0)
        props = tuple((1.0 - cf) * p + cf * p_o for p, p_o in zip(props, props_o))
    ref, refd, tra, trad, dbt = props
    tdbt = torch.cumprod(
        torch.cat([torch.ones_like(dbt[..., :1, :]), dbt], dim=-2), dim=-2)
    fd, fu = vrtqdr_sw(ref, refd, tra, trad, dbt, tdbt, alb_dir_g, alb_dif_g)
    return fd, fu, tdbt


def sw_flux_solve_reference(tau, w0, g, mu0, alb_dir_g, alb_dif_g, zincflx,
                            cloud=None):
    """Plain PyTorch version of the fused flux solve: sw_solve + the
    incident-flux-weighted g-point sum.  Returns (swd, swu, dird), each
    (..., L+1) = sum_g zincflx * {fd, fu, tdbt}."""
    fd, fu, tdbt = sw_solve(tau, w0, g, mu0, alb_dir_g, alb_dif_g, cloud=cloud)
    wsum = lambda f: torch.sum(zincflx[..., None, :] * f, dim=-1)
    return wsum(fd), wsum(fu), wsum(tdbt)


# Limits of csrc/sw_flux.cu (kMaxL, kMaxG, kMaxSmem there).
SW_FLUX_MAX_L = 64
SW_FLUX_MAX_G = 128
SW_FLUX_MAX_SMEM = 232448       # bytes of shared memory a block may use on sm_90
SW_FLUX_THREADS = 256
# Fewest g-chunks for float32 at L <= 32 (the main path's T42L25 shape):
# more resident blocks hide the serial sweeps better (csrc/sw_flux.cu).
SW_FLUX_SHALLOW_F32_CHUNKS = 2


class SwFluxPlan(NamedTuple):
    """Launch plan of csrc/sw_flux.cu: threads per block (one block per
    column), g-chunks per column, and dynamic shared memory per block."""
    threads: int
    chunks: int
    smem_bytes: int


def sw_flux_smem_bytes(L, gc, itemsize):
    """Shared memory of one block for chunks of gc g-points, as smem_bytes in
    csrc/sw_flux.cu: layer properties [5][L][gc], rup and rupd
    [2][L+1][gc], per-warp partial g-sums [L+1][3][ceil(gc/32)]."""
    return itemsize * ((5 * L + 2 * (L + 1)) * gc + 3 * (L + 1) * -(-gc // 32))


def sw_flux_plan(L, G, itemsize) -> SwFluxPlan:
    """The fewest g-chunks (at least SW_FLUX_SHALLOW_F32_CHUNKS for float32
    at L <= 32) whose shared memory fits one block; each chunk but the last
    holds ceil(G / chunks) g-points and none is empty."""
    if not (1 <= L <= SW_FLUX_MAX_L and 1 <= G <= SW_FLUX_MAX_G):
        raise ValueError(f"sw_flux_solve: L={L}, G={G} outside the kernel's "
                         f"limits L<={SW_FLUX_MAX_L}, G<={SW_FLUX_MAX_G}")
    chunks = SW_FLUX_SHALLOW_F32_CHUNKS if itemsize == 4 and L <= 32 else 1
    while sw_flux_smem_bytes(L, -(-G // chunks), itemsize) > SW_FLUX_MAX_SMEM:
        chunks += 1
    gc = -(-G // chunks)
    return SwFluxPlan(SW_FLUX_THREADS, -(-G // gc), sw_flux_smem_bytes(L, gc, itemsize))


@functools.cache
def _sw_flux_lib():
    from isca_tpu_torch import _build

    lib = _build.load("sw_flux")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.sw_flux_f32, lib.sw_flux_f64):
        fn.argtypes = [ptr] * 14 + [i32] * 6 + [ptr]
        fn.restype = i32
    lib.sw_flux_blocks_per_sm.argtypes = [i32] * 7 + [ctypes.POINTER(i32)]
    lib.sw_flux_blocks_per_sm.restype = i32
    lib.sw_flux_error_string.argtypes = [i32]
    lib.sw_flux_error_string.restype = ctypes.c_char_p
    return lib


def _sw_flux_check(lib, rc, what):
    if rc != 0:
        raise RuntimeError(f"sw_flux {what} failed: CUDA error {rc} "
                           f"({lib.sw_flux_error_string(rc).decode()})")


def sw_flux_blocks_per_sm(L, G, dtype, cloudy) -> int:
    """Blocks of the kernel resident on one SM of the current CUDA device
    under sw_flux_plan's plan, as the CUDA occupancy calculator gives them."""
    plan = sw_flux_plan(L, G, dtype.itemsize)
    lib = _sw_flux_lib()
    blocks = ctypes.c_int(0)
    _sw_flux_check(lib, lib.sw_flux_blocks_per_sm(
        int(dtype.itemsize == 8), int(cloudy), L, G, *plan, ctypes.byref(blocks)),
        "occupancy query")
    return blocks.value


def sw_flux_solve(tau, w0, g, mu0, alb_dir_g, alb_dif_g, zincflx, cloud=None):
    """Broadband two-stream fluxes: sw_solve + incident-flux-weighted
    g-point reduction, as one CUDA kernel (csrc/sw_flux.cu) on CUDA tensors.

    tau/w0/g (and the cloud set tau_o, w0_o, g_o, cf): (..., L, G);
    mu0 (..., 1, 1); alb_dir_g, alb_dif_g, zincflx (..., G).
    Returns (swd, swu, dird), each (..., L+1) = sum_g zincflx * {fd,fu,tdbt}.

    CPU tensors go to `sw_flux_solve_reference`. On CUDA every input must be
    contiguous, of the full shape above (no broadcasting), float32 or
    float64 and on one device; anything else raises. Each kernel launch adds
    one to `sw_flux_solve.launches`.
    """
    if tau.device.type == "cpu":
        return sw_flux_solve_reference(tau, w0, g, mu0, alb_dir_g, alb_dif_g,
                                       zincflx, cloud=cloud)
    if tau.device.type != "cuda":
        raise ValueError(f"sw_flux_solve: unsupported device {tau.device}")
    if tau.dim() < 2:
        raise ValueError(f"sw_flux_solve: tau must be (..., L, G), got {tuple(tau.shape)}")
    batch, (L, G) = tuple(tau.shape[:-2]), tau.shape[-2:]
    plan = sw_flux_plan(L, G, tau.element_size())
    B = math.prod(batch)
    if B == 0:
        raise ValueError("sw_flux_solve: empty batch")
    if tau.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"sw_flux_solve: unsupported dtype {tau.dtype}")
    layer = batch + (L, G)
    args = {"tau": (tau, layer), "w0": (w0, layer), "g": (g, layer)}
    if cloud is not None:
        for name, a in zip(("tau_o", "w0_o", "g_o", "cf"), cloud):
            args[name] = (a, layer)
    args.update(mu0=(mu0, batch + (1, 1)), alb_dir_g=(alb_dir_g, batch + (G,)),
                alb_dif_g=(alb_dif_g, batch + (G,)), zincflx=(zincflx, batch + (G,)))
    for name, (a, shape) in args.items():
        if a.device != tau.device or a.dtype != tau.dtype:
            raise ValueError(f"sw_flux_solve: {name} is {a.dtype} on {a.device}, "
                             f"expected {tau.dtype} on {tau.device}")
        if tuple(a.shape) != shape:
            raise ValueError(f"sw_flux_solve: {name} has shape {tuple(a.shape)}, "
                             f"expected {shape}")
        if not a.is_contiguous():
            raise ValueError(f"sw_flux_solve: {name} is not contiguous")

    lib = _sw_flux_lib()
    fn = lib.sw_flux_f32 if tau.dtype == torch.float32 else lib.sw_flux_f64
    swd, swu, dird = (torch.empty(batch + (L + 1,), dtype=tau.dtype,
                                  device=tau.device) for _ in range(3))
    cloud_ptrs = ([a.data_ptr() for a in cloud] if cloud is not None
                  else [None] * 4)
    with torch.cuda.device(tau.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(tau.data_ptr(), w0.data_ptr(), g.data_ptr(), *cloud_ptrs,
                mu0.data_ptr(), alb_dir_g.data_ptr(), alb_dif_g.data_ptr(),
                zincflx.data_ptr(), swd.data_ptr(), swu.data_ptr(),
                dird.data_ptr(), B, L, G, *plan, stream)
    _sw_flux_check(lib, rc, "kernel launch")
    sw_flux_solve.launches += 1
    return swd, swu, dird


sw_flux_solve.launches = 0


class RRTMGSw:
    """Shortwave radiative transfer driver (spcvrt_sw equivalent).

    All inputs level-LAST, TOP-DOWN (framework convention); internals flip to
    the reference's bottom-up layer order for setcoef/taumol. The k-tables
    live on `device`; the inputs' dtype sets the run's precision.
    """

    def __init__(self, config: RRTMGSwConfig = RRTMGSwConfig(), device=None):
        self.config = config
        self.device = resolve_device(device)
        self.tables = _Tables(self.device)
        # band index per g-point for albedo/cloud expansion
        self.band_of_g = torch.as_tensor(
            np.repeat(np.arange(NBND), NGC), device=self.device)

    def __call__(self, p_half, p_full, t_full, q, o3, coszen,
                 alb_dir, alb_dif, cldfrac=None, taucld=None, ssacld=None,
                 asmcld=None, co2vmr=None) -> SwFluxes:
        """p in Pa (..., L+1)/(..., L); q specific humidity [kg/kg];
        o3 mass mixing ratio; coszen (...); albedos (...) broadband.
        Cloud optical properties per band (..., L, 14) if given, top-down.
        """
        cfg = self.config
        flip = lambda a: torch.flip(a, (-1,))
        # bottom-up layers
        pavel = flip(p_full) * 1e-2                 # hPa
        tavel = flip(t_full)
        pz = flip(p_half) * 1e-2                    # level pressures, hPa
        h2ovmr = flip(q / (1.0 - q)) * (AMD / AMW)
        o3vmr = flip(o3) * (AMD / 47.9982)
        co2 = cfg.co2vmr if co2vmr is None else co2vmr

        amm = (1.0 - h2ovmr) * AMD + h2ovmr * AMW
        coldry = ((pz[..., :-1] - pz[..., 1:]) * 1.0e3 * AVOGAD
                  / (1.0e2 * GRAV_CGS * amm * (1.0 + h2ovmr)))
        wkl = {"h2o": h2ovmr * coldry,
               "co2": co2 * coldry * torch.ones_like(coldry),
               "o3": o3vmr * coldry,
               "n2o": cfg.n2ovmr * coldry,
               "ch4": cfg.ch4vmr * coldry,
               "o2": cfg.o2vmr * coldry}

        t = self.tables.t
        c = setcoef_sw(pavel, tavel, wkl, coldry, t["preflog"], t["tref"])
        taug, taur, sfluxzen = taumol_sw(c, self.tables)

        # flip to top-down for the solver
        taug = torch.flip(taug, (-2,))
        taur = torch.flip(taur, (-2,))

        mu0 = torch.clamp(coszen, min=1e-4)[..., None, None]
        solvar = cfg.scon / RRSW_SCON
        zincflx = solvar * sfluxzen * torch.clamp(coszen, min=0.0)[..., None]

        # clear-sky combined properties per g-point (aerosol-free),
        # PRE-delta-scaling (the solve delta-scales internally)
        ztauc = taur + taug
        zomcc = taur / torch.clamp(ztauc, min=1e-20)
        zgcc = torch.zeros_like(ztauc)

        gshape = ztauc.shape[:-2] + (NGPT,)
        alb_dir_g = alb_dir[..., None].expand(gshape).contiguous()
        alb_dif_g = alb_dif[..., None].expand(gshape).contiguous()

        swdflxc, swuflxc, dird_c = sw_flux_solve(
            ztauc, zomcc, zgcc, mu0, alb_dir_g, alb_dif_g, zincflx)

        if cldfrac is not None:
            # total-sky: combine cloud properties at original (pre-delta)
            # values then delta-scale (spcvrt icpr=0 path), and blend the
            # clear/cloudy two-streams by cloud fraction per layer.
            tc = taucld[..., self.band_of_g]
            wc = ssacld[..., self.band_of_g]
            gc = asmcld[..., self.band_of_g]
            ztauo = taur + taug + tc
            zomco = taur + tc * wc
            zgco = (tc * wc * gc) / torch.clamp(zomco, min=1e-20)
            zomco = zomco / torch.clamp(ztauo, min=1e-20)
            # per-layer cloud fraction, or per-g-point binary (McICA
            # subcolumns) — the fraction blend covers both
            cf = cldfrac if cldfrac.dim() == ztauc.dim() else cldfrac[..., None]
            cf = cf.expand(ztauc.shape).contiguous()
            swdflx, swuflx, dirdflx = sw_flux_solve(
                ztauc, zomcc, zgcc, mu0, alb_dir_g, alb_dif_g, zincflx,
                cloud=(ztauo, zomco, zgco, cf))
        else:
            swdflx, swuflx, dirdflx = swdflxc, swuflxc, dird_c

        # heating rate from net-flux convergence [K/s]: layer absorbs
        # Fnet(top) - Fnet(bottom), both half-level arrays top-down
        fnet = swdflx - swuflx
        dp = p_half[..., 1:] - p_half[..., :-1]
        swhr = (cfg.grav / cfg.cp_air) * (fnet[..., :-1] - fnet[..., 1:]) / dp
        return SwFluxes(swdflx=swdflx, swuflx=swuflx, swdflxc=swdflxc,
                        swuflxc=swuflxc, swhr=swhr, dirdflx=dirdflx)


# ---------------------------------------------------------------------------
# cloud optical properties (rrtmg_sw_cldprop.f90 cldprop_sw, inflag=2)
# ---------------------------------------------------------------------------

CLD_DATA = Path(__file__).resolve().parent.parent / "data" / "rrtmg_sw_cld.npz"


@functools.lru_cache(maxsize=None)
def _cld_tables(device: torch.device):
    """isca_tpu's cloud-optics tables on `device`, in float32 whatever the
    run's dtype, as isca_tpu rounds them (`_CldTables`)."""
    with np.load(CLD_DATA) as d:
        return {k: torch.as_tensor(d[k].astype(np.float32)).to(device) for k in d.files}


def cldprop_sw(cldfrac, clwp, ciwp, rel, rei, iceflag=2, liqflag=1):
    """Per-band cloud optical properties from water paths and particle sizes.

    Port of isca_tpu's cldprop_sw (rrtmg_sw_cldprop.f90:40-226), inflag=2:
      - liquid (liqflag=1): Hu & Stamnes (1993) tables extliq1/ssaliq1/
        asyliq1 indexed by effective radius 2.5-60 um;
      - ice iceflag=2: Streamer v3.0 tables (extice2...) for re 5-131 um;
        iceflag=3: Fu (1996) generalized effective size tables (extice3...).

    Inputs (..., L): cloud fraction, in-cloud liquid/ice water paths [g/m2],
    liquid/ice effective radii [micron]. Returns UNSCALED (tau, ssa, g) per
    band (..., L, 14) for the solver's combine-then-delta-scale cloudy path.
    """
    t = _cld_tables(cldfrac.device)
    eps = 1e-6

    # liquid: index = int(radliq - 1.5), clamped to 1..57 (1-based)
    radliq = torch.clamp(rel, 2.5, 60.0)
    idxl = torch.clamp(_trunc(radliq - 1.5), 1, 57) - 1    # 0-based
    fintl = radliq - 1.5 - (idxl + 1)

    def liq(tab):
        a = tab[idxl]                     # (..., L, 14)
        b = tab[idxl + 1]
        return a + fintl[..., None] * (b - a)
    extliq = liq(t["extliq1"])
    ssaliq = torch.clamp(liq(t["ssaliq1"]), max=1.0)
    gliq = liq(t["asyliq1"])

    if iceflag not in (2, 3):
        raise ValueError(f"iceflag {iceflag} not supported (2 or 3)")
    # iceflag 2: Streamer tables, re 5-131 um (43 rows); 3: Fu, 5-140 um (46)
    rmax, nrow = (131.0, 43) if iceflag == 2 else (140.0, 46)
    radice = torch.clamp(rei, 5.0, rmax)
    factor = (radice - 2.0) / 3.0
    idxi = torch.clamp(_trunc(factor), max=nrow - 1) - 1
    idxi = torch.clamp(idxi, 0, nrow - 2)
    finti = factor - (idxi + 1)

    def ice(tab):
        return tab[idxi] + finti[..., None] * (tab[idxi + 1] - tab[idxi])
    extice = ice(t[f"extice{iceflag}"])
    ssaice = torch.clamp(ice(t[f"ssaice{iceflag}"]), max=1.0)
    gice = ice(t[f"asyice{iceflag}"])

    has_liq = (clwp > 0.0)[..., None]
    has_ice = (ciwp > 0.0)[..., None]
    tauliq = torch.where(has_liq, clwp[..., None] * extliq, 0.0)
    tauice = torch.where(has_ice, ciwp[..., None] * extice, 0.0)
    tauc = tauliq + tauice
    scatliq = torch.where(has_liq, ssaliq * tauliq, 0.0)
    scatice = torch.where(has_ice, ssaice * tauice, 0.0)
    scat = scatliq + scatice
    ssac = scat / torch.clamp(tauc, min=eps)
    asmc = (scatliq * gliq + scatice * gice) / torch.clamp(scat, min=eps)

    cloudy = (cldfrac > 1e-12)[..., None]
    tauc = torch.where(cloudy, tauc, 0.0)
    ssac = torch.where(cloudy, ssac, 1.0)
    asmc = torch.where(cloudy, asmc, 0.0)
    return tauc, ssac, asmc
