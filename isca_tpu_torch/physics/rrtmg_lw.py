"""RRTMG-LW: correlated-k longwave radiation on torch tensors.

Port of isca_tpu/physics/rrtmg_lw.py, a re-implementation of the AER
RRTMG-LW column model vendored in the reference
(src/atmos_param/rrtm_radiation/rrtmg_lw/gcm_model/src: rrtmg_lw_setcoef,
_taumol, _rtrn, _cldprop and the inatm column amounts of
rrtmg_lw_rad.nomcica.f90, and the McICA subcolumn path of rrtmg_lw_rad.f90
with `mcica_key`). Every (column, layer, g-point) is batched: table
lookups are one-hot weighted matmuls whose weight matrices are built once per
call and shared by all 16 bands, the troposphere/stratosphere split is a
per-layer mask over both table regions, and the downward and upward
radiative-transfer recursions run level by level over columns x 140
g-points. As in isca_tpu, exact `exp` and the exact linear-in-tau transition
function replace the reference's Pade lookup tables.

The k-distribution tables are isca_tpu's (data/rrtmg_lw_kg.npz, a byte copy,
synthetic version 4: shape-correct and calibrated, not AER's; every
construction warns), the static tables data/rrtmg_lw_static.npz. Both are
held on the run's device in the run's dtype, as isca_tpu converts them with
`jnp.asarray(table, dtype)`.

Layer convention inside this module: axis -2 (or -1 for per-layer fields)
over layers, index 0 = BOTTOM (surface), as the reference's lay=1..nlayers;
`RRTMGLw` takes top-down arrays and flips.
"""

from __future__ import annotations

import dataclasses
import functools
import warnings
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from isca_tpu_torch import resolve_device
from isca_tpu_torch.physics.mcica import mcica_subcol

DATA = Path(__file__).resolve().parent.parent / "data"
STATIC_NPZ = DATA / "rrtmg_lw_static.npz"
KG_NPZ = DATA / "rrtmg_lw_kg.npz"

NBND = 16
NGPT = 140
NGC = [10, 12, 16, 14, 16, 8, 12, 8, 12, 6, 8, 8, 4, 2, 2, 2]
AMD = 28.9660
AMW = 18.0160
AVOGAD = 6.02214199e23
GRAV_CGS = 9.8066          # m s-2 (lwdatinit, rrtmg_lw_init.f90:232)
FLUXFAC = np.pi * 2.0e4    # radiance -> flux (rrtmg_lw_rad.nomcica.f90:421)
WTDIFF = 0.5
ONEMINUS = 1.0 - 1.0e-6

# diffusivity-angle coefficients (rrtmg_lw_rtrn.f90:252-266)
SECDIFF_A0 = np.array([1.66, 1.55, 1.58, 1.66, 1.54, 1.454, 1.89, 1.33,
                       1.668, 1.66, 1.66, 1.66, 1.66, 1.66, 1.66, 1.66])
SECDIFF_A1 = np.array([0.00, 0.25, 0.22, 0.00, 0.13, 0.446, -0.10, 0.40,
                       -0.006, 0.00, 0.00, 0.00, 0.00, 0.00, 0.00, 0.00])
SECDIFF_A2 = np.array([0.00, -12.0, -11.7, 0.00, -0.72, -0.243, 0.19, -0.062,
                       0.414, 0.00, 0.00, 0.00, 0.00, 0.00, 0.00, 0.00])
SECDIFF_FIXED = np.array([b + 1 in (1, 4) or b + 1 >= 10 for b in range(16)])

# per-g fudge factors of the upper-atmosphere bands 4 and 7 (taugb4, taugb7)
FUDGE4 = np.ones(NGC[3])
FUDGE4[7:14] = [0.92, 0.88, 1.07, 1.1, 0.99, 0.88, 0.943]
FUDGE7 = np.ones(NGC[6])
FUDGE7[5:11] = [0.92, 0.88, 1.07, 1.1, 0.99, 0.855]


def kg_available() -> bool:
    return KG_NPZ.exists()


class _Static:
    """The static tables (lwatmref, lwavplank, cloud optics) as numpy."""
    _inst = None

    def __new__(cls):
        if cls._inst is None:
            cls._inst = super().__new__(cls)
            with np.load(STATIC_NPZ) as d:
                cls._inst.d = {k: np.asarray(d[k]) for k in d.files}
        return cls._inst

    def __getitem__(self, k):
        return self.d[k]


@functools.lru_cache(maxsize=None)
def _consts(device: torch.device, dtype: torch.dtype) -> dict:
    """The static tables and this module's constant vectors on one device in
    one dtype, made once: a step copies nothing from the host."""
    on = lambda a: torch.as_tensor(np.asarray(a, np.float64)).to(device=device, dtype=dtype)
    out = {k: on(v) for k, v in _Static().d.items() if v.dtype.kind == "f"}
    out.update(secdiff_a0=on(SECDIFF_A0), secdiff_a1=on(SECDIFF_A1),
               secdiff_a2=on(SECDIFF_A2), fudge4=on(FUDGE4), fudge7=on(FUDGE7),
               secdiff_fixed=torch.as_tensor(SECDIFF_FIXED).to(device))
    return out


def _on(a, like: torch.Tensor) -> torch.Tensor:
    """A table as a tensor on `like`'s device in its dtype (no copy when it
    is one already)."""
    if torch.is_tensor(a):
        return a.to(device=like.device, dtype=like.dtype)
    return torch.as_tensor(np.asarray(a)).to(device=like.device, dtype=like.dtype)


def _trunc(x):
    """Float -> int toward zero (Fortran INT, jnp.asarray(x, int32))."""
    return x.to(torch.int64)


class LwSetcoef(NamedTuple):
    tropo: torch.Tensor          # bool (..., L)
    jp: torch.Tensor             # 0-based (1..58)-1
    jt: torch.Tensor
    jt1: torch.Tensor
    fac00: torch.Tensor
    fac01: torch.Tensor
    fac10: torch.Tensor
    fac11: torch.Tensor
    col: dict                    # colh2o..colbrd (scaled 1e-20)
    coldry: torch.Tensor
    selffac: torch.Tensor
    selffrac: torch.Tensor
    indself: torch.Tensor
    forfac: torch.Tensor
    forfrac: torch.Tensor
    indfor: torch.Tensor
    indminor: torch.Tensor
    minorfrac: torch.Tensor
    scaleminor: torch.Tensor
    scaleminorn2: torch.Tensor
    rat: dict                    # rat_h2oco2 .. rat_o3co2 and _1 variants
    planklay: torch.Tensor       # (..., L, 16)
    planklev: torch.Tensor       # (..., L+1, 16), index 0 = surface level
    plankbnd: torch.Tensor       # (..., 16) — semiss applied
    wx: dict                     # ccl4, cfc11, cfc12, cfc22 column amounts


def _plnk_interp(totplnk, t):
    """totplnk (181, nb); t (...). Linear interp on T-159 grid (setcoef)."""
    ind = torch.clamp(_trunc(t - 159.0), 1, 180)
    frac = t - 159.0 - ind
    i0 = ind - 1
    lo = totplnk[i0]                   # (..., nb)
    hi = totplnk[i0 + 1]
    return lo + frac[..., None] * (hi - lo)


def setcoef_lw(pavel, tavel, tz, tbound, wkl, wbrodl, coldry, wx_vmr,
               semiss, static):
    """Reference setcoef (rrtmg_lw_setcoef.f90:44-415), vectorized.

    pavel/tavel (..., L) bottom-up [hPa, K]; tz (..., L+1) level temps with
    index 0 = surface; tbound (...); wkl dict of molecular columns
    [molec/cm2]; wbrodl broadening-gas column; wx_vmr cross-section vmrs;
    `static` maps the static tables' names to arrays or tensors.
    """
    preflog = _on(static["preflog"], pavel)
    tref = _on(static["tref"], pavel)
    chi = _on(static["chi_mls"], pavel)         # (7, 59)
    totplnk = _on(static["totplnk"], pavel)     # (181, 16)

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

    forfac = scalefac / (1.0 + water)
    factor_t = (332.0 - tavel) / 36.0
    indfor_lo = torch.clamp(_trunc(factor_t), 1, 2)
    forfrac_lo = factor_t - indfor_lo
    indfor = torch.where(tropo, indfor_lo, 3) - 1
    forfrac = torch.where(tropo, forfrac_lo, (tavel - 188.0) / 36.0 - 1.0)

    selffac = water * forfac
    factor_s = (tavel - 188.0) / 7.2
    indself = torch.clamp(_trunc(factor_s) - 7, 1, 9) - 1
    selffrac = factor_s - (indself + 1 + 7)

    scaleminor = pavel / tavel
    scaleminorn2 = scaleminor * (wbrodl / (coldry + wkl["h2o"]))
    factor_m = (tavel - 180.8) / 7.2
    indminor = torch.clamp(_trunc(factor_m), 1, 18) - 1
    minorfrac = factor_m - (indminor + 1)

    # binary species ratios from the MLS reference profile (chi_mls)
    def ratpair(i, j):
        return chi[i - 1][jp] / chi[j - 1][jp], chi[i - 1][jp1] / chi[j - 1][jp1]

    rat = {}
    for name, (i, j) in {"h2oco2": (1, 2), "h2oo3": (1, 3), "h2on2o": (1, 4),
                         "h2och4": (1, 6), "n2oco2": (4, 2),
                         "o3co2": (3, 2)}.items():
        rat[name], rat[name + "_1"] = ratpair(i, j)

    col = {}
    for name in ("h2o", "co2", "o3", "n2o", "co", "ch4", "o2"):
        c = 1.0e-20 * wkl[name]
        if name != "h2o" and name != "o2":
            c = torch.where(c == 0.0, 1.0e-32 * coldry, c)
        col[name] = c
    col["brd"] = 1.0e-20 * wbrodl

    compfp = 1.0 - fp
    fac00 = compfp * (1.0 - ft)
    fac10 = compfp * ft
    fac01 = fp * (1.0 - ft1)
    fac11 = fp * ft1

    # rescale self/foreign factors by colh2o (setcoef.f90:409-411)
    selffac = col["h2o"] * selffac
    forfac = col["h2o"] * forfac

    planklay = _plnk_interp(totplnk, tavel)             # (..., L, 16)
    planklev = _plnk_interp(totplnk, tz)                # (..., L+1, 16)
    plankbnd = semiss * _plnk_interp(totplnk, tbound)   # (..., 16)

    wx = {k: 1.0e-20 * coldry * v for k, v in wx_vmr.items()}

    return LwSetcoef(
        tropo=tropo, jp=jp, jt=jt, jt1=jt1,
        fac00=fac00, fac01=fac01, fac10=fac10, fac11=fac11,
        col=col, coldry=coldry,
        selffac=selffac, selffrac=selffrac, indself=indself,
        forfac=forfac, forfrac=forfrac, indfor=indfor,
        indminor=indminor, minorfrac=minorfrac,
        scaleminor=scaleminor, scaleminorn2=scaleminorn2,
        rat=rat, planklay=planklay, planklev=planklev, plankbnd=plankbnd,
        wx=wx)


# ---------------------------------------------------------------------------
# taumol helpers — table interpolation as one-hot weighted matmuls
#
# Every interpolation is out = W @ tab with W[..., r] = sum_k w_k [off_k == r].
# The W matrices depend only on setcoef's (jp, jt, jt1, facXX) and the
# continuum/minor indices, which are the same for all bands, so they are
# built once per taumol call (_Weights) and reused by all 16 bands: a band's
# lookup is one matmul, not four gathers. Products over two keys are
# contracted table-first (W @ tab, then the species weights), so no
# (rows x species) outer product is ever formed.
# ---------------------------------------------------------------------------

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


class _Weights(NamedTuple):
    q_a_lo: torch.Tensor    # (..., L, 65)  fac00/fac10 at rows jp*5+jt (+1)
    q_b_lo: torch.Tensor    # (..., L, 65)  fac01/fac11 at rows (jp+1)*5+jt1 (+1)
    q_lo: torch.Tensor      # sum of the two: the 1-key lower-atmos interpolant
    q_a_up: torch.Tensor    # (..., L, 235) upper-atmosphere analogues
    q_b_up: torch.Tensor
    q_up: torch.Tensor
    minor: torch.Tensor     # (..., L, 19)  indminor/minorfrac interpolant
    forw: torch.Tensor      # (..., L, 4)   foreign continuum incl. forfac
    selfw: torch.Tensor     # (..., L, 10)  self continuum incl. selffac


def _build_weights(c: LwSetcoef) -> _Weights:
    q0 = c.jp * 5 + c.jt
    q1 = (c.jp + 1) * 5 + c.jt1
    q_a_lo = _wsum([(q0, c.fac00), (q0 + 1, c.fac10)], 65)
    q_b_lo = _wsum([(q1, c.fac01), (q1 + 1, c.fac11)], 65)
    u0 = (c.jp - 12) * 5 + c.jt
    u1 = (c.jp - 11) * 5 + c.jt1
    q_a_up = _wsum([(u0, c.fac00), (u0 + 1, c.fac10)], 235)
    q_b_up = _wsum([(u1, c.fac01), (u1 + 1, c.fac11)], 235)
    minor = _wsum([(c.indminor, 1.0 - c.minorfrac),
                   (c.indminor + 1, c.minorfrac)], 19)
    forw = c.forfac[..., None] * _wsum(
        [(c.indfor, 1.0 - c.forfrac), (c.indfor + 1, c.forfrac)], 4)
    selfw = c.selffac[..., None] * _wsum(
        [(c.indself, 1.0 - c.selffrac), (c.indself + 1, c.selffrac)], 10)
    return _Weights(q_a_lo=q_a_lo, q_b_lo=q_b_lo, q_lo=q_a_lo + q_b_lo,
                    q_a_up=q_a_up, q_b_up=q_b_up, q_up=q_a_up + q_b_up,
                    minor=minor, forw=forw, selfw=selfw)


def _continuum(W, selfref, forref, with_self=True):
    """Self + foreign water-vapor continuum (colh2o already inside the
    rescaled selffac/forfac baked into W). Returns (..., L, ng)."""
    tau = W.forw @ forref
    if with_self:
        tau = tau + W.selfw @ selfref
    return tau


def _minor2d(tab, W):
    """tab (19, ng) -> interp over indminor: (..., L, ng)."""
    return W.minor @ tab


def _spec(col1, col2, ratv, nmult):
    """Binary species parameter: returns (speccomb, js 0-based, fs, specparm)."""
    speccomb = col1 + ratv * col2
    specparm = torch.clamp(col1 / speccomb, max=ONEMINUS)
    specmult = nmult * specparm
    js = _trunc(specmult)                       # 0-based (ref: 1 + int)
    fs = specmult - js
    return speccomb, js, fs, specparm


def _contract(wq, wj, tab):
    """sum_{q,j} wq[..., q] wj[..., j] tab[q, j, g] -> (..., g): the row
    product first, then the species weights."""
    nq, nj, ng = tab.shape
    y = (wq @ tab.reshape(nq, nj * ng)).unflatten(-1, (nj, ng))
    return (wj[..., None] * y).sum(-2)


def _minor3d(tab, jm, fm, W):
    """tab (nkey, 19, ng); jm 0-based key index, fm fraction."""
    nkey = tab.shape[0]
    jm = torch.clamp(jm, max=nkey - 2)
    wm = _wsum([(jm, 1.0 - fm), (jm + 1, fm)], nkey)
    return _contract(W.minor, wm, tab.transpose(0, 1))


def _major_1key(tab, W, nrow_base):
    """4-point (p, T) interpolation for single-key-species bands as one
    matmul with the shared lower/upper one-hot weights.

    tab = absa (65, ng) with nrow_base = lower, or absb (235, ng) upper.
    Returns (..., L, ng)."""
    return (W.q_lo if nrow_base == "lower" else W.q_up) @ tab


def _js_weights(js, fs, specparm, nspa, special_branches=True):
    """Species-dimension interpolation weights (..., nspa) including the
    reference's specparm<0.125 / >0.875 cubic end-point branches."""
    if special_branches:
        m_lo = specparm < 0.125
        m_hi = specparm > 0.875
        p = torch.where(m_lo, fs - 1.0, -fs)
        p4 = p ** 4
        fk0, fk1, fk2 = p4, 1.0 - p - 2.0 * p4, p + p4
        special = m_lo | m_hi
        j0 = torch.where(m_hi, js - 1, js)
        w0 = torch.where(special, torch.where(m_lo, fk0, fk2), 1.0 - fs)
        w1 = torch.where(special, fk1, fs)
        w2 = torch.where(special, torch.where(m_lo, fk2, fk0), torch.zeros_like(fs))
        return _wsum([(j0, w0), (j0 + 1, w1), (j0 + 2, w2)], nspa)
    return _wsum([(js, 1.0 - fs), (js + 1, fs)], nspa)


def _major_2key_lower(absa, W, js, fs, specparm, js1, fs1, specparm1,
                      speccomb, speccomb1, nspa=9):
    """Two-key-species lower-atmosphere interpolation (taumol.f90 taugb3):
    the (p,T) one-hot is shared (W.q_a_lo/q_b_lo); the species dimension is a
    per-band 3-point weight; the row space factorizes (65, nspa, ng)."""
    tab3 = absa.reshape(65, nspa, -1)
    wj0 = _js_weights(js, fs, specparm, nspa)
    wj1 = _js_weights(js1, fs1, specparm1, nspa)
    t0 = _contract(W.q_a_lo, wj0, tab3)
    t1 = _contract(W.q_b_lo, wj1, tab3)
    return speccomb[..., None] * t0 + speccomb1[..., None] * t1


def _major_2key_upper(absb, W, js, fs, js1, fs1, speccomb, speccomb1, nspb=5):
    """Two-key upper-atmosphere 4-point interpolation (taugb3 upper)."""
    tab3 = absb.reshape(235, nspb, -1)
    wj0 = _js_weights(js, fs, None, nspb, special_branches=False)
    wj1 = _js_weights(js1, fs1, None, nspb, special_branches=False)
    t0 = _contract(W.q_a_up, wj0, tab3)
    t1 = _contract(W.q_b_up, wj1, tab3)
    return speccomb[..., None] * t0 + speccomb1[..., None] * t1


def _fracs_interp(fracref, jpl, fpl):
    """fracref (ng, nk); jpl 0-based; returns (..., L, ng)."""
    t = fracref.T                                   # (nk, ng)
    jpl = torch.clamp(jpl, max=t.shape[0] - 2)
    w = _wsum([(jpl, 1.0 - fpl), (jpl + 1, fpl)], t.shape[0])
    return w @ t


def _planck_js(col1, col2, refrat, nmult):
    """Planck-fraction species index (jpl, fpl)."""
    _, jpl, fpl, _ = _spec(col1, col2, refrat, nmult)
    return jpl, fpl


def _adj_minor(c, gas_col, chi_ref_row, thresh, base, expo, chi):
    """Empirical column adjustment for over-abundant minor species
    (taugb3: adjcoln2o; taugb6/7/8: adjcolco2)."""
    chi_gas = gas_col / (1.0e-20 * c.coldry)        # col is scaled by 1e-20
    ref = chi[chi_ref_row - 1][c.jp + 1]
    ratio = chi_gas / ref
    adjfac = base + torch.clamp(ratio - base, min=1e-30) ** expo
    adj = adjfac * ref * c.coldry * 1.0e-20
    return torch.where(ratio > thresh, adj, gas_col)


# ---------------------------------------------------------------------------
# taumol: all 16 bands (rrtmg_lw_taumol.f90)
# ---------------------------------------------------------------------------

def taumol_lw(c: LwSetcoef, kg: dict, static) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (taug, fracs), both (..., L, 140), bottom-up layers.

    `kg` maps table names to arrays or tensors; RRTMGLw passes them already
    on the run's device in its dtype."""
    like = c.col["h2o"]
    dt, dev = like.dtype, like.device
    chi = _on(static["chi_mls"], like)
    # the reference levels' species ratios are host constants
    chi_np = np.asarray(_Static()["chi_mls"])
    K = _consts(dev, dt)
    col = c.col
    tmask = c.tropo[..., None]
    Wt = _build_weights(c)
    taugs, fracss = [], []

    def band(b, name, default=None):
        key = f"b{b}_{name}"
        if key not in kg:
            return default
        return _on(kg[key], like)

    def lower_upper(tl, tu, fl, fu):
        taugs.append(torch.where(tmask, tl, tu))
        fracss.append(torch.where(tmask, fl, fu))

    L_shape = col["h2o"].shape

    # ---- band 1: h2o, minor n2 (lower+upper), pressure corradj ----
    b = 1
    absa, absb = band(b, "absa"), band(b, "absb")
    pavel = col["pavel"]          # hPa; needed for band-1/2 pressure corradj
    corr_lo = torch.where(pavel < 250.0,
                          1.0 - 0.15 * (250.0 - pavel) / 154.4, 1.0)
    corr_up = 1.0 - 0.15 * (pavel / 95.6)
    scalen2 = col["brd"] * c.scaleminorn2
    taun2_lo = scalen2[..., None] * _minor2d(band(b, "ka_mn2"), Wt)
    taun2_up = scalen2[..., None] * _minor2d(band(b, "kb_mn2"), Wt)
    tl = corr_lo[..., None] * (
        col["h2o"][..., None] * _major_1key(absa, Wt, "lower")
        + _continuum(Wt, band(b, "selfref"), band(b, "forref")) + taun2_lo)
    tu = corr_up[..., None] * (
        col["h2o"][..., None] * _major_1key(absb, Wt, "upper")
        + _continuum(Wt, band(b, "selfref"), band(b, "forref"), False)
        + taun2_up)
    fr_a = band(b, "fracrefa").expand(L_shape + (NGC[0],))
    fr_b = band(b, "fracrefb").expand(L_shape + (NGC[0],))
    lower_upper(tl, tu, fr_a, fr_b)

    # ---- band 2: h2o only, pressure corradj in lower ----
    b = 2
    corr_lo = 1.0 - 0.05 * (pavel - 100.0) / 900.0
    tl = corr_lo[..., None] * (
        col["h2o"][..., None] * _major_1key(band(b, "absa"), Wt, "lower")
        + _continuum(Wt, band(b, "selfref"), band(b, "forref")))
    tu = (col["h2o"][..., None] * _major_1key(band(b, "absb"), Wt, "upper")
          + _continuum(Wt, band(b, "selfref"), band(b, "forref"), False))
    lower_upper(tl, tu,
                band(b, "fracrefa").expand(L_shape + (NGC[1],)),
                band(b, "fracrefb").expand(L_shape + (NGC[1],)))

    # ---- generic 2-key lower helper ----
    def two_key_lower(b, col1, col2, ratname, planck_ij):
        """Returns (tau_major (minor terms applied by the caller),
        fracs_lower)."""
        sc, js, fs, sp = _spec(col1, col2, c.rat[ratname], 8.0)
        sc1, js1, fs1, sp1 = _spec(col1, col2, c.rat[ratname + "_1"], 8.0)
        tmaj = _major_2key_lower(band(b, "absa"), Wt, js, fs, sp,
                                 js1, fs1, sp1, sc, sc1)
        (pi, pj), plev = planck_ij
        refrat_p = float(chi_np[pi - 1, plev - 1] / chi_np[pj - 1, plev - 1])
        jpl, fpl = _planck_js(col1, col2, refrat_p, 8.0)
        fr = _fracs_interp(band(b, "fracrefa"), jpl, fpl)
        return tmaj, fr

    def minor3d_term(b, name, col1, col2, mi, mj, mlev, nmult=8.0):
        refrat_m = float(chi_np[mi - 1, mlev - 1] / chi_np[mj - 1, mlev - 1])
        _, jm, fm, _ = _spec(col1, col2, refrat_m, nmult)
        return _minor3d(band(b, name), jm, fm, Wt)

    # ---- band 3: h2o+co2, minor n2o both regions ----
    b = 3
    tmaj, fr_a = two_key_lower(b, col["h2o"], col["co2"], "h2oco2",
                               ((1, 2), 9))
    absn2o_lo = minor3d_term(b, "ka_mn2o", col["h2o"], col["co2"], 1, 2, 3)
    adjn2o = _adj_minor(c, col["n2o"], 4, 1.5, 0.5, 0.65, chi)
    tl = (tmaj + _continuum(Wt, band(b, "selfref"), band(b, "forref"))
          + adjn2o[..., None] * absn2o_lo)
    # upper
    scu, jsu, fsu, _ = _spec(col["h2o"], col["co2"], c.rat["h2oco2"], 4.0)
    scu1, jsu1, fsu1, _ = _spec(col["h2o"], col["co2"], c.rat["h2oco2_1"], 4.0)
    tmaj_u = _major_2key_upper(band(b, "absb"), Wt, jsu, fsu, jsu1, fsu1,
                               scu, scu1)
    refrat_m_b = float(chi_np[0, 12] / chi_np[1, 12])
    _, jmu, fmu, _ = _spec(col["h2o"], col["co2"], refrat_m_b, 4.0)
    absn2o_up = _minor3d(band(b, "kb_mn2o"), jmu, fmu, Wt)
    tu = (tmaj_u + _continuum(Wt, band(b, "selfref"), band(b, "forref"), False)
          + adjn2o[..., None] * absn2o_up)
    refrat_p_b = float(chi_np[0, 12] / chi_np[1, 12])
    jplu, fplu = _planck_js(col["h2o"], col["co2"], refrat_p_b, 4.0)
    fr_b = _fracs_interp(band(b, "fracrefb"), jplu, fplu)
    lower_upper(tl, tu, fr_a, fr_b)

    # ---- band 4: h2o+co2 lower; o3+co2 upper; upper g fudge factors ----
    b = 4
    tmaj, fr_a = two_key_lower(b, col["h2o"], col["co2"], "h2oco2",
                               ((1, 2), 11))
    tl = tmaj + _continuum(Wt, band(b, "selfref"), band(b, "forref"))
    scu, jsu, fsu, _ = _spec(col["o3"], col["co2"], c.rat["o3co2"], 4.0)
    scu1, jsu1, fsu1, _ = _spec(col["o3"], col["co2"], c.rat["o3co2_1"], 4.0)
    tu = _major_2key_upper(band(b, "absb"), Wt, jsu, fsu, jsu1, fsu1,
                           scu, scu1)
    tu = tu * K["fudge4"]
    refrat_p_b = float(chi_np[2, 12] / chi_np[1, 12])
    jplu, fplu = _planck_js(col["o3"], col["co2"], refrat_p_b, 4.0)
    fr_b = _fracs_interp(band(b, "fracrefb"), jplu, fplu)
    lower_upper(tl, tu, fr_a, fr_b)

    # ---- band 5: h2o+co2 lower (minor o3, ccl4); o3+co2 upper (ccl4) ----
    b = 5
    tmaj, fr_a = two_key_lower(b, col["h2o"], col["co2"], "h2oco2",
                               ((1, 2), 5))
    abso3 = minor3d_term(b, "ka_mo3", col["h2o"], col["co2"], 1, 2, 7)
    ccl4_term = c.wx["ccl4"][..., None] * band(b, "ccl4")
    tl = (tmaj + _continuum(Wt, band(b, "selfref"), band(b, "forref"))
          + col["o3"][..., None] * abso3 + ccl4_term)
    scu, jsu, fsu, _ = _spec(col["o3"], col["co2"], c.rat["o3co2"], 4.0)
    scu1, jsu1, fsu1, _ = _spec(col["o3"], col["co2"], c.rat["o3co2_1"], 4.0)
    tu = _major_2key_upper(band(b, "absb"), Wt, jsu, fsu, jsu1, fsu1,
                           scu, scu1) + ccl4_term
    refrat_p_b = float(chi_np[2, 42] / chi_np[1, 42])
    jplu, fplu = _planck_js(col["o3"], col["co2"], refrat_p_b, 4.0)
    fr_b = _fracs_interp(band(b, "fracrefb"), jplu, fplu)
    lower_upper(tl, tu, fr_a, fr_b)

    # ---- band 6: h2o lower (minor co2, cfc11, cfc12); upper cfc only ----
    b = 6
    adjco2 = _adj_minor(c, col["co2"], 2, 3.0, 2.0, 0.77, chi)
    absco2 = _minor2d(band(b, "ka_mco2"), Wt)
    cfc_term = (c.wx["cfc11"][..., None] * band(b, "cfc11adj")
                + c.wx["cfc12"][..., None] * band(b, "cfc12"))
    tl = (col["h2o"][..., None] * _major_1key(band(b, "absa"), Wt, "lower")
          + _continuum(Wt, band(b, "selfref"), band(b, "forref"))
          + adjco2[..., None] * absco2 + cfc_term)
    tu = torch.zeros_like(tl) + cfc_term
    fr = band(b, "fracrefa").expand(L_shape + (NGC[5],))
    lower_upper(tl, tu, fr, fr)

    # ---- band 7: h2o+o3 lower (minor co2); o3 upper (minor co2) ----
    b = 7
    sc, js, fs, sp = _spec(col["h2o"], col["o3"], c.rat["h2oo3"], 8.0)
    sc1, js1, fs1, sp1 = _spec(col["h2o"], col["o3"], c.rat["h2oo3_1"], 8.0)
    tmaj = _major_2key_lower(band(b, "absa"), Wt, js, fs, sp, js1, fs1, sp1,
                             sc, sc1)
    absco2_lo = minor3d_term(b, "ka_mco2", col["h2o"], col["o3"], 1, 3, 3)
    adjco2_lo = _adj_minor(c, col["co2"], 2, 3.0, 3.0, 0.79, chi)
    tl = (tmaj + _continuum(Wt, band(b, "selfref"), band(b, "forref"))
          + adjco2_lo[..., None] * absco2_lo)
    refrat_p_a = float(chi_np[0, 2] / chi_np[2, 2])
    jpl, fpl = _planck_js(col["h2o"], col["o3"], refrat_p_a, 8.0)
    fr_a = _fracs_interp(band(b, "fracrefa"), jpl, fpl)
    adjco2_up = _adj_minor(c, col["co2"], 2, 3.0, 2.0, 0.79, chi)
    tu = (col["o3"][..., None] * _major_1key(band(b, "absb"), Wt, "upper")
          + adjco2_up[..., None] * _minor2d(band(b, "kb_mco2"), Wt))
    tu = tu * K["fudge7"]
    fr_b = band(b, "fracrefb").expand(L_shape + (NGC[6],))
    lower_upper(tl, tu, fr_a, fr_b)

    # ---- band 8: h2o lower / o3 upper, minors co2+o3+n2o+cfc12+cfc22 ----
    b = 8
    adjco2 = _adj_minor(c, col["co2"], 2, 3.0, 2.0, 0.65, chi)
    cfc_term = (c.wx["cfc12"][..., None] * band(b, "cfc12")
                + c.wx["cfc22"][..., None] * band(b, "cfc22adj"))
    tl = (col["h2o"][..., None] * _major_1key(band(b, "absa"), Wt, "lower")
          + _continuum(Wt, band(b, "selfref"), band(b, "forref"))
          + adjco2[..., None] * _minor2d(band(b, "ka_mco2"), Wt)
          + col["o3"][..., None] * _minor2d(band(b, "ka_mo3"), Wt)
          + col["n2o"][..., None] * _minor2d(band(b, "ka_mn2o"), Wt)
          + cfc_term)
    tu = (col["o3"][..., None] * _major_1key(band(b, "absb"), Wt, "upper")
          + adjco2[..., None] * _minor2d(band(b, "kb_mco2"), Wt)
          + col["n2o"][..., None] * _minor2d(band(b, "kb_mn2o"), Wt)
          + cfc_term)
    lower_upper(tl, tu,
                band(b, "fracrefa").expand(L_shape + (NGC[7],)),
                band(b, "fracrefb").expand(L_shape + (NGC[7],)))

    # ---- band 9: h2o+ch4 lower (minor n2o); ch4 upper (minor n2o) ----
    b = 9
    tmaj, fr_a = two_key_lower(b, col["h2o"], col["ch4"], "h2och4",
                               ((1, 6), 9))
    absn2o_lo = minor3d_term(b, "ka_mn2o", col["h2o"], col["ch4"], 1, 6, 3)
    adjn2o = _adj_minor(c, col["n2o"], 4, 1.5, 0.5, 0.65, chi)
    tl = (tmaj + _continuum(Wt, band(b, "selfref"), band(b, "forref"))
          + adjn2o[..., None] * absn2o_lo)
    tu = (col["ch4"][..., None] * _major_1key(band(b, "absb"), Wt, "upper")
          + adjn2o[..., None] * _minor2d(band(b, "kb_mn2o"), Wt))
    fr_b = band(b, "fracrefb").expand(L_shape + (NGC[8],))
    lower_upper(tl, tu, fr_a, fr_b)

    # ---- band 10: h2o only ----
    b = 10
    tl = (col["h2o"][..., None] * _major_1key(band(b, "absa"), Wt, "lower")
          + _continuum(Wt, band(b, "selfref"), band(b, "forref")))
    tu = (col["h2o"][..., None] * _major_1key(band(b, "absb"), Wt, "upper")
          + _continuum(Wt, band(b, "selfref"), band(b, "forref"), False))
    lower_upper(tl, tu,
                band(b, "fracrefa").expand(L_shape + (NGC[9],)),
                band(b, "fracrefb").expand(L_shape + (NGC[9],)))

    # ---- band 11: h2o, minor o2 both regions ----
    b = 11
    scaleo2 = (col["o2"] * c.scaleminor)[..., None]
    tl = (col["h2o"][..., None] * _major_1key(band(b, "absa"), Wt, "lower")
          + _continuum(Wt, band(b, "selfref"), band(b, "forref"))
          + scaleo2 * _minor2d(band(b, "ka_mo2"), Wt))
    tu = (col["h2o"][..., None] * _major_1key(band(b, "absb"), Wt, "upper")
          + _continuum(Wt, band(b, "selfref"), band(b, "forref"), False)
          + scaleo2 * _minor2d(band(b, "kb_mo2"), Wt))
    lower_upper(tl, tu,
                band(b, "fracrefa").expand(L_shape + (NGC[10],)),
                band(b, "fracrefb").expand(L_shape + (NGC[10],)))

    # ---- band 12: h2o+co2 lower only ----
    b = 12
    tmaj, fr_a = two_key_lower(b, col["h2o"], col["co2"], "h2oco2",
                               ((1, 2), 10))
    tl = tmaj + _continuum(Wt, band(b, "selfref"), band(b, "forref"))
    lower_upper(tl, torch.zeros_like(tl), fr_a, torch.zeros_like(fr_a))

    # ---- band 13: h2o+n2o lower (minors co2, co); o3 minor upper ----
    b = 13
    tmaj, fr_a = two_key_lower(b, col["h2o"], col["n2o"], "h2on2o",
                               ((1, 4), 5))
    absco2 = minor3d_term(b, "ka_mco2", col["h2o"], col["n2o"], 1, 4, 1)
    # special co2 adjustment against fixed 3.55e-4 (taugb13)
    chi_co2 = col["co2"] / (1.0e-20 * c.coldry)
    ratco2 = chi_co2 / 3.55e-4
    adjfac = 2.0 + torch.clamp(ratco2 - 2.0, min=1e-30) ** 0.68
    adjco2 = torch.where(ratco2 > 3.0,
                         adjfac * 3.55e-4 * c.coldry * 1.0e-20, col["co2"])
    absco = minor3d_term(b, "ka_mco", col["h2o"], col["n2o"], 1, 4, 3)
    tl = (tmaj + _continuum(Wt, band(b, "selfref"), band(b, "forref"))
          + adjco2[..., None] * absco2 + col["co"][..., None] * absco)
    tu = col["o3"][..., None] * _minor2d(band(b, "kb_mo3"), Wt)
    fr_b = band(b, "fracrefb").expand(L_shape + (NGC[12],))
    lower_upper(tl, tu, fr_a, fr_b)

    # ---- band 14: co2 only ----
    b = 14
    tl = (col["co2"][..., None] * _major_1key(band(b, "absa"), Wt, "lower")
          + _continuum(Wt, band(b, "selfref"), band(b, "forref")))
    tu = col["co2"][..., None] * _major_1key(band(b, "absb"), Wt, "upper")
    lower_upper(tl, tu,
                band(b, "fracrefa").expand(L_shape + (NGC[13],)),
                band(b, "fracrefb").expand(L_shape + (NGC[13],)))

    # ---- band 15: n2o+co2 lower (minor n2); nothing upper ----
    b = 15
    sc, js, fs, sp = _spec(col["n2o"], col["co2"], c.rat["n2oco2"], 8.0)
    sc1, js1, fs1, sp1 = _spec(col["n2o"], col["co2"], c.rat["n2oco2_1"], 8.0)
    tmaj = _major_2key_lower(band(b, "absa"), Wt, js, fs, sp, js1, fs1, sp1,
                             sc, sc1)
    refrat_m_a = float(chi_np[3, 0] / chi_np[1, 0])
    _, jm, fm, _ = _spec(col["n2o"], col["co2"], refrat_m_a, 8.0)
    scalen2 = (col["brd"] * c.scaleminor)[..., None]
    taun2 = scalen2 * _minor3d(band(b, "ka_mn2"), jm, fm, Wt)
    tl = (tmaj + _continuum(Wt, band(b, "selfref"), band(b, "forref"))
          + taun2)
    refrat_p_a = float(chi_np[3, 0] / chi_np[1, 0])
    jpl, fpl = _planck_js(col["n2o"], col["co2"], refrat_p_a, 8.0)
    fr_a = _fracs_interp(band(b, "fracrefa"), jpl, fpl)
    lower_upper(tl, torch.zeros_like(tl), fr_a, torch.zeros_like(fr_a))

    # ---- band 16: h2o+ch4 lower; ch4 upper ----
    b = 16
    tmaj, fr_a = two_key_lower(b, col["h2o"], col["ch4"], "h2och4",
                               ((1, 6), 6))
    tl = tmaj + _continuum(Wt, band(b, "selfref"), band(b, "forref"))
    tu = col["ch4"][..., None] * _major_1key(band(b, "absb"), Wt, "upper")
    fr_b = band(b, "fracrefb").expand(L_shape + (NGC[15],))
    lower_upper(tl, tu, fr_a, fr_b)

    return torch.cat(taugs, dim=-1), torch.cat(fracss, dim=-1)


# ---------------------------------------------------------------------------
# radiative transfer (rrtmg_lw_rtrn.f90, random cloud overlap) — exact math
# ---------------------------------------------------------------------------

def _tfn(od):
    """Exact linear-in-tau transition function (rrtmg_lw_init.f90:117-123)."""
    ods = torch.clamp(od, min=1e-12)
    exact = 1.0 - 2.0 * (1.0 / ods - torch.exp(-ods) / (1.0 - torch.exp(-ods)))
    return torch.where(od < 0.06, od / 6.0, exact)


class LwFluxes(NamedTuple):
    uflx: torch.Tensor        # (..., L+1) upward flux, TOP-DOWN half levels
    dflx: torch.Tensor
    uflxc: torch.Tensor       # clear sky
    dflxc: torch.Tensor
    hr: torch.Tensor          # (..., L) heating rate [K/s], top-down
    hrc: torch.Tensor
    olr: torch.Tensor         # (...)
    lw_dn_surf: torch.Tensor
    lw_dn_surf_clr: torch.Tensor


class LwDownState(NamedTuple):
    """t_surf-independent part of rtrn (downward pass + layer coefficients),
    so the adapter can expose surf_lw_down before the surface update and
    finish the upward pass with the new t_surf (the grey scheme's
    down/up split, two_stream_gray_rad.F90:386/:659)."""
    A: torch.Tensor            # (..., L, ngpt) recursion coefficient
    Su: torch.Tensor           # upward source
    atrans: torch.Tensor
    bbu: torch.Tensor
    anycld: torch.Tensor       # (..., L) bool
    seen_any: torch.Tensor     # (...,) bool: cloud anywhere in column
    radld_sfc: torch.Tensor    # (..., ngpt)
    radclrd_sfc: torch.Tensor
    drad_bu: torch.Tensor      # (L+1, ..., ngpt) downward radiance
    dclr_bu: torch.Tensor
    fracs_sfc: torch.Tensor    # (..., ngpt)


def rtrn_down(taut, fracs, planklay, planklev, pwvcm, cldfrac, taucloud,
              band_of_g) -> LwDownState:
    """Downward half of rtrn: layer coefficients + top-to-surface sweep.

    Without clouds the clear-sky stream is the total stream (isca_tpu's
    `where(seen, clear, total)` never takes `clear`), and the same tensors
    are returned for both."""
    nl = taut.shape[-2]
    K = _consts(taut.device, taut.dtype)

    # diffusivity secant per band -> per g
    sec = torch.where(K["secdiff_fixed"], 1.66, torch.clamp(
        K["secdiff_a0"] + K["secdiff_a1"] * torch.exp(K["secdiff_a2"] * pwvcm[..., None]),
        1.5, 1.8))
    secg = sec[..., band_of_g][..., None, :]                 # (..., 1, ngpt)

    od = torch.clamp(secg * taut, min=0.0)
    atrans = 1.0 - torch.exp(-od)
    tf = _tfn(od)

    plfrac = fracs
    blay = planklay[..., band_of_g]                          # (..., L, ngpt)
    plev_g = planklev[..., band_of_g]                        # (..., L+1, ngpt)
    dplankup = plev_g[..., 1:, :] - blay
    dplankdn = plev_g[..., :-1, :] - blay

    bbd = plfrac * (blay + tf * dplankdn)
    bbu = plfrac * (blay + tf * dplankup)

    cloudy = cldfrac is not None
    if cloudy:
        # cldfrac/taucloud may be per-layer (ncbands=16 path, rtrn) or
        # per-g-point binary (McICA path, rtrnmc)
        per_g = cldfrac.dim() == taut.dim()
        cf = cldfrac if per_g else cldfrac[..., None]
        icld = cf >= 1.0e-6
        odcld = secg * (taucloud if per_g else taucloud[..., band_of_g])
        odcld = torch.where(icld, odcld, 0.0)
        abscld = 1.0 - torch.exp(-odcld)
        efclfrac = abscld * cf
        odtot = od + odcld
        atot = 1.0 - torch.exp(-odtot)
        tftot = _tfn(odtot)
        bbdtot = plfrac * (blay + tftot * dplankdn)
        bbutot = plfrac * (blay + tftot * dplankup)
        # linear recursion coefficients
        A = torch.where(icld, 1.0 - atrans - efclfrac * (1.0 - atrans),
                        1.0 - atrans)
        gassrc_d = bbd * atrans
        Sd = torch.where(icld, gassrc_d + cf * (bbdtot * atot - gassrc_d),
                         gassrc_d)
        gassrc_u = bbu * atrans
        Su = torch.where(icld, gassrc_u + cf * (bbutot * atot - gassrc_u),
                         gassrc_u)
        anycld = torch.any(icld, dim=-1)
    else:
        A = 1.0 - atrans
        Sd = bbd * atrans
        Su = bbu * atrans
        anycld = torch.zeros(taut.shape[:-1], dtype=torch.bool, device=taut.device)

    # ---- downward sweep: top layer (index nl-1) to bottom (0) ----
    lay = lambda a, l: a[..., l, :]
    radld = torch.zeros_like(A[..., 0, :])
    radclrd = radld
    seen = torch.zeros(anycld.shape[:-1], dtype=torch.bool, device=taut.device)
    drad, dclr = [None] * nl, [None] * nl
    for l in range(nl - 1, -1, -1):
        radld = lay(A, l) * radld + lay(Sd, l)
        if cloudy:
            seen = seen | anycld[..., l]
            at = lay(atrans, l)
            clr = (1.0 - at) * radclrd + lay(bbd, l) * at
            radclrd = torch.where(seen[..., None], clr, radld)
        else:
            radclrd = radld
        drad[l], dclr[l] = radld, radclrd
    # drad[l] = downward radiance at the interface below layer l, i.e. at
    # bottom-up level l; nothing comes down through the top (level nl)
    zero = torch.zeros_like(radld)
    drad_bu = torch.stack(drad + [zero], dim=0)              # (L+1, ..., ngpt)
    dclr_bu = torch.stack(dclr + [zero], dim=0) if cloudy else drad_bu

    return LwDownState(A=A, Su=Su, atrans=atrans, bbu=bbu, anycld=anycld,
                       seen_any=seen, radld_sfc=radld, radclrd_sfc=radclrd,
                       drad_bu=drad_bu, dclr_bu=dclr_bu, fracs_sfc=fracs[..., 0, :])


def _spectral_integrate(r, band_of_g, delwave):
    dwave_g = _on(delwave, r)[band_of_g]
    w = WTDIFF * FLUXFAC * dwave_g
    r = torch.movedim(r, 0, -2)                 # (..., L+1, ngpt)
    return torch.sum(r * w, dim=-1)


def rtrn_up(st: LwDownState, plankbnd, semiss, band_of_g, delwave):
    """Upward half of rtrn: surface emission/reflection + surface-to-top
    sweep + spectral integration. Returns bottom-up level fluxes."""
    nl = st.A.shape[-2]
    # without clouds rtrn_down returns one tensor for both streams
    cloudy = st.dclr_bu is not st.drad_bu
    pbnd_g = plankbnd[..., band_of_g]                        # (..., ngpt)
    rad0 = st.fracs_sfc * pbnd_g
    semiss_g = semiss[..., band_of_g]
    reflect = 1.0 - semiss_g
    radlu = rad0 + reflect * st.radld_sfc
    radclru = rad0 + reflect * st.radclrd_sfc if cloudy else radlu

    lay = lambda a, l: a[..., l, :]
    urad, uclr = [radlu], [radclru]
    for l in range(nl):
        radlu = lay(st.A, l) * radlu + lay(st.Su, l)
        if cloudy:
            at = lay(st.atrans, l)
            clr = (1.0 - at) * radclru + lay(st.bbu, l) * at
            radclru = torch.where(st.seen_any[..., None], clr, radlu)
        else:
            radclru = radlu
        urad.append(radlu)
        uclr.append(radclru)
    urad_bu = torch.stack(urad, dim=0)                       # (L+1, ..., ngpt)
    uflx = _spectral_integrate(urad_bu, band_of_g, delwave)
    dflx = _spectral_integrate(st.drad_bu, band_of_g, delwave)
    if not cloudy:
        return uflx, dflx, uflx, dflx
    return (uflx, dflx,
            _spectral_integrate(torch.stack(uclr, dim=0), band_of_g, delwave),
            _spectral_integrate(st.dclr_bu, band_of_g, delwave))


# ---------------------------------------------------------------------------
# cloud optical depths (rrtmg_lw_cldprop.f90, inflag=2 iceflag=2 liqflag=1)
# ---------------------------------------------------------------------------

def _cloud_absco(rel, rei, static):
    """Per-band absorption coefficients (..., L, 16) of ice (Streamer v3,
    iceflag=2: 5 <= rei <= 131) and liquid (Hu & Stamnes, liqflag=1:
    2.5 <= rel <= 60)."""
    absice2 = _on(static["absice2"], rel)    # (43, 16)
    absliq1 = _on(static["absliq1"], rel)    # (58, 16)
    radice = torch.clamp(rei, 5.0, 131.0)
    factor = (radice - 2.0) / 3.0
    idx = torch.clamp(_trunc(factor), max=42) - 1
    idx = torch.clamp(idx, 0, 41)
    fint = factor - (idx + 1)
    absco_ice = absice2[idx] + fint[..., None] * (absice2[idx + 1] - absice2[idx])
    radliq = torch.clamp(rel, 2.5, 60.0)
    lidx = torch.clamp(_trunc(radliq - 1.5), 1, 57) - 1
    lfint = radliq - 1.5 - (lidx + 1)
    absco_liq = absliq1[lidx] + lfint[..., None] * (absliq1[lidx + 1] - absliq1[lidx])
    return absco_ice, absco_liq


def cldprop_lw(cldfrac, clwp, ciwp, rel, rei, static):
    """Returns taucloud (..., L, 16); water paths g/m2, radii microns."""
    absco_ice, absco_liq = _cloud_absco(rel, rei, static)
    tau = (ciwp[..., None] * torch.where(ciwp[..., None] > 0, absco_ice, 0.0)
           + clwp[..., None] * torch.where(clwp[..., None] > 0, absco_liq, 0.0))
    return torch.where(cldfrac[..., None] >= 1.0e-20, tau, 0.0)


def cldprop_lw_mcica(clwp_g, ciwp_g, rel, rei, static, band_of_g):
    """Per-g-point cloud optical depths for the McICA path: the absorption
    coefficients are per band (from rel/rei per layer), the binary water
    paths per g-point subcolumn. Returns tau (..., L, ngpt)."""
    absco_ice, absco_liq = _cloud_absco(rel, rei, static)
    return ciwp_g * absco_ice[..., band_of_g] + clwp_g * absco_liq[..., band_of_g]


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RRTMGLwConfig:
    co2vmr: float = 300.0e-6
    n2ovmr: float = 0.0
    ch4vmr: float = 0.0
    o2vmr: float = 0.209488
    covmr: float = 0.0
    ccl4vmr: float = 0.0
    cfc11vmr: float = 0.0
    cfc12vmr: float = 0.0
    cfc22vmr: float = 0.0
    emissivity: float = 1.0   # broadband surface emissivity (Isca: emis=1)
    grav: float = 9.80
    cp_air: float = 1004.64


class RRTMGLw:
    """Longwave radiative transfer driver.

    All inputs level-LAST, TOP-DOWN; internals flip to the reference's
    bottom-up layer order. The k-tables load from data/rrtmg_lw_kg.npz, or
    from an explicit `kg` dict or npz path; they live on `device` in the
    dtype of the inputs, converted at the first call in each dtype."""

    def __init__(self, config: RRTMGLwConfig = RRTMGLwConfig(), kg=None, device=None):
        self.config = config
        self.device = resolve_device(device)
        if kg is None:
            if not KG_NPZ.exists():
                raise FileNotFoundError(
                    f"{KG_NPZ} missing: isca_tpu_torch ships a copy of isca_tpu's "
                    "k-tables there")
            kg = KG_NPZ
        if isinstance(kg, (str, Path)):
            with np.load(kg) as d:
                kg = {k: d[k] for k in d.files}
        self.kg = {k: np.asarray(v) for k, v in kg.items()}
        if int(np.asarray(self.kg.get("synthetic", 0))) == 1:
            # every construction, as isca_tpu: LW fluxes from synthetic
            # k-tables are structurally correct but not AER-accurate
            warnings.warn(
                "RRTMG-LW is running on SYNTHETIC k-distribution tables "
                "(isca_tpu_torch/data/rrtmg_lw_kg.npz, synthetic=1). Fluxes are "
                "physically plausible but not AER-accurate. Rebuild the npz "
                "from AER's rrtmg_lw.nc (tools/extract_rrtmg_lw.py) for "
                "production longwave.", RuntimeWarning, stacklevel=2)
        self.band_of_g = torch.as_tensor(np.repeat(np.arange(NBND), NGC),
                                         device=self.device)
        self._kg_on = {}

    def _tables(self, dtype):
        """The k-tables on the device in `dtype` (made at first use)."""
        if dtype not in self._kg_on:
            self._kg_on[dtype] = {
                k: torch.as_tensor(v).to(device=self.device, dtype=dtype)
                for k, v in self.kg.items() if k.startswith("b")}
        return self._kg_on[dtype]

    def down_phase(self, p_half, p_full, t_full, t_half, q, o3,
                   cldfrac=None, clwp=None, ciwp=None, rel=None, rei=None,
                   co2vmr=None, mcica_key=None):
        """t_surf-independent computation: column amounts, setcoef, taumol,
        cloud optics and the downward rtrn pass. Returns (lw_down top-down
        (..., L+1), stash) — complete with `up_phase(stash, t_surf)`."""
        cfg = self.config
        flip = lambda a: torch.flip(a, (-1,))
        pavel = flip(p_full) * 1e-2
        tavel = flip(t_full)
        pz = flip(p_half) * 1e-2                      # (..., L+1), sfc first
        tz = flip(t_half)
        h2ovmr = flip(q / (1.0 - q)) * (AMD / AMW)
        o3vmr = flip(o3) * (AMD / 47.9982)
        co2 = cfg.co2vmr if co2vmr is None else co2vmr

        amm = (1.0 - h2ovmr) * AMD + h2ovmr * AMW
        coldry = ((pz[..., :-1] - pz[..., 1:]) * 1.0e3 * AVOGAD
                  / (1.0e2 * GRAV_CGS * amm * (1.0 + h2ovmr)))
        one = torch.ones_like(coldry)
        vmr = {"h2o": h2ovmr, "co2": co2 * one, "o3": o3vmr,
               "n2o": cfg.n2ovmr * one, "co": cfg.covmr * one,
               "ch4": cfg.ch4vmr * one, "o2": cfg.o2vmr * one}
        wkl = {k: v * coldry for k, v in vmr.items()}
        summol = sum(vmr[k] for k in ("co2", "o3", "n2o", "co", "ch4", "o2"))
        wbrodl = coldry * (1.0 - summol)

        # precipitable water (inatm, rrtmg_lw_rad.nomcica.f90:835-845)
        amttl = torch.sum(coldry + wkl["h2o"], dim=-1)
        wvttl = torch.sum(wkl["h2o"], dim=-1)
        wvsh = (AMW * wvttl) / (AMD * amttl)
        pwvcm = wvsh * (1.0e3 * pz[..., 0]) / (1.0e2 * GRAV_CGS)

        wx_vmr = {"ccl4": cfg.ccl4vmr * one, "cfc11": cfg.cfc11vmr * one,
                  "cfc12": cfg.cfc12vmr * one, "cfc22": cfg.cfc22vmr * one}

        static = _consts(pavel.device, pavel.dtype)
        semiss = cfg.emissivity * torch.ones(16, dtype=pavel.dtype, device=pavel.device)
        # tbound only affects plankbnd (used in up_phase); pass a dummy here
        c = setcoef_lw(pavel, tavel, tz, tz[..., 0], wkl, wbrodl, coldry,
                       wx_vmr, semiss, static)
        # taumol needs pavel for the band-1/2 pressure corrections
        c.col["pavel"] = pavel
        taug, fracs = taumol_lw(c, self._tables(pavel.dtype), static)

        taucloud = None
        cldf_bu = None
        if cldfrac is not None and mcica_key is not None:
            # McICA: one binary stochastic subcolumn per g-point
            # (rrtmg_lw_rad.f90 + mcica_subcol_gen_lw.f90 path)
            cldf_g, clwp_g, ciwp_g = mcica_subcol(mcica_key, cldfrac, clwp, ciwp, NGPT)
            flipl = lambda a: torch.flip(a, (-2,))
            cldf_bu = flipl(cldf_g)
            taucloud = cldprop_lw_mcica(flipl(clwp_g), flipl(ciwp_g), flip(rel),
                                        flip(rei), static, self.band_of_g)
        elif cldfrac is not None:
            cldf_bu = flip(cldfrac)
            taucloud = cldprop_lw(cldf_bu, flip(clwp), flip(ciwp),
                                  flip(rel), flip(rei), static)

        st = rtrn_down(taug, fracs, c.planklay, c.planklev, pwvcm,
                       cldf_bu, taucloud, self.band_of_g)
        dflx = _spectral_integrate(st.drad_bu, self.band_of_g, static["delwave"])
        stash = dict(st=st, semiss=semiss, p_half=p_half)
        return flip(dflx), stash

    def up_phase(self, stash, t_surf) -> LwFluxes:
        """Surface emission with the (possibly updated) t_surf + upward pass
        + heating rates."""
        cfg = self.config
        flip = lambda a: torch.flip(a, (-1,))
        semiss = stash["semiss"]
        static = _consts(t_surf.device, t_surf.dtype)
        plankbnd = semiss * _plnk_interp(static["totplnk"], t_surf)
        uflx, dflx, uflxc, dflxc = rtrn_up(
            stash["st"], plankbnd, semiss, self.band_of_g, static["delwave"])
        p_half = stash["p_half"]
        uflx_td, dflx_td = flip(uflx), flip(dflx)
        uflxc_td, dflxc_td = flip(uflxc), flip(dflxc)

        fnet = uflx_td - dflx_td
        fnetc = uflxc_td - dflxc_td
        dp = p_half[..., 1:] - p_half[..., :-1]
        # heating = flux convergence: +(Fnet below - Fnet above)/dp * g/cp
        hr = (cfg.grav / cfg.cp_air) * (fnet[..., 1:] - fnet[..., :-1]) / dp
        hrc = (cfg.grav / cfg.cp_air) * (fnetc[..., 1:] - fnetc[..., :-1]) / dp
        return LwFluxes(uflx=uflx_td, dflx=dflx_td, uflxc=uflxc_td,
                        dflxc=dflxc_td, hr=hr, hrc=hrc,
                        olr=uflx_td[..., 0],
                        lw_dn_surf=dflx_td[..., -1],
                        lw_dn_surf_clr=dflxc_td[..., -1])

    def __call__(self, p_half, p_full, t_full, t_half, t_surf, q, o3,
                 cldfrac=None, clwp=None, ciwp=None, rel=None, rei=None,
                 co2vmr=None, mcica_key=None) -> LwFluxes:
        """p in Pa; q specific humidity [kg/kg]; o3 mass mixing ratio;
        t_half (..., L+1) level temperatures (top-down); t_surf (...).
        Cloud water paths [g/m2] and effective radii [microns], top-down.
        With `mcica_key` (a uint32[2] threefry key), clouds are sampled
        stochastically per g-point (McICA, physics/mcica.py)."""
        _, stash = self.down_phase(p_half, p_full, t_full, t_half, q, o3,
                                   cldfrac=cldfrac, clwp=clwp, ciwp=ciwp,
                                   rel=rel, rei=rei, co2vmr=co2vmr,
                                   mcica_key=mcica_key)
        return self.up_phase(stash, t_surf)
