"""isca_tpu_torch RRTMG-LW and the RRTM adapter's RRTMG-LW branch against
isca_tpu: setcoef, taumol band by band, both halves of rtrn with and without
clouds, cldprop (fractional and McICA), the RRTMGLw driver, the MLS golden,
and RRTMRadiation's down/up with a CO2 concentration, lonstep and do_zm_rad.

The committed k-tables are used throughout (isca_tpu_torch/data, a byte copy
of isca_tpu/data): the physical checks of tests/test_rrtmg_lw.py (transparent
and opaque limits with zeroed tables, warmer surface, more CO2, clouds) run
on them, not on tools/extract_rrtmg_lw.make_synthetic_kg, which reads the
reference checkout.

Tolerances: rtol 1e-10 (and atol 1e-10 x the field's largest entry) at
float64 against isca_tpu: the same arithmetic, reassociated only in the
one-hot products, the g-sums and the last bits of libm; integer indices
equal. The MLS golden at its own rtol 2e-4; the physical checks at the JAX
tests' own bounds.
"""

import filecmp
import json
import logging
import pathlib
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isca_tpu.dycore import press_geopot as jpg
from isca_tpu.dycore import vert_coordinate as jvc
from isca_tpu.physics import rrtm_radiation as jrr
from isca_tpu.physics import rrtmg_lw as J
from isca_tpu_torch.physics import rrtm_radiation as trr
from isca_tpu_torch.physics import rrtmg_lw as P

REPO = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = REPO / "tests" / "goldens" / "rrtmg_lw_mls.json"
SIGMA = 5.670400e-8   # rrtmg's own sbcnst (rrtmg_lw_init.f90:252)
RTOL = 1e-10
CPU64 = (torch.device("cpu"), torch.float64)
GAS = dict(co2vmr=3.0e-4, n2ovmr=3.2e-7, ch4vmr=1.8e-6, covmr=1.5e-7, ccl4vmr=1e-10,
           cfc11vmr=2.5e-10, cfc12vmr=5e-10, cfc22vmr=1e-10)


def close(port, ref, rtol=RTOL, msg=""):
    port = port.detach().cpu().numpy() if torch.is_tensor(port) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (msg, port.shape, ref.shape)
    if ref.dtype.kind in "biu":
        np.testing.assert_array_equal(port, ref, err_msg=msg)
        return
    atol = rtol * float(np.abs(ref).max(initial=0.0))
    np.testing.assert_allclose(port, ref, rtol=rtol, atol=atol, err_msg=msg)


def close_tuple(port, ref, rtol=RTOL, what=""):
    for name in ref._fields:
        a, b = getattr(port, name), getattr(ref, name)
        if isinstance(b, dict):
            assert set(a) == set(b), (what, name)
            for k in b:
                close(a[k], b[k], rtol, f"{what} {name}[{k}]")
        else:
            close(a, b, rtol, f"{what} {name}")


def lw_port(kg=None, **cfg):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return P.RRTMGLw(P.RRTMGLwConfig(**cfg), kg=kg, device="cpu")


def lw_jax(kg=None, **cfg):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return J.RRTMGLw(J.RRTMGLwConfig(**cfg), kg=kg)


def mls_profile(L=40, ncol=2, ps=1.0e5, t_sfc=294.0, rh=0.4):
    """Top-down MLS-like columns incl. half-level temperatures
    (tests/test_rrtmg_lw.py mls_profile, as numpy)."""
    p_half = np.linspace(20.0, ps, L + 1)
    p_full = 0.5 * (p_half[:-1] + p_half[1:])
    H = 7500.0
    z = H * np.log(ps / p_full)
    zh = H * np.log(ps / np.maximum(p_half, 1.0))
    t = np.maximum(t_sfc - 6.5e-3 * z, 216.0)
    th = np.maximum(t_sfc - 6.5e-3 * zh, 216.0)
    es = 610.78 * np.exp(17.27 * (t - 273.15) / (t - 35.85))
    q = np.minimum(rh * 0.622 * es / p_full, 0.02)
    o3 = 1.5e-5 * np.exp(-((np.log(p_full) - np.log(2000.0)) / 0.8) ** 2) + 1e-8
    tile = lambda a, n=L: np.broadcast_to(a, (ncol, n)).copy()
    return (tile(p_half, L + 1), tile(p_full), tile(t), tile(th, L + 1),
            np.full((ncol,), t_sfc), tile(q), tile(o3))


def three_columns():
    """Mid-latitude summer, a moist tropical and a dry cold column: every
    species-interpolation branch and both table regions are taken."""
    cols = [mls_profile(ncol=1, t_sfc=ts, rh=rh)
            for ts, rh in ((294.0, 0.4), (305.0, 0.9), (250.0, 0.15))]
    return tuple(np.concatenate(parts) for parts in zip(*cols))


def column(ncol=3, L=20, ts=295.0):
    """tests/test_rrtmg_lw.py column, as numpy."""
    sig = np.linspace(0.03, 0.97, L)
    ps = 1.0e5
    p_full = np.broadcast_to(sig * ps, (ncol, L)).copy()
    ph = np.concatenate([[2e2], 0.5 * (sig[1:] + sig[:-1]) * ps, [ps]])
    p_half = np.broadcast_to(ph, (ncol, L + 1)).copy()
    t_full = 215 + (ts - 20 - 215) * sig[None, :] * np.ones((ncol, 1))
    th = 215 + (ts - 20 - 215) * np.concatenate([[sig[0]], 0.5 * (sig[1:] + sig[:-1]), [1.0]])
    t_half = np.broadcast_to(th, (ncol, L + 1)).copy()
    t_surf = np.full(ncol, ts)
    q = 8e-3 * np.exp(-(1 - sig[None, :]) * 5) * np.ones((ncol, 1))
    o3 = 1e-6 * np.exp(-np.log(p_full / 3e3) ** 2)
    return p_half, p_full, t_full, t_half, t_surf, q, o3


def T(a):
    return torch.as_tensor(np.array(a))


def clouds(shape, layer=6, frac=1.0):
    cf = np.zeros(shape)
    cf[:, layer] = frac
    clwp = np.zeros(shape)
    clwp[:, layer] = 80.0
    ciwp = np.zeros(shape)
    ciwp[:, layer] = 20.0
    return dict(cldfrac=cf, clwp=clwp, ciwp=ciwp, rel=np.full(shape, 12.0),
                rei=np.full(shape, 40.0))


def bottom_up(args, cfg=GAS):
    """setcoef's inputs as RRTMGLw.down_phase builds them, as numpy."""
    p_half, p_full, t_full, t_half, t_surf, q, o3 = args
    flip = lambda a: a[..., ::-1].copy()
    pavel, tavel = flip(p_full) * 1e-2, flip(t_full)
    pz, tz = flip(p_half) * 1e-2, flip(t_half)
    h2ovmr = flip(q / (1.0 - q)) * (J.AMD / J.AMW)
    amm = (1.0 - h2ovmr) * J.AMD + h2ovmr * J.AMW
    coldry = ((pz[..., :-1] - pz[..., 1:]) * 1.0e3 * J.AVOGAD
              / (1.0e2 * J.GRAV_CGS * amm * (1.0 + h2ovmr)))
    one = np.ones_like(coldry)
    vmr = {"h2o": h2ovmr, "co2": cfg["co2vmr"] * one, "o3": flip(o3) * (J.AMD / 47.9982),
           "n2o": cfg["n2ovmr"] * one, "co": cfg["covmr"] * one, "ch4": cfg["ch4vmr"] * one,
           "o2": 0.209488 * one}
    wkl = {k: v * coldry for k, v in vmr.items()}
    wbrodl = coldry * (1.0 - sum(vmr[k] for k in ("co2", "o3", "n2o", "co", "ch4", "o2")))
    wx = {k: cfg[f"{k}vmr"] * one for k in ("ccl4", "cfc11", "cfc12", "cfc22")}
    return pavel, tavel, tz, t_surf, wkl, wbrodl, coldry, wx, np.ones(16)


def setcoef_both(args):
    pavel, tavel, tz, tb, wkl, wbrodl, coldry, wx, semiss = bottom_up(args)
    jd = lambda d: {k: jnp.asarray(v) for k, v in d.items()}
    td = lambda d: {k: T(v) for k, v in d.items()}
    jc = J.setcoef_lw(*map(jnp.asarray, (pavel, tavel, tz, tb)), jd(wkl),
                      jnp.asarray(wbrodl), jnp.asarray(coldry), jd(wx), jnp.asarray(semiss),
                      J._Static())
    # the port's tables as numpy (converted per call) and as its device tensors
    tc = P.setcoef_lw(*map(T, (pavel, tavel, tz, tb)), td(wkl), T(wbrodl), T(coldry),
                      td(wx), T(semiss), P._Static())
    tc2 = P.setcoef_lw(*map(T, (pavel, tavel, tz, tb)), td(wkl), T(wbrodl), T(coldry),
                       td(wx), T(semiss), P._consts(*CPU64))
    jc.col["pavel"] = jnp.asarray(pavel)
    tc.col["pavel"] = tc2.col["pavel"] = T(pavel)
    return jc, tc, tc2


@pytest.fixture(scope="module")
def taumol_both():
    jc, tc, _ = setcoef_both(three_columns())
    with np.load(P.KG_NPZ) as d:
        kg = {k: d[k] for k in d.files}
    jtau = jax.jit(lambda c: J.taumol_lw(c, kg, J._Static()))(jc)
    return jc, tc, jtau, P.taumol_lw(tc, kg, P._Static())


# ---------------------------------------------------------------------------
# data and construction
# ---------------------------------------------------------------------------

def test_tables_are_isca_tpus_and_warn():
    for name in ("rrtmg_lw_kg.npz", "rrtmg_lw_static.npz"):
        assert filecmp.cmp(REPO / "isca_tpu_torch" / "data" / name,
                           REPO / "isca_tpu" / "data" / name, shallow=False), name
    assert P.kg_available() and P.KG_NPZ.parent == REPO / "isca_tpu_torch" / "data"
    for _ in range(2):          # every construction, as isca_tpu
        with pytest.warns(RuntimeWarning, match="SYNTHETIC"):
            P.RRTMGLw(device="cpu")
    assert sum(P.NGC) == P.NGPT == 140
    with np.load(P.KG_NPZ) as kg:
        for b in range(1, 17):
            assert kg[f"b{b}_absa"].shape[1] == P.NGC[b - 1]
        assert int(kg["synthetic_version"]) >= 4


def test_rrtm_default_builds_rrtmg_lw(caplog):
    with caplog.at_level(logging.WARNING, logger="isca_tpu_torch"), \
            pytest.warns(RuntimeWarning, match="SYNTHETIC"):
        rad = trr.RRTMRadiation(trr.RRTMConfig(), device="cpu")
    assert isinstance(rad.lw_rrtmg, P.RRTMGLw)
    assert "SYNTHETIC" in caplog.text
    assert trr.RRTMRadiation(trr.RRTMConfig(lw_scheme="grey"), device="cpu").lw_rrtmg is None
    with pytest.warns(RuntimeWarning):
        forced = trr.RRTMRadiation(trr.RRTMConfig(lw_scheme="rrtmg", lw_kg_path=str(P.KG_NPZ)),
                                   device="cpu")
    assert forced.lw_rrtmg is not None
    cfg_j = {f: getattr(jrr.RRTMConfig(), f) for f in jrr.RRTMConfig.__dataclass_fields__}
    cfg_t = {f: getattr(trr.RRTMConfig(), f) for f in trr.RRTMConfig.__dataclass_fields__}
    assert set(cfg_t) == set(cfg_j)
    for k in cfg_j:
        if k not in ("lw", "constants"):
            assert cfg_t[k] == cfg_j[k], k


def test_mcica_and_cloud_fields_raise_naming_a6b():
    """McICA and the RRTM adapter's cloud_fields were ported by A.6b and no
    longer raise (their parity with isca_tpu is in
    tests/test_torch_clouds_rrtm.py): with no clouds a McICA key changes
    nothing, and the adapter takes SimCloud's fields."""
    from isca_tpu_torch.utils.threefry import prng_key

    lw = lw_port()
    args = tuple(map(T, column()))
    kw = {k: T(v) for k, v in clouds(args[1].shape, frac=0.0).items()}
    plain = lw(*args, **kw)
    mc = lw(*args, mcica_key=prng_key(3, device="cpu"), **kw)
    close_tuple(mc, plain, rtol=0.0, what="mcica, no cloud")
    c = rad_columns()
    cf = np.full(c["t"].shape, 0.5)
    with pytest.warns(RuntimeWarning):
        down = trr.RRTMRadiation(trr.RRTMConfig(), device="cpu").down(
            *(T(c[k]) for k in ("lat", "lon", "p_half", "t", "q")), T(c["t_surf"]),
            cloud_fields=(T(cf), T(np.full_like(cf, 12.0)), T(cf * 1e-4), T(np.ones_like(cf))))
    assert bool(torch.isfinite(down.surf_lw_down).all())


def test_planck_table_integrates_to_stefan_boltzmann():
    tp, dw = P._Static()["totplnk"], P._Static()["delwave"]
    for temp in (180, 240, 300, 330):
        tot = (tp[int(temp - 159) - 1] * dw).sum() * np.pi * 2e4 * 0.5
        assert abs(tot / (SIGMA * temp ** 4) - 1) < 2e-4


# ---------------------------------------------------------------------------
# module functions against isca_tpu
# ---------------------------------------------------------------------------

def test_setcoef_matches():
    jc, tc, tc2 = setcoef_both(three_columns())
    close_tuple(tc, jc, what="setcoef")
    close_tuple(tc2, jc, rtol=0.0, what="setcoef (device tables)")
    assert bool(tc.tropo.any()) and bool((~tc.tropo).any())


@pytest.mark.parametrize("band", range(1, 17))
def test_taumol_band_matches(taumol_both, band):
    jc, tc, (jtaug, jfracs), (ttaug, tfracs) = taumol_both
    lo = sum(P.NGC[:band - 1])
    sl = slice(lo, lo + P.NGC[band - 1])
    close(ttaug[..., sl], np.asarray(jtaug)[..., sl], msg=f"taug band {band}")
    close(tfracs[..., sl], np.asarray(jfracs)[..., sl], msg=f"fracs band {band}")
    assert float(np.abs(np.asarray(jtaug)[..., sl]).max()) > 0.0


@pytest.mark.parametrize("cloud", ["clear", "per_layer", "per_g"])
def test_rtrn_matches(taumol_both, cloud):
    jc, tc, (jtaug, jfracs), (ttaug, tfracs) = taumol_both
    shape = ttaug.shape[:-1]
    rng = np.random.default_rng(3)
    pwvcm = rng.uniform(0.5, 5.0, shape[:-1])
    band_of_g = np.repeat(np.arange(16), P.NGC)
    cf = tau = None
    if cloud == "per_layer":
        cf = np.where(rng.uniform(size=shape) < 0.4, rng.uniform(0.1, 1.0, shape), 0.0)
        tau = rng.gamma(1.0, 2.0, shape + (16,))
    elif cloud == "per_g":
        cf = (rng.uniform(size=shape + (140,)) < 0.3).astype(np.float64)
        tau = rng.gamma(1.0, 2.0, shape + (140,))
    jargs = (jtaug, jfracs, jc.planklay, jc.planklev, jnp.asarray(pwvcm),
             None if cf is None else jnp.asarray(cf), None if tau is None else jnp.asarray(tau),
             jnp.asarray(band_of_g))
    targs = (ttaug, tfracs, tc.planklay, tc.planklev, T(pwvcm),
             None if cf is None else T(cf), None if tau is None else T(tau), T(band_of_g))
    jst = J.rtrn_down(*jargs)
    tst = P.rtrn_down(*targs)
    close_tuple(tst, jst, what="rtrn_down")
    semiss = rng.uniform(0.9, 1.0, 16)
    delwave = P._Static()["delwave"]
    jup = J.rtrn_up(jst, jc.plankbnd, jnp.asarray(semiss), jnp.asarray(band_of_g), delwave)
    tup = P.rtrn_up(tst, tc.plankbnd, T(semiss), T(band_of_g), delwave)
    for name, a, b in zip(("uflx", "dflx", "uflxc", "dflxc"), tup, jup):
        close(a, b, msg=name)
    if cloud == "clear":
        assert tup[2] is tup[0] and tst.dclr_bu is tst.drad_bu


def test_cldprop_lw_matches():
    rng = np.random.default_rng(5)
    shape = (3, 12)
    cf = np.where(rng.uniform(size=shape) < 0.5, rng.uniform(0.0, 1.0, shape), 0.0)
    clwp = np.where(rng.uniform(size=shape) < 0.6, rng.uniform(0, 200, shape), 0.0)
    ciwp = np.where(rng.uniform(size=shape) < 0.6, rng.uniform(0, 60, shape), 0.0)
    rel, rei = rng.uniform(1.0, 70.0, shape), rng.uniform(2.0, 150.0, shape)
    ref = J.cldprop_lw(*map(jnp.asarray, (cf, clwp, ciwp, rel, rei)), J._Static())
    got = P.cldprop_lw(*map(T, (cf, clwp, ciwp, rel, rei)), P._Static())
    close(got, ref, msg="taucloud")
    band_of_g = np.repeat(np.arange(16), P.NGC)
    clwp_g = rng.uniform(0, 100, shape + (140,)) * (rng.uniform(size=shape + (140,)) < 0.5)
    ciwp_g = rng.uniform(0, 30, shape + (140,)) * (rng.uniform(size=shape + (140,)) < 0.5)
    ref = J.cldprop_lw_mcica(jnp.asarray(clwp_g), jnp.asarray(ciwp_g), jnp.asarray(rel),
                             jnp.asarray(rei), J._Static(), jnp.asarray(band_of_g))
    got = P.cldprop_lw_mcica(T(clwp_g), T(ciwp_g), T(rel), T(rei), P._Static(), T(band_of_g))
    close(got, ref, msg="taucloud mcica")


def test_cldprop_lw_positive_and_zero_outside_cloud():
    tau = P.cldprop_lw(T([[0.0, 1.0, 0.5]]), T([[0.0, 50.0, 0.0]]), T([[0.0, 10.0, 30.0]]),
                       torch.full((1, 3), 10.0, dtype=torch.float64),
                       torch.full((1, 3), 50.0, dtype=torch.float64), P._consts(*CPU64)).numpy()
    assert tau.shape == (1, 3, 16)
    assert (tau[0, 0] == 0).all() and (tau[0, 1] > 0).all() and (tau[0, 2] > 0).all()


@pytest.mark.parametrize("case", ["mls", "clouds", "co2_tensor"])
def test_rrtmglw_matches(case):
    args = three_columns() if case != "clouds" else column()
    kw = {}
    if case == "clouds":
        kw = clouds(args[1].shape, frac=0.7)
    jlw, tlw = lw_jax(**GAS), lw_port(**GAS)
    jkw, tkw = {k: jnp.asarray(v) for k, v in kw.items()}, {k: T(v) for k, v in kw.items()}
    if case == "co2_tensor":
        jkw["co2vmr"], tkw["co2vmr"] = jnp.asarray(6.0e-4), T(6.0e-4)
    ref = jax.jit(lambda *a: jlw(*a, **jkw))(*map(jnp.asarray, args))
    got = tlw(*map(T, args), **tkw)
    close_tuple(got, ref, what=case)
    if case == "clouds":
        assert float(np.abs(np.asarray(ref.uflx - ref.uflxc)).max()) > 1.0


def test_mls_golden():
    """tests/goldens/rrtmg_lw_mls.json on the committed tables, at the JAX
    test's own rtol 2e-4."""
    gold = json.loads(GOLDEN.read_text())
    out = lw_port(co2vmr=3.0e-4, n2ovmr=3.2e-7, ch4vmr=1.8e-6)(*map(T, mls_profile()))
    got = {"uflx": out.uflx[0].numpy(), "dflx": out.dflx[0].numpy(), "hr": out.hr[0].numpy()}
    scale = float(np.abs(np.asarray(gold["uflx"])).max())
    for key in ("uflx", "dflx", "hr"):
        np.testing.assert_allclose(got[key], np.asarray(gold[key]), rtol=2e-4,
                                   atol=(1e-6 * scale if key != "hr" else 1e-6), err_msg=key)
    np.testing.assert_allclose(float(out.olr[0]), gold["olr"], rtol=2e-4)


# ---------------------------------------------------------------------------
# physical checks (tests/test_rrtmg_lw.py) on the committed tables
# ---------------------------------------------------------------------------

def test_transparent_limit_matches_surface_planck():
    with np.load(P.KG_NPZ) as d:
        kg_zero = {k: (d[k] if "fracref" in k else np.zeros_like(d[k], dtype=np.float64))
                   for k in d.files if k.startswith("b")}
    out = lw_port(kg=kg_zero)(*map(T, column(ts=295.0)))
    # zero optical depth: OLR = surface emission, no downward flux, no heating
    np.testing.assert_allclose(out.olr.numpy(), SIGMA * 295.0 ** 4, rtol=3e-4)
    assert float(out.dflx.abs().max()) < 1e-8
    assert float(out.hr.abs().max()) < 1e-12
    np.testing.assert_allclose(out.uflxc.numpy(), out.uflx.numpy())


def test_opaque_limit_surface_down_is_local_planck():
    p_half, p_full, t_full, t_half, t_surf, q, o3 = column(ts=300.0)
    q = np.minimum(q * 50.0, 0.2)
    out = lw_port()(*map(T, (p_half, p_full, t_full, t_half, t_surf, q, o3)))
    t_low = float(t_half[0, -1])
    assert abs(float(out.lw_dn_surf[0]) / (SIGMA * t_low ** 4) - 1) < 0.05


def test_fluxes_finite_and_split_phase():
    lw = lw_port(**GAS)
    args = tuple(map(T, column()))
    out = lw(*args)
    for f in (out.uflx, out.dflx, out.hr, out.olr):
        assert bool(torch.isfinite(f).all())
    assert float(out.dflx[..., 0].max()) == 0.0        # TOA down = 0
    assert bool((out.uflx > 0).all())
    p_half, p_full, t_full, t_half, t_surf, q, o3 = args
    dn, stash = lw.down_phase(p_half, p_full, t_full, t_half, q, o3)
    out2 = lw.up_phase(stash, t_surf)
    assert torch.equal(dn, out.dflx) and torch.equal(out2.uflx, out.uflx)


def test_warmer_surface_increases_olr():
    lw = lw_port()
    p_half, p_full, t_full, t_half, t_surf, q, o3 = map(T, column())
    out1 = lw(p_half, p_full, t_full, t_half, t_surf, q, o3)
    out2 = lw(p_half, p_full, t_full, t_half, t_surf + 10.0, q, o3)
    assert bool((out2.olr > out1.olr).all())
    # downward flux must not depend on t_surf (emissivity = 1)
    assert torch.equal(out1.dflx, out2.dflx)


def test_cloud_reduces_olr_and_clear_sky_unchanged():
    lw = lw_port()
    args = tuple(map(T, column()))
    shape = args[1].shape
    clear = lw(*args)
    cloudy = lw(*args, **{k: T(v) for k, v in clouds(shape).items()})
    assert bool((cloudy.olr < clear.olr - 1.0).all())
    assert bool((cloudy.lw_dn_surf > clear.lw_dn_surf).all())
    np.testing.assert_allclose(cloudy.uflxc.numpy(), clear.uflx.numpy(), rtol=1e-10)
    # partial cloud sits between clear and overcast
    half = lw(*args, **{k: T(v) for k, v in clouds(shape, frac=0.5).items()})
    assert bool((cloudy.olr < half.olr).all()) and bool((half.olr < clear.olr).all())


def test_more_co2_warms_less_olr():
    args = tuple(map(T, column()))
    olrs = [float(lw_port(co2vmr=co2)(*args).olr[0]) for co2 in (150e-6, 300e-6, 600e-6)]
    assert olrs[0] > olrs[1] > olrs[2]


def test_synthetic_v4_stratospheric_calibration():
    """tests/test_rrtmg_lw.py's pin of the v4 calibration on a JG17-like
    tropical column: the 30-100 hPa layer a weak net LW absorber, normal
    tropospheric cooling, strong cooling to space in the stratosphere."""
    p_half = np.logspace(np.log10(0.02), np.log10(1013.0), 61) * 100.0
    p_full = np.sqrt(p_half[:-1] * p_half[1:])
    p_hpa = p_full / 100.0
    temp = np.interp(np.log(p_hpa), np.log([0.02, 1.0, 10.0, 50.0, 90.0, 300.0, 1013.0]),
                     [220.0, 265.0, 230.0, 205.0, 197.0, 245.0, 300.0])
    th = np.interp(np.log(p_half / 100.0), np.log(p_hpa), temp)
    th[-1] = 300.0
    es = 610.78 * np.exp(17.27 * (temp - 273.15) / (temp - 35.85))
    q = np.clip(0.75 * 0.622 * es / np.maximum(p_full - es, 1.0), 3e-6, 0.03)
    q[p_full < 300e2] = 3e-6
    x = np.log(p_hpa / 10.0)
    o3 = (9.0e-6 * np.exp(-0.5 * (x / 1.25) ** 2) + 5.0e-8) * 47.9982 / 28.964
    f = lw_port(co2vmr=300e-6)(*map(T, (p_half, p_full, temp, th, 300.0, q, o3)))
    hr = f.hr.numpy() * 86400.0
    assert -0.15 <= hr[(p_hpa > 30) & (p_hpa < 100)].mean() <= 1.5
    assert -3.0 <= hr[p_hpa > 400].mean() <= -1.0
    assert hr[(p_hpa > 1) & (p_hpa < 10)].mean() <= -1.0
    assert 270.0 <= float(f.olr) <= 305.0


# ---------------------------------------------------------------------------
# the RRTM adapter with RRTMG-LW
# ---------------------------------------------------------------------------

def rad_columns(seed=4, shape=(2, 4), L=10):
    """Level-last columns (tests/test_torch_physics.py columns)."""
    rng = np.random.default_rng(seed)
    _, bk = jvc.uneven_sigma(L, 6.0, 0.5, 7.5)
    ps = 1.0e5 + rng.uniform(-2e3, 2e3, shape)
    p_half, _, p_full, _ = (np.asarray(a) for a in jpg.pressure_variables(
        np, np.zeros(L + 1), bk, ps, True))
    t = np.maximum(298.0 * (p_full / 1e5) ** 0.19, 200.0) + rng.uniform(-3, 3, shape + (L,))
    es = 610.78 * np.exp(17.27 * (t - 273.15) / (t - 35.85))
    q = np.minimum(0.9 * 0.622 * es / p_full, 0.02) * rng.uniform(0.6, 1.1, shape + (L,))
    return dict(p_half=p_half, t=t, q=q, lat=np.deg2rad(rng.uniform(-60, 60, shape)),
                lon=np.deg2rad(rng.uniform(0, 360, shape)),
                t_surf=t[..., -1] + rng.uniform(-1, 5, shape))


@pytest.mark.parametrize("kw,co2", [(dict(), None), (dict(), 560.0), (dict(lonstep=2), None),
                                    (dict(do_zm_rad=True, do_zm_tracers=True), 410.0)])
def test_rrtm_radiation_matches(kw, co2):
    c = rad_columns()
    cfg = dict(o3_mmr=1e-6, **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        j = jrr.RRTMRadiation(jrr.RRTMConfig(**cfg))
        t = trr.RRTMRadiation(trr.RRTMConfig(**cfg), device="cpu")
    assert j.lw_rrtmg is not None and t.lw_rrtmg is not None
    albedo = np.full(c["t_surf"].shape, 0.06)
    names = ("lat", "lon", "p_half", "t", "q")
    rkw = dict(gmt=2.8, time_since_ae=1.2, dt_rad_avg=2 * np.pi / 144)
    jco2 = {} if co2 is None else {"carbon_conc": jnp.asarray(co2)}
    tco2 = {} if co2 is None else {"carbon_conc": T(co2)}

    @jax.jit
    def jax_rad(lat, lon, p_half, t, q, albedo, t_surf):
        down = j.down(lat, lon, p_half, t, q, albedo, **rkw, **jco2)
        return down, j.up(down, p_half, t_surf, albedo)

    jd, ju = jax_rad(*(jnp.asarray(c[k]) for k in names), jnp.asarray(albedo),
                     jnp.asarray(c["t_surf"]))
    td = t.down(*(T(c[k]) for k in names), T(albedo), **rkw, **tco2)
    tu = t.up(td, T(c["p_half"]), T(c["t_surf"]), T(albedo))
    close_tuple(td, jd, what="down")
    close_tuple(tu, ju, what="up")
    assert float(np.asarray(jd.surf_lw_down).min()) > 100.0
    assert float(np.asarray(jd.b).max()) == 0.0           # grey fields are zeros
