"""isca_tpu_torch's shallow convection, stable boundary layer
(physics/bl_schemes.py), EDT (physics/edt.py) and entrain
(physics/entrain.py) against isca_tpu.

* mylcl and shallow_conv on tests/test_bl_schemes.py's columns (unstable
  moist, stable dry, saturated parcel; with and without the detrainment
  tapers and Lipps' criterion), stable_bl_turb on its shear columns
  (unstable and stable surface buoyancy, liquid and ice water), EDT and
  entrain on tests/test_entrain_edt.py's convective, cloud-topped and
  stable columns (entrain also with a column whose lifted parcel crosses
  no level, which falls back to level 1, and in its options): every field
  at rtol 1e-10 with atol 1e-10 of each field's largest entry; level
  indices exactly.
* The port held to tests/goldens/bl_goldens.json's `edt` and `entrain`
  entries at tests/test_bl_goldens.py's tolerance (rtol 1e-7, atol 1e-7 x
  the field's largest entry), and to that file's scheme-discriminating
  checks (EDT's cloud-top K peak, entrain's radiative entrainment only in
  the cloud-topped column).
* The physical checks of tests/test_bl_schemes.py and
  tests/test_entrain_edt.py, on the port.
* Float32: within 3x isca_tpu's own float32-versus-float64 difference of
  isca_tpu's float64 result (plus 1e-7 of the field's largest entry).
"""

import json
import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isca_tpu.constants import EARTH
from isca_tpu.physics import bl_schemes as jb
from isca_tpu.physics import edt as je
from isca_tpu.physics import entrain as jn
from isca_tpu.physics import sat_vapor_pres as jsvp
from isca_tpu_torch.physics import bl_schemes as tb
from isca_tpu_torch.physics import edt as te
from isca_tpu_torch.physics import entrain as tn
from isca_tpu_torch.physics import sat_vapor_pres as tsvp

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
from tests.test_bl_schemes import columns  # noqa: E402
from tests.test_entrain_edt import make_columns  # noqa: E402

RTOL = 1e-10
GOLDEN_RTOL = 1e-7          # tests/test_bl_goldens.py RTOL
EDT_KEYS = ("tdtlw", "u_star", "b_star", "t", "qv", "ql", "qi", "qa", "u", "v",
            "z_full", "p_full", "z_half", "p_half")


def T(a, dtype=torch.float64):
    return torch.tensor(np.array(a, np.float64)).to(dtype)


def close(got, ref, rtol=RTOL, what=""):
    ref = np.asarray(ref, np.float64)
    got = got.detach().cpu().numpy().astype(np.float64)
    scale = float(np.abs(ref).max(initial=0.0))
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * scale, err_msg=what)


def close_result(got, ref, rtol=RTOL):
    for name in ref._fields:
        close(getattr(got, name), getattr(ref, name), rtol, name)


def svps():
    return (jsvp.SatVaporPres(constants=EARTH, do_simple=True),
            tsvp.SatVaporPres(do_simple=True))


def conv_columns():
    """columns()'s unstable moist profile, a stable dry one and one whose
    surface parcel is saturated."""
    a = columns(lapse=9.8e-3, rh=0.85, ncol=1)
    b = columns(lapse=3.0e-3, rh=0.3, ncol=1)
    t, q, pf, ph, zf, zh, svp = columns(lapse=9.8e-3, rh=0.85, ncol=1)
    q = np.asarray(q).copy()
    q[0, -1] = float(svp.qs(t[0, -1], pf[0, -1]))
    cat = lambda i, extra: np.concatenate([np.asarray(a[i]), np.asarray(b[i]), extra])
    return (cat(0, np.asarray(t)), cat(1, q), cat(2, np.asarray(pf)), cat(3, np.asarray(ph)))


# ---------------------------------------------------------------------------
# shallow convection and the stable boundary layer against isca_tpu
# ---------------------------------------------------------------------------

def test_mylcl_matches():
    t, q, pf, ph = conv_columns()
    jsv, tsv = svps()
    args = (t[..., -1], q[..., -1], pf[..., -1], ph)
    jp, jk = jb.mylcl(jb.ShallowConvConfig(), jsv, *map(jnp.asarray, args))
    tp, tk = tb.mylcl(tb.ShallowConvConfig(), tsv, *map(T, args))
    close(tp, jp)
    assert np.array_equal(tk.numpy(), np.asarray(jk))


@pytest.mark.parametrize("kw", [{}, dict(ldetran=False), dict(lipps=True, kctop=5),
                                dict(theqvcr=0.5, pshalow=600.0e2, akhsc0=3.7)])
def test_shallow_conv_matches(kw):
    t, q, pf, ph = conv_columns()
    jsv, tsv = svps()
    ja, jp = jb.shallow_conv(jb.ShallowConvConfig(**kw), jsv, *map(jnp.asarray, (t, q, pf, ph)))
    ta, tp = tb.shallow_conv(tb.ShallowConvConfig(**kw), tsv, *map(T, (t, q, pf, ph)))
    assert float(np.asarray(ja).max()) > 0.0
    close(ta, ja, what="akhsc")
    close(tp, jp, what="plcl")


def sbl_inputs(b_star=(-0.01, 0.02, -0.003)):
    t, q, pf, ph, zf, zh, _ = columns(lapse=9.8e-3, rh=0.3)
    ncol, L = t.shape
    rng = np.random.default_rng(9)
    u = 10.0 * (1.0 - np.linspace(0, 1, L))[None, :] * np.ones((ncol, 1))
    v = rng.normal(0.0, 1.0, (ncol, L))
    ql = np.abs(rng.normal(0.0, 1e-4, (ncol, L)))
    qi = np.abs(rng.normal(0.0, 5e-5, (ncol, L)))
    lat = np.deg2rad([30.0, -0.5, 60.0])
    return (lat, t, q, u, v, zf, zh, np.array([0.3, 0.1, 0.5]), np.asarray(b_star)), (ql, qi)


@pytest.mark.parametrize("with_water", [False, True])
def test_stable_bl_matches(with_water):
    args, (ql, qi) = sbl_inputs()
    kw = dict(ql=ql, qi=qi) if with_water else {}
    ref = jb.stable_bl_turb(jb.StableBLConfig(), *map(jnp.asarray, args),
                            **{k: jnp.asarray(v) for k, v in kw.items()})
    got = tb.stable_bl_turb(tb.StableBLConfig(), *map(T, args),
                            **{k: T(v) for k, v in kw.items()})
    assert float(np.asarray(ref.akm).max()) > 0.0
    close_result(got, ref)


# ---------------------------------------------------------------------------
# EDT and entrain against isca_tpu
# ---------------------------------------------------------------------------

def edt_columns(extra_parcel_column=False):
    c = make_columns()
    kcld = c.pop("kcld")
    c = {k: np.asarray(v) for k, v in c.items()}
    if extra_parcel_column:
        # a fourth column: unstable surface (b_star > 0) under a
        # superadiabatic column (12.5 K/km) whose static energy falls with
        # height, so that the lifted parcel exceeds every level in [1, L-2]
        c = {k: np.concatenate([v, v[:1]]) for k, v in c.items()}
        c["t"][3] = 300.0 - 0.0125 * (c["z_full"][3] - c["z_half"][3, -1])
        c["b_star"][3] = 0.001
    return c, kcld


def test_edt_matches():
    c, _ = edt_columns(True)
    ref = je.edt(je.EDTConfig(), *(jnp.asarray(c[k]) for k in EDT_KEYS))
    got = te.edt(te.EDTConfig(), *(T(c[k]) for k in EDT_KEYS))
    close_result(got, ref)


def entrain_call(pkg, cfg, c, conv, arr):
    z = arr(np.zeros_like(c["t"]))
    return pkg.entrain(cfg, arr(c["tdtlw"]), conv, *(arr(c[k]) for k in EDT_KEYS[1:]),
                       z + 0.5, z + 0.7)


@pytest.mark.parametrize("kw", [{}, dict(parcel_option=2, do_jump_exit=False,
                                         convect_shutoff=True),
                                dict(apply_entrain=False, critjump=0.05, frac_inner=0.2)])
def test_entrain_matches(kw):
    c, _ = edt_columns(True)
    convect = np.array([True, False, True, False])
    ref = entrain_call(jn, jn.EntrainConfig(**kw), c, jnp.asarray(convect), jnp.asarray)
    got = entrain_call(tn, tn.EntrainConfig(**kw), c, torch.as_tensor(convect), T)
    close_result(got, ref)
    if not kw:
        assert float(np.asarray(ref.wentr_rad)[1]) > 0.0


def test_entrain_no_parcel_crossing_falls_back():
    """The fourth column's lifted parcel crosses no level in [1, L-2]: both
    packages take level 1, and the port's gathers stay in range."""
    c, _ = edt_columns(True)
    got = entrain_call(tn, tn.EntrainConfig(), c, torch.zeros(4, dtype=torch.bool), T)
    ref = entrain_call(jn, jn.EntrainConfig(), c, jnp.zeros(4, bool), jnp.asarray)
    close_result(got, ref)
    # the parcel test of pbl_depth (entrain.py:139) finds nothing in column 3
    C = EARTH
    t, zf = c["t"][3], c["z_full"][3] - c["z_half"][3, -1]
    tcp = (C.cp_air * t + C.grav * zf) * (1.0 + C.zvir * c["qv"][3]) / C.cp_air
    assert not np.any(tcp[1:-1] > tcp[-1])
    assert float(got.zsml[3]) > 0.0 and bool(torch.isfinite(got.k_t[3]).all())


def test_goldens_and_discriminating_checks():
    with open(REPO / "tests" / "goldens" / "bl_goldens.json") as f:
        goldens = json.load(f)
    c, kcld = edt_columns()
    edt_res = te.edt(te.EDTConfig(), *(T(c[k]) for k in EDT_KEYS))
    z = torch.zeros_like(T(c["t"]))
    en_res = tn.entrain(tn.EntrainConfig(), T(c["tdtlw"]), torch.zeros(3, dtype=torch.bool),
                        *(T(c[k]) for k in EDT_KEYS[1:]), z, z)
    for name, res in (("edt", edt_res), ("entrain", en_res)):
        for key, want in goldens[name].items():
            want = np.asarray(want)
            np.testing.assert_allclose(getattr(res, key).numpy(), want, rtol=GOLDEN_RTOL,
                                       atol=GOLDEN_RTOL * max(1.0, float(np.abs(want).max())),
                                       err_msg=f"{name}.{key}")
    # EDT: the cloud-topped column's K_t peaks at the stratocumulus top
    kt = edt_res.k_t.numpy()
    near_top = kt[1, max(kcld - 1, 0): kcld + 2].max()
    interior = kt[1, : max(kcld - 3, 1)].max()
    assert near_top > 10.0 * max(interior, 1e-12)
    assert kt[0, kcld + 1:].max() > kt[0, : kcld - 2].max()
    # entrain: radiative entrainment only in the cloud-topped column
    w = en_res.wentr_rad.numpy()
    assert w[1] > 0.0 and w[0] == 0.0 and w[2] == 0.0


def test_float32_within_three_times_isca_tpus_gap():
    c, _ = edt_columns(True)
    j64 = je.edt(je.EDTConfig(), *(jnp.asarray(c[k]) for k in EDT_KEYS))
    j32 = je.edt(je.EDTConfig(), *(jnp.asarray(c[k], jnp.float32) for k in EDT_KEYS))
    t32 = te.edt(te.EDTConfig(), *(T(c[k], torch.float32) for k in EDT_KEYS))
    n64 = entrain_call(jn, jn.EntrainConfig(), c, jnp.zeros(4, bool), jnp.asarray)
    n32 = entrain_call(jn, jn.EntrainConfig(), c, jnp.zeros(4, bool),
                       lambda a: jnp.asarray(a, jnp.float32))
    nt32 = entrain_call(tn, tn.EntrainConfig(), c, torch.zeros(4, dtype=torch.bool),
                        lambda a: T(a, torch.float32))
    args, _ = sbl_inputs()
    s64 = jb.stable_bl_turb(jb.StableBLConfig(), *map(jnp.asarray, args))
    s32 = jb.stable_bl_turb(jb.StableBLConfig(), *(jnp.asarray(a, jnp.float32) for a in args))
    st32 = tb.stable_bl_turb(tb.StableBLConfig(), *(T(a, torch.float32) for a in args))
    assert t32.k_t.dtype == nt32.k_t.dtype == st32.akm.dtype == torch.float32
    for got, r32, r64 in ((t32, j32, j64), (nt32, n32, n64), (st32, s32, s64)):
        for name in r64._fields:
            want = np.asarray(getattr(r64, name), np.float64)
            gap = float(np.abs(np.asarray(getattr(r32, name), np.float64) - want).max())
            err = float(np.abs(getattr(got, name).numpy().astype(np.float64) - want).max())
            assert err <= 3.0 * gap + 1e-7 * float(np.abs(want).max()), (name, err, gap)


# ---------------------------------------------------------------------------
# the physical checks of tests/test_bl_schemes.py and test_entrain_edt.py
# ---------------------------------------------------------------------------

def port_columns(**kw):
    t, q, pf, ph, zf, zh, _ = columns(**kw)
    return tuple(map(T, (t, q, pf, ph, zf, zh)))


def test_lcl_below_parcel_above_shalow():
    t, q, pf, ph, zf, zh = port_columns()
    cfg = tb.ShallowConvConfig()
    p, _ = tb.mylcl(cfg, svps()[1], t[..., -1], q[..., -1], pf[..., -1], ph)
    assert bool((p <= pf[..., -1] + 1e-6).all()) and bool((p >= cfg.pshalow - 1e-6).all())
    assert bool((p > 8.0e4).all())


def test_saturated_parcel_lcl_at_parcel():
    t, q, pf, ph, zf, zh = port_columns()
    svp = svps()[1]
    p, _ = tb.mylcl(tb.ShallowConvConfig(), svp, t[..., -1], svp.qs(t[..., -1], pf[..., -1]),
                    pf[..., -1], ph)
    np.testing.assert_allclose(p.numpy(), pf[..., -1].numpy(), rtol=0.02)


def test_unstable_moist_column_gets_mixing():
    t, q, pf, ph, zf, zh = port_columns(lapse=9.8e-3, rh=0.85)
    cfg = tb.ShallowConvConfig()
    a = tb.shallow_conv(cfg, svps()[1], t, q, pf, ph)[0].numpy()
    assert np.all(np.isfinite(a)) and 0.0 < a.max() <= cfg.akhsc0 + 1e-9
    above = pf.numpy() <= cfg.pshalow
    assert np.all(np.where(above[..., :-1], a[..., 1:], 0.0) == 0.0)


def test_stable_column_no_mixing():
    t, q, pf, ph, zf, zh = port_columns(lapse=3.0e-3, rh=0.3)
    a = tb.shallow_conv(tb.ShallowConvConfig(), svps()[1], t, q, pf, ph)[0]
    assert float(a.abs().max()) <= 1e-12


def sbl(lapse, u0=10.0, bstar=-0.01, q=None):
    t, q_, pf, ph, zf, zh = port_columns(lapse=lapse, rh=0.3)
    ncol, L = t.shape
    u = u0 * (1.0 - T(np.linspace(0, 1, L)))[None, :] * torch.ones((ncol, 1), dtype=torch.float64)
    lat = T(np.deg2rad([30.0, 45.0, 60.0]))
    f = lambda x: torch.full((ncol,), x, dtype=torch.float64)
    return tb.stable_bl_turb(tb.StableBLConfig(), lat, t, q_ if q is None else q(t), u,
                             torch.zeros_like(u), zf, zh, f(0.3), f(bstar)), lat


def test_shear_layer_mixes():
    res, _ = sbl(9.8e-3)
    akm = res.akm.numpy()
    assert np.all(np.isfinite(akm)) and 0.1 < akm.max() <= tb.StableBLConfig().akmax


def test_strong_stability_kills_mixing():
    active, _ = sbl(9.8e-3)
    stable, _ = sbl(-3.0e-3, u0=0.5, bstar=0.01, q=lambda t: torch.full_like(t, 1.0e-4))
    assert float(stable.akm.sum()) < 0.01 * float(active.akm.sum()) + 1e-6


def test_pbl_height_from_ustar():
    cfg = tb.StableBLConfig()
    res, lat = sbl(9.8e-3)
    f = 2.0 * EARTH.omega * np.abs(np.sin(lat.numpy()))
    np.testing.assert_allclose(res.z_sbl.numpy(),
                               np.minimum(cfg.alpha * 0.3 / np.maximum(f, cfg.fmin), cfg.hpbl_cap),
                               rtol=1e-6)


def test_entrain_mixed_layer_detection():
    c, _ = edt_columns()
    z = torch.zeros_like(T(c["t"]))
    res = tn.entrain(tn.EntrainConfig(), T(c["tdtlw"]), torch.zeros(3, dtype=torch.bool),
                     *(T(c[k]) for k in EDT_KEYS[1:]), z, z)
    zsml = res.zsml.numpy()
    assert 500 < zsml[0] < 1500 and zsml[2] == 0.0
    assert 500 < float(res.zradtop[1]) < 1200
    assert float(res.wentr_rad[1]) > 0 and float(res.wentr_rad[0]) == 0.0
    assert bool(torch.isfinite(res.k_t).all()) and bool((res.k_t >= 0).all())
    assert 0 < float(res.wentr_pbl[0]) <= tn.EntrainConfig().wentrmax


def test_entrain_stable_column_keeps_input_k():
    c, _ = edt_columns()
    z = torch.zeros_like(T(c["t"]))
    base = torch.full_like(z, 1.23)
    args = {k: T(c[k]) for k in EDT_KEYS}
    args.update(ql=z, qa=z, tdtlw=z)
    res = tn.entrain(tn.EntrainConfig(), args["tdtlw"], torch.zeros(3, dtype=torch.bool),
                     *(args[k] for k in EDT_KEYS[1:]), base, base)
    np.testing.assert_allclose(res.k_t[2].numpy(), 1.23)


def test_galperin_limits():
    gh, sh, sm = te.galperin(T([-1.0, 0.0, 0.163, 10.0]))
    g = gh.numpy()
    assert (g >= -0.28 - 1e-12).all() and (g <= 0.0233 + 1e-12).all()
    assert (sh.numpy() > 0).all() and (sm.numpy() > 0).all()
    assert float(sh[0]) > float(sh[2])


def test_edt_convective_and_stable_columns():
    c, _ = edt_columns()
    res = te.edt(te.EDTConfig(), *(T(c[k]) for k in EDT_KEYS))
    kt, tke = res.k_t.numpy(), res.tke.numpy()
    assert np.isfinite(kt).all() and (kt >= 0).all() and kt[0].max() > 10.0
    assert tke[1].max() > tke[0].max()
    assert 300 < float(res.pblh[0]) < 3000
    assert (tke <= 20.0 + 1e-6).all() and (tke >= 0).all()
