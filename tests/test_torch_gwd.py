"""isca_tpu_torch's gravity-wave drags, the damping driver's drag branches
and mo_profile against isca_tpu.

* mg_drag (physics/gravity_wave_drag.py) on tests/test_gravity_wave_drag.py's
  columns with a meridional wind added, in its options (energy-conserving
  heating, a flux cut level), every field at rtol 1e-10 with atol 1e-10 of
  each field's largest entry.
* CgDrag: the source tables (levels exactly, amplitudes rtol 1e-12) and the
  forcing and eddy diffusivity at rtol 1e-10 (atol as above), with the
  defaults and with two wavelengths, flag 0 and a narrow spectrum, on a
  batch of latitudes; MoistPhysics.init_cg_drag builds the same tables.
* The damping driver with do_mg_drag and do_cg_drag (and the sponge): its
  tendencies and diagnostics at rtol 1e-12.
* mo_profile in both stabilities and the neutral option, rtol 1e-12.
* The physical checks of tests/test_gravity_wave_drag.py, on the port.
* Float32: the port's float32 drags within 3x isca_tpu's own
  float32-versus-float64 difference of isca_tpu's float64 result (plus
  1e-7 of the field's largest entry, for a field isca_tpu's float32 run
  gets exactly).
"""

import dataclasses
import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isca_tpu.physics import damping_driver as jdd
from isca_tpu.physics import gravity_wave_drag as jg
from isca_tpu.physics import monin_obukhov as jmo
from isca_tpu_torch.physics import damping_driver as tdd
from isca_tpu_torch.physics import gravity_wave_drag as tg
from isca_tpu_torch.physics import moist_driver as tmd
from isca_tpu_torch.physics import monin_obukhov as tmo

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
from tests.test_gravity_wave_drag import TestCgDrag, make_atmosphere  # noqa: E402

RTOL = 1e-10


def T(a, dtype=torch.float64):
    return torch.tensor(np.array(a, np.float64)).to(dtype)


def close(got, ref, rtol=RTOL, what=""):
    ref = np.asarray(ref, np.float64)
    got = got.detach().cpu().numpy().astype(np.float64) if torch.is_tensor(got) else got
    scale = float(np.abs(ref).max(initial=0.0))
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * scale, err_msg=what)


def close_result(got, ref, rtol=RTOL):
    for name in ref._fields:
        close(getattr(got, name), getattr(ref, name), rtol, name)


def mg_inputs(u0=20.0, shear=False, hp=400.0):
    u, v, t, pf, ph, zf, zh = make_atmosphere(u0=u0, shear=shear)
    v = v + 0.2 * u
    hprime = jnp.full(u.shape[:-1], hp).at[1].set(0.0)      # one flat column
    return u, v, t, pf, ph, zf, zh, hprime


def cg_inputs():
    cg, pf, zf, t, u, v = TestCgDrag().make(L=40, ncol=3)
    v = v + 0.5 * u[:, ::-1]
    return pf, zf, t, u, v


# ---------------------------------------------------------------------------
# against isca_tpu
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [{}, dict(do_conserve_energy=True),
                                dict(flux_cut_level=300.0, gmax=1.5)])
def test_mg_drag_matches(kw):
    args = mg_inputs()
    ref = jg.mg_drag(jg.MgDragConfig(**kw), 600.0, *args)
    got = tg.mg_drag(tg.MgDragConfig(**kw), 600.0, *map(T, args))
    assert float(np.abs(np.asarray(ref.dt_u)).max()) > 0.0
    close_result(got, ref)


@pytest.mark.parametrize("kw", [{}, dict(nk=2, flag=0, Bn=0.1, Bt_nh=0.002)])
def test_cg_drag_matches(kw):
    pf, zf, t, u, v = cg_inputs()
    lat = np.deg2rad(np.array([-45.0, 0.0, 45.0]))
    pref = np.asarray(pf[0])
    jc = jg.CgDrag(jg.CgDragConfig(**kw), jnp.asarray(lat), pref)
    tc = tg.CgDrag(tg.CgDragConfig(**kw), T(lat), pref)
    assert np.array_equal(tc.source_level.numpy(), np.asarray(jc.source_level))
    close(tc.source_amp, jc.source_amp, 1e-12, "source_amp")
    close(tc.c0, jc.c0, 1e-12, "c0")
    close(tc.kwv, jc.kwv, 1e-12, "kwv")
    ref = jc(pf, zf, t, u, v)
    got = tc(*map(T, (pf, zf, t, u, v)))
    assert float(np.abs(np.asarray(ref.gwfcng_x)).max()) > 0.0
    close_result(got, ref)


def test_init_cg_drag_tables_match():
    lats = np.deg2rad(np.array([-60.0, -10.0, 30.0]))
    lons = np.deg2rad(np.array([0.0, 120.0, 240.0, 300.0]))
    pref = np.linspace(50.0, 1.0e5, 31)[1:] - 1.0e3
    phys = tmd.MoistPhysics(tmd.MoistPhysicsConfig(), T(lats), T(lons))
    phys.init_cg_drag(pref)
    jc = jg.CgDrag(jg.CgDragConfig(), jnp.asarray(lats[:, None] * np.ones(4)), pref)
    assert phys.cg_drag.source_level.shape == (3, 4)
    assert np.array_equal(phys.cg_drag.source_level.numpy(), np.asarray(jc.source_level))
    close(phys.cg_drag.source_amp, jc.source_amp, 1e-12)
    close(phys.hprime, np.zeros((3, 4)), 0.0)


def test_damping_driver_drags_match():
    u, v, t, pf, ph, zf, zh, hprime = mg_inputs()
    lat = np.deg2rad(np.array([-30.0, 5.0, 20.0, 50.0]))
    jcfg = jdd.DampingDriverConfig(do_mg_drag=True, do_cg_drag=True, sponge_pbottom=500.0,
                                   mg=jg.MgDragConfig(do_conserve_energy=True))
    tcfg = tdd.DampingDriverConfig(do_mg_drag=True, do_cg_drag=True, sponge_pbottom=500.0,
                                   mg=tg.MgDragConfig(do_conserve_energy=True))
    pref = np.asarray(pf[0])
    rng = np.random.default_rng(3)
    dts = [rng.normal(0.0, 1e-5, u.shape) for _ in range(3)]
    ref = jdd.damping_driver(jcfg, 1440.0, pf, u, v, *map(jnp.asarray, dts), temp=t,
                             p_half=ph, z_full=zf, z_half=zh, hprime=hprime,
                             cg=jg.CgDrag(jcfg.cg, jnp.asarray(lat), pref))
    got = tdd.damping_driver(tcfg, 1440.0, T(pf), T(u), T(v), *map(T, dts), temp=T(t),
                             p_half=T(ph), z_full=T(zf), z_half=T(zh), hprime=T(hprime),
                             cg=tg.CgDrag(tcfg.cg, T(lat), pref))
    for name in ("dt_u", "dt_v", "dt_t"):
        close(getattr(got, name), getattr(ref, name), 1e-12, name)
    assert set(got.diagnostics) == set(ref.diagnostics) == {
        "udt_rdamp", "udt_gwd", "vdt_gwd", "taubx", "tauby", "gwfu_cgwd", "gwfv_cgwd"}
    for k in ref.diagnostics:
        close(got.diagnostics[k], ref.diagnostics[k], 1e-12, k)


@pytest.mark.parametrize("b_star,neutral", [(0.02, False), (-0.01, False), (0.02, True)])
def test_mo_profile_matches(b_star, neutral):
    rng = np.random.default_rng(11)
    n = 7
    z = rng.uniform(20.0, 80.0, n)
    z0, zt, zq = (rng.uniform(1e-4, 0.1, n) for _ in range(3))
    u_star = rng.uniform(0.05, 0.6, n)
    u_star[0] = 0.0                         # the u* = 0 guard
    bs = np.full(n, b_star)
    ref = jmo.mo_profile(jmo.MOConfig(neutral=neutral), 10.0, 2.0,
                         *map(jnp.asarray, (z, z0, zt, zq, u_star, bs)))
    got = tmo.mo_profile(tmo.MOConfig(neutral=neutral), 10.0, 2.0,
                         *map(T, (z, z0, zt, zq, u_star, bs)))
    for name, a, b in zip(("del_m", "del_t", "del_q"), got, ref):
        close(a, b, 1e-12, name)


def test_topo_drag_still_raises():
    x = torch.zeros(2, 5, dtype=torch.float64)
    with pytest.raises(NotImplementedError):
        tdd.damping_driver(tdd.DampingDriverConfig(do_topo_drag=True), 1.0, x, x, x, x, x, x)


def test_float32_within_three_times_isca_tpus_gap():
    """The port's float32 drags against isca_tpu's float64 ones: within 3x
    isca_tpu's own float32-versus-float64 difference, field by field."""
    args = mg_inputs()
    ref64 = jg.mg_drag(jg.MgDragConfig(do_conserve_energy=True), 600.0, *args)
    ref32 = jg.mg_drag(jg.MgDragConfig(do_conserve_energy=True), 600.0,
                       *(jnp.asarray(a, jnp.float32) for a in args))
    got = tg.mg_drag(tg.MgDragConfig(do_conserve_energy=True), 600.0,
                     *(T(a, torch.float32) for a in args))
    pf, zf, t, u, v = cg_inputs()
    lat = np.deg2rad(np.array([-45.0, 0.0, 45.0]))
    pref = np.asarray(pf[0])
    cg64 = jg.CgDrag(jg.CgDragConfig(), jnp.asarray(lat), pref)(pf, zf, t, u, v)
    cg32 = jg.CgDrag(jg.CgDragConfig(), jnp.asarray(lat, jnp.float32), pref)(
        *(jnp.asarray(a, jnp.float32) for a in (pf, zf, t, u, v)))
    cgt = tg.CgDrag(tg.CgDragConfig(), T(lat, torch.float32), pref)(
        *(T(a, torch.float32) for a in (pf, zf, t, u, v)))
    assert got.dt_u.dtype == torch.float32 and cgt.gwfcng_x.dtype == torch.float32
    for g, r32, r64 in ((got, ref32, ref64), (cgt, cg32, cg64)):
        for name in r64._fields:
            want = np.asarray(getattr(r64, name), np.float64)
            gap = float(np.abs(np.asarray(getattr(r32, name), np.float64) - want).max())
            err = float(np.abs(getattr(g, name).numpy().astype(np.float64) - want).max())
            scale = float(np.abs(want).max(initial=0.0))
            assert err <= 3.0 * gap + 1e-7 * scale, (name, err, gap)


# ---------------------------------------------------------------------------
# the physical checks of tests/test_gravity_wave_drag.py
# ---------------------------------------------------------------------------

def port_atmosphere(**kw):
    return tuple(map(T, make_atmosphere(**kw)))


def test_mg_drag_decelerates_low_level_flow():
    u, v, t, pf, ph, zf, zh = port_atmosphere(shear=False)
    res = tg.mg_drag(tg.MgDragConfig(), 600.0, u, v, t, pf, ph, zf, zh,
                     torch.full(u.shape[:-1], 400.0, dtype=torch.float64))
    assert bool(torch.isfinite(res.dt_u).all())
    assert float(res.taubx[0]) < 0.0
    net = torch.sum(res.dt_u * (ph[..., 1:] - ph[..., :-1]), dim=-1)
    assert bool((net < 0.0).all())


def test_mg_drag_flat_terrain_no_drag():
    u, v, t, pf, ph, zf, zh = port_atmosphere()
    res = tg.mg_drag(tg.MgDragConfig(), 600.0, u, v, t, pf, ph, zf, zh,
                     torch.zeros(u.shape[:-1], dtype=torch.float64))
    assert float(res.dt_u.abs().max()) <= 1e-12 and float(res.taubx.abs().max()) <= 1e-12


def test_mg_drag_momentum_flux_profile_monotone():
    u, v, t, pf, ph, zf, zh = port_atmosphere(u0=15.0, shear=False)
    res = tg.mg_drag(tg.MgDragConfig(), 600.0, u, v, t, pf, ph, zf, zh,
                     torch.full(u.shape[:-1], 700.0, dtype=torch.float64))
    assert bool((res.dt_u <= 1e-14).all())


def test_mg_drag_energy_conservation_heating():
    u, v, t, pf, ph, zf, zh = port_atmosphere(shear=False)
    res = tg.mg_drag(tg.MgDragConfig(do_conserve_energy=True), 600.0, u, v, t, pf, ph, zf, zh,
                     torch.full(u.shape[:-1], 500.0, dtype=torch.float64))
    assert float(res.dt_t.sum()) > 0.0


def port_cg(cfg=tg.CgDragConfig(), lat=None):
    _, pf, zf, t, u, v = TestCgDrag().make()
    lat = np.deg2rad(np.array([-45.0, 0.0, 45.0])) if lat is None else lat
    return tg.CgDrag(cfg, T(lat), np.asarray(pf[0])), *map(T, (pf, zf, t, u, v))


def test_cg_source_tables():
    cg, *_ = port_cg()
    sl, amp = cg.source_level.numpy(), cg.source_amp.numpy()
    assert sl[0] > sl[1] - 1e-9 or sl[2] > sl[1] - 1e-9
    assert amp[2] > amp[1] > amp[0]


def test_cg_forcing_finite_and_above_source_only():
    cg, pf, zf, t, u, v = port_cg()
    gx = cg(pf, zf, t, u, v).gwfcng_x.numpy()
    assert np.all(np.isfinite(gx)) and np.any(gx != 0.0)
    for i, s in enumerate(cg.source_level.numpy()):
        assert np.allclose(gx[i, s:], 0.0, atol=1e-14)


def test_cg_momentum_deposition_scales_with_source_amp():
    cfg0 = tg.CgDragConfig()
    g1 = port_cg(dataclasses.replace(cfg0, Bt_0=0.004, Bt_nh=0.0, Bt_sh=0.0), np.zeros(3))
    g2 = port_cg(dataclasses.replace(cfg0, Bt_0=0.008, Bt_nh=0.0, Bt_sh=0.0), np.zeros(3))
    a1, a2 = g1[0](*g1[1:]).gwfcng_x.numpy(), g2[0](*g2[1:]).gwfcng_x.numpy()
    np.testing.assert_allclose(a2, 2.0 * a1, rtol=1e-6, atol=1e-18)


def test_cg_no_wind_antisymmetry():
    cg, pf, zf, t, u, v = port_cg(tg.CgDragConfig(Bt_nh=0.0, Bt_sh=0.0), np.zeros(3))
    g_pos = cg(pf, zf, t, u, v).gwfcng_x.numpy()
    g_neg = cg(pf, zf, t, -u, v).gwfcng_x.numpy()
    np.testing.assert_allclose(g_neg, -g_pos, rtol=1e-6, atol=1e-18)
