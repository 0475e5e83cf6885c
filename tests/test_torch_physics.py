"""isca_tpu_torch column physics against isca_tpu: convection, condensation,
surface layer and fluxes, diffusivity, vertical diffusion, mixed layer, the
RRTM radiation adapter and the moist physics driver.

Inputs are made with numpy from a seed (2 x 4 columns, 8 levels) and go
through both packages at float64 on the CPU. Tolerance rtol 1e-10 unless a
test says otherwise: the same float64 arithmetic, reassociated only in sums
and in the last bits of libm functions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isca_tpu.constants import EARTH
from isca_tpu.dycore import press_geopot as jpg
from isca_tpu.dycore import vert_coordinate as jvc
from isca_tpu.physics import diffusivity as jdf
from isca_tpu.physics import lscale_cond as jlc
from isca_tpu.physics import mixed_layer as jml
from isca_tpu.physics import moist_driver as jmd
from isca_tpu.physics import monin_obukhov as jmo
from isca_tpu.physics import qe_moist_convection as jqe
from isca_tpu.physics import rrtm_radiation as jrr
from isca_tpu.physics import sat_vapor_pres as jsvp
from isca_tpu.physics import surface_flux as jsf
from isca_tpu.physics import vert_diff as jvd
from isca_tpu_torch.physics import damping_driver as tdd
from isca_tpu_torch.physics import diffusivity as tdf
from isca_tpu_torch.physics import lscale_cond as tlc
from isca_tpu_torch.physics import mixed_layer as tml
from isca_tpu_torch.physics import moist_driver as tmd
from isca_tpu_torch.physics import monin_obukhov as tmo
from isca_tpu_torch.physics import qe_moist_convection as tqe
from isca_tpu_torch.physics import rrtm_radiation as trr
from isca_tpu_torch.physics import sat_vapor_pres as tsvp
from isca_tpu_torch.physics import surface_flux as tsf
from isca_tpu_torch.physics import vert_diff as tvd

RTOL = 1e-10


def T(a):
    return torch.as_tensor(np.array(a))


def J(a):
    return jnp.asarray(np.array(a))


def close(port, ref, rtol=RTOL, atol=0.0, msg=""):
    port = port.detach().cpu().numpy() if torch.is_tensor(port) else np.asarray(port)
    np.testing.assert_allclose(port, np.asarray(ref), rtol=rtol, atol=atol, err_msg=msg)


def close_tuple(port, ref, rtol=RTOL, atol_frac=0.0, atol=None):
    """Every field of two NamedTuples; atol_frac scales an absolute tolerance
    by each field's largest magnitude (for fields that cancel); `atol` gives
    some fields an absolute tolerance of their own."""
    atol = atol or {}
    for name in ref._fields:
        b = np.asarray(getattr(ref, name))
        close(getattr(port, name), b, rtol=rtol,
              atol=atol.get(name, atol_frac * float(np.abs(b).max(initial=0.0))), msg=name)


def columns(seed=0, shape=(2, 4), L=8):
    """Level-last test columns: a lapse-rate T profile with noise, humidity
    near saturation at the bottom, winds, hydrostatic heights."""
    rng = np.random.default_rng(seed)
    _, bk = jvc.uneven_sigma(L, 6.0, 0.5, 7.5)
    ps = 1.0e5 + rng.uniform(-2e3, 2e3, shape)
    p_half, ln_ph, p_full, ln_pf = (np.asarray(a) for a in jpg.pressure_variables(
        np, np.zeros(L + 1), bk, ps, True))
    t = np.maximum(298.0 * (p_full / 1e5) ** 0.19, 200.0) + rng.uniform(-3, 3, shape + (L,))
    es = 610.78 * np.exp(17.27 * (t - 273.15) / (t - 35.85))
    q = np.minimum(0.9 * 0.622 * es / p_full, 0.02) * rng.uniform(0.6, 1.1, shape + (L,))
    gf, gh = jpg.compute_geopotential(np, EARTH.rdgas, t, ln_ph, ln_pf,
                                      np.zeros(shape), True, p_half=p_half)
    return dict(p_half=p_half, p_full=p_full, t=t, q=q,
                u=rng.normal(0, 8, shape + (L,)), v=rng.normal(0, 8, shape + (L,)),
                z_full=np.asarray(gf) / EARTH.grav, z_half=np.asarray(gh) / EARTH.grav,
                lat=np.deg2rad(rng.uniform(-60, 60, shape)),
                lon=np.deg2rad(rng.uniform(0, 360, shape)),
                t_surf=t[..., -1] + rng.uniform(-1, 5, shape))


# ---------------------------------------------------------------------------
# convection, condensation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_qe_moist_convection_matches(seed):
    c = columns(seed, shape=(4, 6))
    j = jqe.QEMoistConvection(jqe.QEMoistConvectionConfig(), jsvp.SatVaporPres(do_simple=True))
    t = tqe.QEMoistConvection(tqe.QEMoistConvectionConfig(), tsvp.SatVaporPres(do_simple=True))
    args = ("t", "q", "p_full", "p_half")
    ref = jax.jit(lambda *a: j(1200.0, *a))(*(J(c[k]) for k in args))
    out = t(1200.0, *(T(c[k]) for k in args))
    flags = np.asarray(ref.convflag)
    assert (flags == 2).any() and (flags < 2).any()   # deep and non-deep columns
    # CIN sums R (Tv_env - Tv_parcel) dlnp over levels where the two nearly
    # cancel; where it is ~0 its rounding noise is ~1e-12 J/kg
    close_tuple(out, ref, atol_frac=1e-12, atol={"cin": 1e-9})


@pytest.mark.parametrize("do_evap", [False, True])
def test_lscale_cond_matches(do_evap):
    c = columns(2)
    q = c["q"] * 1.3                                   # supersaturate some levels
    svp = dict(do_simple=False)
    j = jlc.LscaleCond(jlc.LscaleCondConfig(do_evap=do_evap), jsvp.SatVaporPres(**svp))
    t = tlc.LscaleCond(tlc.LscaleCondConfig(do_evap=do_evap), tsvp.SatVaporPres(**svp))
    cold = c["t"][..., 0] < 240.0
    for coldT in (None, cold):
        ref = j(J(c["t"]), J(q), J(c["p_full"]), J(c["p_half"]),
                None if coldT is None else J(coldT))
        out = t(T(c["t"]), T(q), T(c["p_full"]), T(c["p_half"]),
                None if coldT is None else T(coldT))
        # the centred des/dT of the full (Goff-Gratch) es amplifies
        # last-bit differences to ~1e-10 relative
        close_tuple(out, ref, rtol=1e-9, atol_frac=1e-12)


# ---------------------------------------------------------------------------
# surface layer, surface fluxes, diffusivity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(), dict(stable_option=2), dict(neutral=True)])
def test_mo_drag_matches(kw):
    rng = np.random.default_rng(3)
    n = 64
    pt = 290.0 + rng.uniform(-4, 4, n)
    pt0 = 290.0 + rng.uniform(-4, 4, n)
    z = rng.uniform(5.0, 80.0, n)
    z0 = np.full(n, 0.05)
    speed = rng.uniform(0.5, 12.0, n)
    ref = jmo.mo_drag(jmo.MOConfig(**kw), *map(J, (pt, pt0, z, z0, z0, z0, speed)))
    out = tmo.mo_drag(tmo.MOConfig(**kw), *map(T, (pt, pt0, z, z0, z0, z0, speed)))
    for a, b in zip(out, ref):
        close(a, b)


@pytest.mark.parametrize("case", ["ocean", "land", "bucket", "alt_gust"])
def test_surface_flux_matches(case):
    c = columns(4)
    rng = np.random.default_rng(4)
    shape = c["t_surf"].shape
    cfg_kw = dict(alt_gustiness=True) if case == "alt_gust" else {}
    land = rng.uniform(size=shape) > 0.5 if case in ("land", "bucket") else None
    bucket = rng.uniform(0.0, 0.2, shape) if case == "bucket" else None
    if bucket is not None:
        bucket[0, 0] = 0.0
    low = lambda k: c[k][..., -1]
    args = [low("t"), low("q"), low("u"), low("v"), low("p_full"),
            low("z_full") - c["z_half"][..., -1], c["p_half"][..., -1], c["t_surf"],
            np.full(shape, 0.05), np.full(shape, 0.05), np.full(shape, 0.05),
            np.full(shape, 1.0)]
    kw = dict(dt=1200.0)
    ref = jsf.surface_flux(jsf.SurfaceFluxConfig(**cfg_kw), jsvp.SatVaporPres(do_simple=True),
                           *map(J, args), land=None if land is None else J(land),
                           bucket_depth=None if bucket is None else J(bucket), **kw)
    out = tsf.surface_flux(tsf.SurfaceFluxConfig(**cfg_kw), tsvp.SatVaporPres(do_simple=True),
                           *map(T, args), land=None if land is None else T(land),
                           bucket_depth=None if bucket is None else T(bucket), **kw)
    close_tuple(out, ref, atol_frac=1e-12)


@pytest.mark.parametrize("kw", [dict(do_simple=True, frac_inner=0.1), dict(),
                                dict(fixed_depth=True)])
def test_diffusivity_matches(kw):
    c = columns(5)
    rng = np.random.default_rng(5)
    shape = c["t_surf"].shape
    u_star = rng.uniform(0.1, 0.6, shape)
    b_star = rng.normal(0.0, 0.01, shape)
    zs = c["z_half"][..., -1:]
    args = [c["t"], c["q"], c["u"], c["v"], c["p_full"], c["p_half"],
            c["z_full"] - zs, c["z_half"] - zs, u_star, b_star]
    ref = jdf.diffusivity(jdf.DiffusivityConfig(**kw), *map(J, args))
    out = tdf.diffusivity(tdf.DiffusivityConfig(**kw), *map(T, args))
    close_tuple(out, ref, atol_frac=1e-12)


# ---------------------------------------------------------------------------
# vertical diffusion, mixed layer
# ---------------------------------------------------------------------------

def _vert_diff_inputs(seed=6):
    c = columns(seed)
    rng = np.random.default_rng(seed)
    shape, L = c["t_surf"].shape, c["t"].shape[-1]
    k_m = rng.uniform(0.0, 40.0, shape + (L,))
    k_t = rng.uniform(0.0, 40.0, shape + (L,))
    surf = [rng.normal(0, 0.1, shape), rng.normal(0, 0.1, shape),
            -rng.uniform(0.0, 0.05, shape), -rng.uniform(0.0, 0.05, shape)]
    tends = [rng.normal(0, 1e-5, shape + (L,)) for _ in range(4)]
    return [c["u"], c["v"], c["t"], c["q"], k_m, k_t, c["p_half"], c["p_full"],
            c["z_full"], *surf, *tends], c


@pytest.mark.parametrize("conserve", [True, False])
def test_vert_diff_matches(conserve):
    args, _ = _vert_diff_inputs()
    ref = jvd.gcm_vert_diff_down(EARTH, 1200.0, *map(J, args), do_conserve_energy=conserve)
    out = tvd.gcm_vert_diff_down(EARTH, 1200.0, *map(T, args), do_conserve_energy=conserve)
    close_tuple(out.tri, ref.tri, atol_frac=1e-12)
    for name in ("dt_u", "dt_v", "dt_t", "dissipative_heat"):
        close(getattr(out, name), getattr(ref, name), atol=1e-18, msg=name)
    for a, b in zip(tvd.gcm_vert_diff_up(1200.0, out.tri), jvd.gcm_vert_diff_up(1200.0, ref.tri)):
        close(a, b, atol=1e-18)


@pytest.mark.parametrize("kw", [dict(), dict(do_qflux=True, qflux_amp=30.0, evaporation=False),
                                dict(do_ape_sst=True), dict(trop_depth=20.0, np_cap_factor=0.5,
                                                          albedo_choice=5)])
def test_mixed_layer_matches(kw):
    args, c = _vert_diff_inputs(7)
    tri = jvd.gcm_vert_diff_down(EARTH, 1200.0, *map(J, args)).tri
    rng = np.random.default_rng(7)
    shape = c["t_surf"].shape
    fluxes = [rng.uniform(-20, 60, shape), rng.uniform(0, 1e-4, shape),
              rng.uniform(350, 450, shape), rng.uniform(100, 500, shape),
              rng.uniform(250, 400, shape), rng.uniform(5, 20, shape),
              rng.uniform(0, 1e-5, shape), np.zeros(shape), rng.uniform(4, 7, shape),
              -rng.uniform(5, 20, shape), -rng.uniform(0, 0.02, shape)]
    jcfg, tcfg = jml.MixedLayerConfig(**kw), tml.MixedLayerConfig(**kw)
    lat, lon = c["lat"], c["lon"]
    close(tml.surface_albedo(tcfg, T(lat)), jml.surface_albedo(jcfg, J(lat)))
    jhc = jml.heat_capacity_field(jcfg, J(lon), J(lat))
    thc = tml.heat_capacity_field(tcfg, T(lon), T(lat))
    close(thc, jhc)
    jq = jml.analytic_qflux(jcfg, J(lat))
    close(tml.analytic_qflux(tcfg, T(lat)), jq)
    ref = jml.mixed_layer_step(jcfg, 600.0, J(c["t_surf"]), tri, *map(J, fluxes),
                               ocean_qflux=jq, heat_capacity=jhc, lats=J(lat))
    ttri = tvd.TriSurf(*(T(np.asarray(a)) for a in tri))
    out = tml.mixed_layer_step(tcfg, 600.0, T(c["t_surf"]), ttri, *map(T, fluxes),
                               ocean_qflux=T(np.asarray(jq)), heat_capacity=thc, lats=T(lat))
    close_tuple(out, ref, atol_frac=1e-12)


# ---------------------------------------------------------------------------
# RRTM adapter and the moist driver
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(), dict(lonstep=2), dict(do_zm_rad=True, do_zm_tracers=True)])
def test_rrtm_radiation_matches(kw):
    c = columns(8)
    cfg = dict(lw_scheme="grey", o3_mmr=1e-6, **kw)
    j = jrr.RRTMRadiation(jrr.RRTMConfig(**cfg))
    t = trr.RRTMRadiation(trr.RRTMConfig(**cfg), device="cpu")
    albedo = np.full(c["t_surf"].shape, 0.06)
    args = ("lat", "lon", "p_half", "t", "q")
    rkw = dict(gmt=2.8, time_since_ae=1.2, dt_rad_avg=2 * np.pi / 144)

    @jax.jit
    def jax_rad(lat, lon, p_half, t, q, albedo, t_surf):
        down = j.down(lat, lon, p_half, t, q, albedo, **rkw)
        return down, j.up(down, p_half, t_surf, albedo)

    jd, ju = jax_rad(*(J(c[k]) for k in args), J(albedo), J(c["t_surf"]))
    td = t.down(*(T(c[k]) for k in args), T(albedo), **rkw)
    tu = t.up(td, T(c["p_half"]), T(c["t_surf"]), T(albedo))
    assert float(np.asarray(jd.sw_down).max()) > 100.0          # sunlit columns
    close_tuple(td, jd, atol_frac=1e-12)
    close_tuple(tu, ju, atol_frac=1e-12)


def test_unported_options_raise():
    lats, lons = torch.zeros(2, dtype=torch.float64), torch.zeros(3, dtype=torch.float64)
    # dry convection, the giant-planet surface and the bucket are ported
    # (tests/test_torch_giant.py, tests/test_torch_land.py)
    for kw in (dict(convection_scheme="RAS"), dict(convection_scheme="FULL_BETTS_MILLER"),
               dict(bl_scheme="mellor_yamada"), dict(bl_scheme="stable_bl"),
               # the damping driver is ported but for its gravity-wave drags
               dict(do_damping=True, damping=tdd.DampingDriverConfig(do_mg_drag=True)),
               dict(do_damping=True, damping=tdd.DampingDriverConfig(do_cg_drag=True)),
               dict(do_cloud_spookie=True), dict(do_cloud_simple=True), dict(bl_scheme="edt"),
               dict(radiation_scheme="socrates"), dict(do_shallow_conv=True)):
        with pytest.raises(NotImplementedError):
            tmd.MoistPhysics(tmd.MoistPhysicsConfig(**kw), lats, lons)
    for lw in ("auto", "rrtmg"):
        with pytest.raises(NotImplementedError, match="RRTMG-LW"):
            trr.RRTMRadiation(trr.RRTMConfig(lw_scheme=lw), device="cpu")
    with pytest.raises(NotImplementedError, match="cloud_fields"):
        c = columns(0)
        trr.RRTMRadiation(trr.RRTMConfig(lw_scheme="grey"), device="cpu").down(
            *(T(c[k]) for k in ("lat", "lon", "p_half", "t", "q")), T(c["t_surf"]),
            cloud_fields=(None,) * 4)
    phys = tmd.MoistPhysics(tmd.MoistPhysicsConfig(dt_rad=1800.0), lats, lons)
    with pytest.raises(NotImplementedError, match="dt_rad"):
        phys(1200.0, 600.0, *([None] * 11))


@pytest.mark.parametrize("radiation,extra", [
    ("rrtm", dict()), ("rrtm", dict(convection_scheme="NONE", turb=False)),
    ("two_stream", dict()), ("two_stream", dict(mixed_layer_bc=False))])
def test_moist_driver_matches(radiation, extra):
    c = columns(9)
    kw = dict(radiation_scheme=radiation, **extra)
    jcfg = jmd.MoistPhysicsConfig(rrtm=jrr.RRTMConfig(lw_scheme="grey", o3_mmr=1e-6), **kw)
    tcfg = tmd.MoistPhysicsConfig(rrtm=trr.RRTMConfig(lw_scheme="grey", o3_mmr=1e-6), **kw)
    lats = np.deg2rad(np.array([-20.0, 45.0]))
    lons = np.deg2rad(np.array([0.0, 90.0, 180.0, 270.0]))
    j = jmd.MoistPhysics(jcfg, J(lats), J(lons))
    t = tmd.MoistPhysics(tcfg, T(lats), T(lons))
    names = ("u", "v", "t", "q", "p_full", "p_half", "p_full", "p_half", "z_full",
             "z_half", "t_surf")
    gmt, tsae = np.float32(3.5), np.float32(4.2)
    ref = jax.jit(lambda *a: j(1200.0, 600.0, *a, gmt=J(gmt), time_since_ae=J(tsae)))(
        *(J(c[k]) for k in names))
    out = t(1200.0, 600.0, *(T(c[k]) for k in names), gmt=T(gmt), time_since_ae=T(tsae))
    for name in ("dt_u", "dt_v", "dt_t", "dt_q", "t_surf"):
        b = np.asarray(getattr(ref, name))
        close(getattr(out, name), b, atol=1e-12 * float(np.abs(b).max()), msg=name)
    assert set(out.diagnostics) == set(ref.diagnostics)
    for name, b in ref.diagnostics.items():
        b = np.asarray(b)
        # CIN: see test_qe_moist_convection_matches
        atol = 1e-9 if name == "cin" else 1e-12 * float(np.abs(b).max(initial=0.0))
        close(out.diagnostics[name], b, atol=atol, msg=name)
