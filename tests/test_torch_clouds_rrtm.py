"""isca_tpu_torch's cloudy RRTM path against isca_tpu: cldprop_sw, McICA,
RRTMG-LW with a McICA key, the RRTM adapter with SimCloud's cloud_fields,
the moist driver with SimCloud and SPOOKIE clouds feeding RRTM, and the
simple_clouds trip golden.

* cldprop_sw (physics/rrtmg_sw.py) for iceflag 2 and 3 at float64, rtol
  1e-12: its tables (data/rrtmg_sw_cld.npz, a byte copy of isca_tpu's) are
  rounded to float32 whatever the run's dtype, as isca_tpu rounds them.
* mcica_subcol (physics/mcica.py): the draws of a key equal
  jax.random.uniform's bit for bit (float32 and float64), and so do the
  binary subcolumns for each overlap rule.
* RRTMGLw with mcica_key, RRTMRadiation with cloud_fields (RRTMG-LW and
  grey LW; with and without lonstep), and MoistPhysics with clouds and RRTM,
  at float64, rtol 1e-10 of each field's largest entry. With clouds the LW
  clear-sky stream differs from the total one, so rtrn takes its two-stream
  branch; its clear-sky fluxes are held too.
* The simple_clouds golden (tools/trip_test.py build_simple_clouds: T21L8
  float64, grey radiation with SimCloud, 2 model days) at trip_test's RTOL
  1e-7. With two-stream radiation the clouds feed no radiation, so it equals
  the frierson golden bit for bit; the clouds themselves are held above.
"""

import json
import pathlib
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isca_tpu.physics import mcica as jmc
from isca_tpu.physics import moist_driver as jmd
from isca_tpu.physics import rrtm_radiation as jrr
from isca_tpu.physics import rrtmg_sw as jsw
from isca_tpu_torch.models import moist as tmoist
from isca_tpu_torch.physics import mcica as tmc
from isca_tpu_torch.physics import moist_driver as tmd
from isca_tpu_torch.physics import rrtm_radiation as trr
from isca_tpu_torch.physics import rrtmg_sw as tsw
from isca_tpu_torch.utils import threefry

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
from tests.test_torch_moist import TRIP_CORE  # noqa: E402
from tests.test_torch_physics import columns  # noqa: E402
from tests.test_torch_socrates_gcm import one_torch_thread  # noqa: E402,F401 (autouse)
from tools import trip_test  # noqa: E402

# the committed LW k-tables are synthetic, and say so at every construction
pytestmark = pytest.mark.filterwarnings("ignore:RRTMG-LW is running on SYNTHETIC")

RTOL = 1e-10

# isca_tpu's cldprop_sw caches its tables at the first call, which must not
# lie inside a jax.jit trace (ROADMAP C.9)
jsw._CldTables()


def T(a):
    return torch.as_tensor(np.array(a))


def J(a):
    return jnp.asarray(np.array(a))


def close(port, ref, rtol=RTOL, msg=""):
    port = port.detach().cpu().numpy() if torch.is_tensor(port) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (msg, port.shape, ref.shape)
    atol = rtol * float(np.abs(ref).max(initial=0.0))
    np.testing.assert_allclose(port, ref, rtol=rtol, atol=atol, err_msg=msg)


def close_tuple(port, ref, rtol=RTOL, msg=""):
    for name in ref._fields:
        close(getattr(port, name), getattr(ref, name), rtol=rtol, msg=f"{msg} {name}")


def cloud_fields(shape, seed=11):
    """SimCloud-like (cf, reff [um], qcl [kg/kg], frac_liq): clear, partly
    cloudy and overcast layers, liquid, ice and mixed."""
    rng = np.random.default_rng(seed)
    cf = np.where(rng.uniform(0, 1, shape) > 0.35, rng.uniform(0, 1, shape), 0.0)
    cf[..., 2] = 1.0
    return (cf, rng.uniform(3.0, 140.0, shape), cf * rng.uniform(0, 3e-4, shape),
            np.clip(rng.uniform(-0.3, 1.3, shape), 0.0, 1.0))


@pytest.mark.parametrize("iceflag", [2, 3])
def test_cldprop_sw_matches(iceflag):
    rng = np.random.default_rng(iceflag)
    shape = (3, 5, 12)
    cf = np.where(rng.uniform(0, 1, shape) > 0.3, rng.uniform(0, 1, shape), 0.0)
    clwp = np.where(rng.uniform(0, 1, shape) > 0.3, rng.uniform(0, 200, shape), 0.0)
    ciwp = np.where(rng.uniform(0, 1, shape) > 0.3, rng.uniform(0, 100, shape), 0.0)
    rel, rei = rng.uniform(1.0, 70.0, shape), rng.uniform(2.0, 160.0, shape)
    ref = jsw.cldprop_sw(*map(J, (cf, clwp, ciwp, rel, rei)), iceflag=iceflag)
    out = tsw.cldprop_sw(*map(T, (cf, clwp, ciwp, rel, rei)), iceflag=iceflag)
    for a, b, name in zip(out, ref, ("tauc", "ssac", "asmc")):
        assert a.dtype == torch.float64
        close(a, b, rtol=1e-12, msg=name)
    assert (np.asarray(ref[0]) > 0).any()
    with pytest.raises(ValueError):
        tsw.cldprop_sw(*map(T, (cf, clwp, ciwp, rel, rei)), iceflag=1)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("overlap", [1, 2, 3])
def test_mcica_subcol_matches(overlap, dtype):
    shape = (2, 3, 9)
    cf, _, qcl, fl = cloud_fields(shape, seed=overlap)
    clwp, ciwp = qcl * 1e5 * fl, qcl * 1e5 * (1 - fl)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    for seed in (0, 7):
        key = threefry.prng_key(seed, device="cpu")
        np.testing.assert_array_equal(key.numpy(), np.asarray(jax.random.PRNGKey(seed)))
        draws = threefry.uniform(key, shape + (140,), dtype=tdt)
        np.testing.assert_array_equal(
            draws.numpy(), np.asarray(jax.random.uniform(jax.random.PRNGKey(seed),
                                                         shape + (140,), dtype=jdt)))
        ref = jmc.mcica_subcol(jax.random.PRNGKey(seed), *(J(a).astype(jdt) for a in
                                                           (cf, clwp, ciwp)), 140, overlap)
        out = tmc.mcica_subcol(key, *(T(a).to(tdt) for a in (cf, clwp, ciwp)), 140, overlap)
        for a, b in zip(out, ref):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    mean = out[0].numpy().mean(axis=-1)
    assert (mean[cf == 0] == 0).all() and (mean[..., 2] == 1).all() and mean.max() > 0


def test_mcica_statistics():
    """tests/test_rrtmg_lw.py's McICA check on the port: subcolumn cloud
    averages back to the grid fraction, max-random overlap shares cloud
    between contiguous layers, cloudy subcolumns carry the full water."""
    L, ns = 10, 4000
    cf = torch.zeros((1, L), dtype=torch.float64)
    cf[0, 3:6] = 0.4
    clwp = torch.where(cf > 0, 50.0, 0.0)
    cldf_mc, clwp_mc, _ = tmc.mcica_subcol(threefry.prng_key(0, device="cpu"), cf, clwp,
                                           torch.zeros_like(clwp), ns)
    mean = cldf_mc.mean(dim=-1).numpy()
    np.testing.assert_allclose(mean[0, 3:6], 0.4, atol=0.03)
    assert (mean[0, :3] == 0).all() and (mean[0, 6:] == 0).all()
    m = cldf_mc[0].numpy()
    assert (m[3] == m[5]).mean() > 0.95
    assert float(clwp_mc[0, 4][cldf_mc[0, 4] > 0].min()) == 50.0


def test_rrtmglw_mcica_matches():
    from tests.test_torch_rrtmg_lw import GAS, column, lw_jax, lw_port

    args = column(ncol=4)
    shape = args[1].shape
    cf, reff, qcl, fl = cloud_fields(shape)
    kw = dict(cldfrac=cf, clwp=qcl * 2e5 * fl, ciwp=qcl * 2e5 * (1 - fl),
              rel=np.clip(reff, 2.5, 60.0), rei=np.clip(reff, 5.0, 131.0))
    jl, tl = lw_jax(**GAS), lw_port(**GAS)
    ref = jax.jit(lambda *a: jl(*a[:7], **dict(zip(kw, a[7:])), mcica_key=jax.random.PRNGKey(5)))(
        *map(J, args + tuple(kw.values())))
    out = tl(*map(T, args), **{k: T(v) for k, v in kw.items()},
             mcica_key=threefry.prng_key(5, device="cpu"))
    close_tuple(out, ref, msg="mcica")
    assert float(np.abs(np.asarray(ref.olr - ref.uflxc[..., 0])).max()) > 1.0
    # overcast everywhere it is cloudy: McICA equals the fractional path
    kw1 = dict(kw, cldfrac=(cf > 0).astype(float))
    frac = tl(*map(T, args), **{k: T(v) for k, v in kw1.items()})
    mc = tl(*map(T, args), **{k: T(v) for k, v in kw1.items()},
            mcica_key=threefry.prng_key(7, device="cpu"))
    np.testing.assert_allclose(mc.olr.numpy(), frac.olr.numpy(), rtol=1e-6)


def rad_inputs(L=10):
    c = columns(12, L=L)
    return c, cloud_fields(c["t"].shape)


@pytest.mark.parametrize("lw_scheme", ["rrtmg", "grey"])
@pytest.mark.parametrize("lonstep", [1, 2])
def test_rrtm_radiation_cloud_fields_match(lonstep, lw_scheme):
    c, clouds = rad_inputs()
    cfg = dict(o3_mmr=1e-6, lonstep=lonstep, lw_scheme=lw_scheme)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        j = jrr.RRTMRadiation(jrr.RRTMConfig(**cfg))
        t = trr.RRTMRadiation(trr.RRTMConfig(**cfg), device="cpu")
    albedo = np.full(c["t_surf"].shape, 0.06)
    names = ("lat", "lon", "p_half", "t", "q")
    rkw = dict(gmt=2.8, time_since_ae=1.2, dt_rad_avg=2 * np.pi / 144)

    @jax.jit
    def jax_rad(lat, lon, p_half, t, q, albedo, t_surf, *cl):
        down = j.down(lat, lon, p_half, t, q, albedo, cloud_fields=cl, **rkw)
        up = j.up(down, p_half, t_surf, albedo)
        stash = j._lw_stash if lw_scheme == "rrtmg" else None
        return down, up, stash

    jd, ju, jst = jax_rad(*(J(c[k]) for k in names), J(albedo), J(c["t_surf"]),
                          *map(J, clouds))
    td = t.down(*(T(c[k]) for k in names), T(albedo), cloud_fields=tuple(map(T, clouds)), **rkw)
    tu = t.up(td, T(c["p_half"]), T(c["t_surf"]), T(albedo))
    close_tuple(td, jd, msg="down")
    close_tuple(tu, ju, msg="up")
    if lw_scheme == "rrtmg":
        # clouds: the clear-sky stream is its own, rtrn's two-stream branch
        st = t._lw_stash["st"]
        assert st.dclr_bu is not st.drad_bu
        jf = j.lw_rrtmg.up_phase(jst, J(c["t_surf"][:, ::lonstep]))
        tf = t.lw_rrtmg.up_phase(t._lw_stash, T(c["t_surf"][:, ::lonstep]))
        close_tuple(tf, jf, msg="lw fluxes")
        assert float(np.abs(np.asarray(jf.uflx - jf.uflxc)).max()) > 1.0
    # the clouds change the SW: without them the adapter gives other fluxes
    clear = t.down(*(T(c[k]) for k in names), T(albedo), **rkw)
    assert float((clear.net_surf_sw_down - td.net_surf_sw_down).abs().max()) > 1.0


@pytest.mark.parametrize("clouds", ["do_cloud_simple", "do_cloud_spookie"])
@pytest.mark.parametrize("lw_scheme", ["rrtmg", "grey"])
def test_driver_clouds_rrtm_matches(lw_scheme, clouds):
    c = columns(13, L=10)
    kw = dict(radiation_scheme="rrtm", **{clouds: True})
    jcfg = jmd.MoistPhysicsConfig(rrtm=jrr.RRTMConfig(lw_scheme=lw_scheme, o3_mmr=1e-6), **kw)
    tcfg = tmd.MoistPhysicsConfig(rrtm=trr.RRTMConfig(lw_scheme=lw_scheme, o3_mmr=1e-6), **kw)
    lats = np.deg2rad(np.array([-20.0, 45.0]))
    lons = np.deg2rad(np.array([0.0, 90.0, 180.0, 270.0]))
    j = jmd.MoistPhysics(jcfg, J(lats), J(lons))
    t = tmd.MoistPhysics(tcfg, T(lats), T(lons))
    names = ("u", "v", "t", "q", "p_full", "p_half", "p_full", "p_half", "z_full",
             "z_half", "t_surf")
    wg = np.random.default_rng(1).uniform(-0.2, 0.2, c["t"].shape)
    gmt, tsae = np.float32(3.5), np.float32(4.2)
    ref = jax.jit(lambda w, *a: j(1200.0, 600.0, *a, gmt=J(gmt), time_since_ae=J(tsae),
                                  wg_full=w))(J(wg), *(J(c[k]) for k in names))
    out = t(1200.0, 600.0, *(T(c[k]) for k in names), gmt=T(gmt), time_since_ae=T(tsae),
            wg_full=T(wg))
    for name in ("dt_u", "dt_v", "dt_t", "dt_q", "t_surf"):
        close(getattr(out, name), getattr(ref, name), msg=name)
    assert set(out.diagnostics) == set(ref.diagnostics)
    for name, b in ref.diagnostics.items():
        close(out.diagnostics[name], b, msg=name)
    assert float(np.asarray(ref.diagnostics["cf"]).max()) > 0.0


def test_simple_clouds_golden():
    """tools/trip_test.py build_simple_clouds over 2 model days at T21L8
    float64 against tests/goldens/trip_goldens.json, with trip_test's
    compare (RTOL 1e-7)."""
    golden = json.loads((REPO / "tests" / "goldens" / "trip_goldens.json").read_text())
    assert golden["simple_clouds"] == golden["frierson"]
    cfg = tmoist.GreyMoistConfig(
        core=tmoist.PrimitiveConfig(dtype=torch.float64, **TRIP_CORE),
        physics=tmd.MoistPhysicsConfig(do_cloud_simple=True))
    model = tmoist.GreyMoistModel(cfg, device="cpu")
    steps = int(round(trip_test.DAYS * 86400.0 / cfg.core.dt))
    state = model.run(model.initial_state(), steps)
    got = {k: trip_test.field_stats(v.numpy()) for k, v in sorted(model.diag_fields(state).items())}
    assert trip_test.compare("simple_clouds", got, golden["simple_clouds"]) == []
