"""isca_tpu_torch's full Betts-Miller convection and the MiMA GCM against
isca_tpu.

* BettsMiller (physics/betts_miller.py) on the columns of
  tests/test_moist_physics.py's TestFullBettsMiller (a deep-convective moist
  adiabat and a shallow-only profile) and on seeded random columns, in
  every option (do_simp off, do_shallower, do_changeqref, do_envsat,
  do_taucape), every field of the result at rtol 1e-10, with the JAX tests'
  physical checks (deep rains, the default leaves shallow-only columns
  alone, do_changeqref rains nothing).
* The moist driver with FULL_BETTS_MILLER and RRTM radiation (RRTMG-SW and
  RRTMG-LW, through RRTMConfig()'s "auto"), one call at rtol 1e-10.
* The GCM of tools/trip_test.py build_mima (T21L8, dt = 1200 s, RRTM with
  RRTMG-LW, seasonal sun) over 10 steps from cold start at float64: every
  leaf of the state and the last step's physics diagnostics at rtol 1e-6 of
  each field's largest entry, the RRTM GCM's bound (ROADMAP C.5: XLA's
  float32 arcsin is one ulp off torch's at the first step's
  time_since_ae). Measured here: 1.2e-8 at most (divergence).

isca_tpu's `mima` trip golden is not met by isca_tpu itself on this machine
(ROADMAP C.7), so the port is held to isca_tpu directly. The isca_tpu GCM is
compiled once per module (first step, then the leapfrog step).
"""

import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isca_tpu.dycore.primitive import PrimitiveConfig as JPC
from isca_tpu.models import moist as jmoist
from isca_tpu.physics import betts_miller as jbm
from isca_tpu.physics import moist_driver as jmd
from isca_tpu.physics import rrtm_radiation as jrr
from isca_tpu.physics import sat_vapor_pres as jsvp
from isca_tpu_torch.dycore.primitive import PrimitiveConfig as TPC
from isca_tpu_torch.models import moist as tmoist
from isca_tpu_torch.physics import betts_miller as tbm
from isca_tpu_torch.physics import moist_driver as tmd
from isca_tpu_torch.physics import rrtm_radiation as trr
from isca_tpu_torch.physics import sat_vapor_pres as tsvp
from isca_tpu_torch.physics import rrtmg_sw as tsw
from isca_tpu_torch.utils import launch_count
from isca_tpu_torch.utils.tree import flatten_with_paths

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
from tests.test_moist_physics import column_profile, moist_adiabat_column  # noqa: E402
from tests.test_torch_physics import columns  # noqa: E402

# the committed LW k-tables are synthetic, and say so at every construction
pytestmark = pytest.mark.filterwarnings("ignore:RRTMG-LW is running on SYNTHETIC")

RTOL = 1e-10
GCM_RTOL = 1e-6
GCM_STEPS = 10

JAX = dict(core=JPC, physics=jmd.MoistPhysicsConfig, model=jmoist, rrtm=jrr.RRTMConfig)
TORCH = dict(core=TPC, physics=tmd.MoistPhysicsConfig, model=tmoist, rrtm=trr.RRTMConfig)

# tools/trip_test.py _moist_core (T21L8)
TRIP_CORE = dict(resolution="T21", num_levels=8, dt=1200.0, vert_coord_option="uneven_sigma",
                 vert_coord_kwargs=(("scale_heights", 6.0), ("surf_res", 0.5),
                                    ("exponent", 7.5)),
                 do_water_correction=True, water_correction_limit=200.0e2, robert_coeff=0.03)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small ops: one intra-op thread, the cores left to the other
    test workers (as tests/test_torch_moist.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def T(a):
    return torch.as_tensor(np.array(a))


def close(port, ref, rtol=RTOL, atol=None, msg=""):
    port = port.detach().cpu().numpy() if torch.is_tensor(port) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (msg, port.shape, ref.shape)
    if atol is None:
        atol = rtol * float(np.abs(ref).max(initial=0.0))
    np.testing.assert_allclose(port, ref, rtol=rtol, atol=atol, err_msg=msg)


# ---------------------------------------------------------------------------
# full Betts-Miller
# ---------------------------------------------------------------------------

BM_OPTIONS = {
    "default": dict(),
    "no_simp": dict(do_simp=False),
    "shallower": dict(do_shallower=True),
    "changeqref": dict(do_changeqref=True),
    "envsat": dict(do_envsat=True),
    "taucape": dict(do_taucape=True, capetaubm=900.0, tau_min=600.0),
}


def bm_columns(kind):
    """(t, q, p_full, p_half) level-last. "profiles": the moist adiabat and
    the shallow-only column of tests/test_moist_physics.py side by side."""
    if kind == "random":
        c = columns(11, shape=(4, 6), L=20)
        return c["t"], c["q"], c["p_full"], c["p_half"]
    t1, q1, pf, ph = (np.asarray(a) for a in moist_adiabat_column())
    t2, pf2, ph2, _ = (np.asarray(a) for a in column_profile(t_sfc=302.0, lapse=8.0e-3))
    q2 = 0.9 * np.asarray(jsvp.SatVaporPres(do_simple=True).qs(jnp.asarray(t2),
                                                               jnp.asarray(pf2)))
    assert np.array_equal(pf, pf2) and np.array_equal(ph, ph2)
    cat = lambda a, b: np.concatenate([a, b], axis=0)
    return cat(t1, t2), cat(q1, q2), cat(pf, pf2), cat(ph, ph2)


@pytest.mark.parametrize("kind", ["profiles", "random"])
@pytest.mark.parametrize("option", list(BM_OPTIONS))
def test_betts_miller_matches(option, kind):
    kw = BM_OPTIONS[option]
    j = jbm.BettsMiller(jbm.BettsMillerConfig(**kw), jsvp.SatVaporPres(do_simple=True))
    t = tbm.BettsMiller(tbm.BettsMillerConfig(**kw), tsvp.SatVaporPres(do_simple=True))
    args = bm_columns(kind)
    ref = jax.jit(lambda *a: j(1200.0, *a))(*map(jnp.asarray, args))
    got = t(1200.0, *map(T, args))
    for name in ref._fields:
        # CIN accumulates over cancelling levels: absolute tolerance, as
        # tests/test_torch_physics.py's convection test
        atol = 1e-9 if name == "cin" else None
        close(getattr(got, name), getattr(ref, name), atol=atol, msg=f"{option} {name}")
    if kind == "profiles":
        rain, flag = got.rain.numpy(), got.convflag.numpy()
        dp = args[3][:, 1:] - args[3][:, :-1]
        assert float(got.cape[0]) > 0.0 and flag[0] == 2 and rain[0] > 0.0   # deep
        if option == "default":
            # Pt > 0, Pq <= 0 with both shallow options off: no convection
            assert rain[1] == 0.0 and float(got.deltaT[1].abs().max()) == 0.0
        if option == "changeqref":
            dq = got.deltaq[1].numpy()
            assert abs((dq * dp[1]).sum()) <= 1e-4 * ((np.abs(dq) * dp[1]).sum() + 1e-14)


def test_driver_full_betts_miller_rrtmg_lw_matches():
    c = columns(9)
    kw = dict(radiation_scheme="rrtm", convection_scheme="FULL_BETTS_MILLER")
    jcfg = jmd.MoistPhysicsConfig(rrtm=jrr.RRTMConfig(o3_mmr=1e-6), **kw)
    tcfg = tmd.MoistPhysicsConfig(rrtm=trr.RRTMConfig(o3_mmr=1e-6), **kw)
    lats = np.deg2rad(np.array([-20.0, 45.0]))
    lons = np.deg2rad(np.array([0.0, 90.0, 180.0, 270.0]))
    j = jmd.MoistPhysics(jcfg, jnp.asarray(lats), jnp.asarray(lons))
    t = tmd.MoistPhysics(tcfg, T(lats), T(lons))
    assert t.radiation.lw_rrtmg is not None and j.radiation.lw_rrtmg is not None
    names = ("u", "v", "t", "q", "p_full", "p_half", "p_full", "p_half", "z_full",
             "z_half", "t_surf")
    gmt, tsae = np.float32(3.5), np.float32(4.2)
    ref = jax.jit(lambda *a: j(1200.0, 600.0, *a, gmt=jnp.asarray(gmt),
                               time_since_ae=jnp.asarray(tsae)))(
        *(jnp.asarray(c[k]) for k in names))
    out = t(1200.0, 600.0, *(T(c[k]) for k in names), gmt=T(gmt), time_since_ae=T(tsae))
    for name in ("dt_u", "dt_v", "dt_t", "dt_q", "t_surf"):
        close(getattr(out, name), getattr(ref, name), rtol=RTOL, msg=name)
    assert set(out.diagnostics) == set(ref.diagnostics)
    for name, b in ref.diagnostics.items():
        close(out.diagnostics[name], b, atol=1e-9 if name == "cin" else None, msg=name)
    for name in tmd.RadCache._fields:
        close(getattr(out.rad_cache, name), getattr(ref.rad_cache, name), msg=name)
    assert float(np.asarray(ref.diagnostics["olr"]).min()) > 100.0


# ---------------------------------------------------------------------------
# the MiMA GCM of the trip test (build_mima) against isca_tpu
# ---------------------------------------------------------------------------

def build_mima_config(pkg, dtype):
    """tools/trip_test.py build_mima: _moist_core at T21L8 with RRTM
    radiation (RRTMConfig(do_seasonal=True): RRTMG-SW + RRTMG-LW)."""
    return pkg["model"].GreyMoistConfig(
        core=pkg["core"](dtype=dtype, **TRIP_CORE),
        physics=pkg["physics"](radiation_scheme="rrtm", rrtm=pkg["rrtm"](do_seasonal=True)))


@pytest.fixture(scope="module")
def jax_mima():
    """isca_tpu's build_mima GCM over GCM_STEPS steps: (state, diagnostics
    of the last step)."""
    model = jmoist.GreyMoistModel(build_mima_config(JAX, jnp.float64))
    s = jax.jit(lambda s: model.step(s, first=True))(model.initial_state())
    rest = jax.jit(model.step_with_diagnostics)
    for _ in range(GCM_STEPS - 1):
        s, diag = rest(s)
    return model, s, diag


def test_mima_gcm_matches_isca_tpu(jax_mima):
    jm, js, jdiag = jax_mima
    tm = tmoist.GreyMoistModel(build_mima_config(TORCH, torch.float64), device="cpu")
    assert tm.physics.radiation.lw_rrtmg is not None
    ts = tm.run(tm.initial_state(), GCM_STEPS - 1)
    ts, tdiag = tm.step_with_diagnostics(ts)
    jleaves = {jax.tree_util.keystr(k): np.asarray(v)
               for k, v in jax.tree_util.tree_flatten_with_path(js)[0]}
    tleaves = dict(flatten_with_paths(ts))
    assert set(tleaves) == set(jleaves)
    for k, b in jleaves.items():
        close(tleaves[k], b, rtol=GCM_RTOL, msg=k)
    assert set(tdiag) == set(jdiag)
    for k, b in jdiag.items():
        atol = 1e-9 if k == "cin" else None
        close(tdiag[k], b, rtol=GCM_RTOL, atol=atol, msg=f"diag {k}")
    assert tleaves[".rad_cache.age"].device.type == "cpu" and int(tleaves[".rad_cache.age"]) == 1
    olr = tdiag["olr"].numpy()
    assert np.isfinite(olr).all() and 100.0 < olr.mean() < 400.0


def test_launch_count_counts_ranges_and_the_kernel_as_one():
    """utils/launch_count.py on the MiMA GCM cut to T21L8: the RRTMG-LW range
    inside the physics range inside the step, the plain sw_flux counted as
    one launch per step, and the module left as it was."""
    cfg = tmoist.mima_test_case_config(resolution="T21", num_levels=8, dtype=torch.float64)
    model = tmoist.GreyMoistModel(cfg, device="cpu")
    plain = tsw.sw_flux_solve_reference
    calls = []

    def spy(*a, **kw):
        calls.append(1)
        return plain(*a, **kw)

    tsw.sw_flux_solve_reference = spy
    try:
        n = launch_count.count_steps(model, 2)
    finally:
        tsw.sw_flux_solve_reference = plain
    # the first (uncounted) step and the two counted ones
    assert len(calls) == 3 and tsw.sw_flux_solve_reference is plain
    assert n["per_step"] > n["physics_per_step"] > n["rrtmg_lw_per_step"] > 100
