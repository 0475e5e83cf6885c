"""The slice as a whole: isca_tpu_torch's GreyMoistModel (the grey-moist
Frierson aquaplanet GCM) against the trip goldens and against isca_tpu's.

* 2 model days (144 steps of 1200 s) at T21L8 float64 on the CPU in the
  frierson, top_down_test and ape_aquaplanet configurations of
  tools/trip_test.py, compared with tests/goldens/trip_goldens.json by the
  trip test's own field_stats and compare (RTOL 1e-7, ATOL 1e-9 x field
  scale).
* 10 steps against isca_tpu at float64 from cold start, every leaf of the
  state, the diagnostic fields (plain and extended), the global
  diagnostics and the last step's physics diagnostics at rtol 1e-9 of each
  field's largest entry.
* 3 steps at float32: the port's float32 run is as accurate as
  isca_tpu's, to within 3x, against isca_tpu's float64 run (see the test).
* frierson_test_case_config cut to T21L8 (Rayleigh sponge, prescribed
  initial SST), 4 steps at float64 against isca_tpu, rtol 1e-9; the same
  GCM with RRTM radiation (RRTMG-SW + grey LW), 4 steps, rtol 1e-6: its
  seasonal sun takes the declination from the float32 clock (as isca_tpu
  does), and at the first step's time_since_ae = pi/2 XLA's float32 arcsin
  is one ulp from the correctly rounded value that torch returns
  (-0.40908775 against -0.40908772). That moves coszen by 6.7e-8, and after
  4 steps the state by up to 1.2e-8 of a field's largest entry, the
  zonal-mean wind by 5.7e-8 and the top level's Rayleigh drag (at most
  5.7e-8 m/s^2, on the first steps' weak winds) by 2.8e-7.
* Restarts written by either package load in the other; the numpy state
  round trip; the CLI's frierson model; options that are not ported raise
  (land and the bucket are tested in tests/test_torch_land.py).

One isca_tpu model per configuration is shared through module-scoped
fixtures; each runs under jax.jit as step functions (one compile for the
forward first step, one for the leapfrog steps).
"""

import dataclasses
import json
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isca_tpu.dycore.primitive import PrimitiveConfig as JPC
from isca_tpu.io import restart as jrestart
from isca_tpu.models import moist as jmoist
from isca_tpu.physics import mixed_layer as jml
from isca_tpu.physics import moist_driver as jmd
from isca_tpu.physics import rrtm_radiation as jrr
from isca_tpu.physics import two_stream_gray as jtsg
from isca_tpu_torch import __main__ as tmain
from isca_tpu_torch.convert import (GREY_MOIST_STATE_KEYS, grey_moist_state_from_numpy,
                                    grey_moist_state_to_numpy)
from isca_tpu_torch.dycore.primitive import PrimitiveConfig as TPC
from isca_tpu_torch.io import restart as trestart
from isca_tpu_torch.models import moist as tmoist
from isca_tpu_torch.physics import damping_driver as tdd
from isca_tpu_torch.physics import mixed_layer as tml
from isca_tpu_torch.physics import moist_driver as tmd
from isca_tpu_torch.physics import rrtm_radiation as trr
from isca_tpu_torch.physics import two_stream_gray as ttsg
from isca_tpu_torch.utils.tree import flatten_with_paths

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
from tools import trip_test  # noqa: E402

JAX = dict(core=JPC, physics=jmd.MoistPhysicsConfig, model=jmoist, ml=jml, tsg=jtsg,
           rrtm=jrr.RRTMConfig)
TORCH = dict(core=TPC, physics=tmd.MoistPhysicsConfig, model=tmoist, ml=tml, tsg=ttsg,
             rrtm=trr.RRTMConfig)

# tools/trip_test.py _moist_core at T21L8
TRIP_CORE = dict(resolution="T21", num_levels=8, dt=1200.0, vert_coord_option="uneven_sigma",
                 vert_coord_kwargs=(("scale_heights", 6.0), ("surf_res", 0.5),
                                    ("exponent", 7.5)),
                 do_water_correction=True, water_correction_limit=200.0e2, robert_coeff=0.03)
# the Frierson sigma ladder cut to 8 layers (every third half level)
FRIERSON_BK_L8 = tuple(jmoist.FRIERSON_BK[i] for i in (0, 3, 6, 9, 12, 15, 18, 21, 25))


def physics_kw(pkg, case):
    """The trip test's physics options for `case` (tools/trip_test.py
    build_frierson, build_top_down_test, build_ape_aquaplanet)."""
    if case == "top_down_test":
        return dict(radiation=pkg["tsg"].TwoStreamConfig(rad_scheme="byrne"))
    if case == "ape_aquaplanet":
        return dict(mixed_layer=pkg["ml"].MixedLayerConfig(do_ape_sst=True))
    return {}


def config(pkg, case, dtype):
    """GreyMoistConfig of one package for a named case."""
    if case in ("frierson_test_case", "rrtm_grey"):
        cfg = pkg["model"].frierson_test_case_config()
        core = dataclasses.replace(
            cfg.core, resolution="T21", num_levels=8, dtype=dtype,
            vert_coord_kwargs=(("bk", FRIERSON_BK_L8), ("pk", (0.0,) * 9)))
        phys = cfg.physics
        if case == "rrtm_grey":
            phys = dataclasses.replace(phys, radiation_scheme="rrtm",
                                       rrtm=pkg["rrtm"](lw_scheme="grey"))
        return dataclasses.replace(cfg, core=core, physics=phys)
    return pkg["model"].GreyMoistConfig(core=pkg["core"](dtype=dtype, **TRIP_CORE),
                                        physics=pkg["physics"](**physics_kw(pkg, case)))


def port_model(case, dtype=torch.float64):
    return tmoist.GreyMoistModel(config(TORCH, case, dtype), device="cpu")



@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's eager T21 steps are many small ops: one intra-op thread
    runs them faster than many, and leaves the cores to the other test
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

class JaxRunner:
    """An isca_tpu model with its step functions compiled once."""

    def __init__(self, case, dtype=jnp.float64):
        self.model = jmoist.GreyMoistModel(config(JAX, case, dtype))
        self.first = jax.jit(lambda s: self.model.step(s, first=True))
        self.rest = jax.jit(self.model.step_with_diagnostics)

    def run(self, steps):
        """State after `steps` steps from cold start, and the last step's
        diagnostics (None after the forward first step alone)."""
        s, diag = self.first(self.model.initial_state()), None
        for _ in range(steps - 1):
            s, diag = self.rest(s)
        return s, diag


@pytest.fixture(scope="module")
def jax_runners():
    return {}


def jax_runner(jax_runners, case, dtype=jnp.float64):
    key = (case, str(dtype))
    if key not in jax_runners:
        jax_runners[key] = JaxRunner(case, dtype)
    return jax_runners[key]


def as_np(fields):
    return {k: (v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v))
            for k, v in fields.items()}


def jax_leaves(state):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(state)[0]}


def close_dicts(got, ref, rtol, what):
    assert set(got) == set(ref), (what, set(got) ^ set(ref))
    for k, b in ref.items():
        a = got[k]
        assert a.shape == b.shape, (what, k, a.shape, b.shape)
        scale = float(np.abs(b).max(initial=0.0))
        np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * scale, err_msg=f"{what} {k}")


def port_run(model, steps):
    s = model.run(model.initial_state(), steps - 1)
    return model.step_with_diagnostics(s, first=steps == 1)


# ---------------------------------------------------------------------------
# trip goldens
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["frierson", "top_down_test", "ape_aquaplanet"])
def test_two_days_match_trip_goldens(name):
    with open(REPO / "tests" / "goldens" / "trip_goldens.json") as f:
        golden = json.load(f)[name]
    model = port_model(name)
    steps = int(round(trip_test.DAYS * 86400.0 / model.config.core.dt))
    assert steps == 144
    state = model.run(model.initial_state(), steps, first=True)
    got = {k: trip_test.field_stats(v) for k, v in sorted(as_np(model.diag_fields(state)).items())}
    errors = trip_test.compare(name, got, golden)
    assert not errors, "\n".join(errors)


# ---------------------------------------------------------------------------
# against isca_tpu
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case,steps,rtol", [("frierson", 10, 1e-9),
                                             ("frierson_test_case", 4, 1e-9),
                                             ("rrtm_grey", 4, 1e-6)])
def test_steps_match_isca_tpu(jax_runners, case, steps, rtol):
    jr = jax_runner(jax_runners, case)
    js, jdiag = jr.run(steps)
    tm = port_model(case)
    ts, tdiag = port_run(tm, steps)
    tleaves = {k: v.numpy() for k, v in flatten_with_paths(ts)}
    jleaves = jax_leaves(js)
    assert {".dyn.tracers['sphum'].curr", ".rad_cache.age", ".time_seconds"} <= set(tleaves)
    close_dicts(tleaves, jleaves, rtol, "state")
    assert tleaves[".time_seconds"].dtype == np.float32
    assert tleaves[".rad_cache.age"].dtype == np.int32
    close_dicts(as_np(tdiag), as_np(jdiag), rtol, "step diagnostics")
    close_dicts(as_np(tm.diagnostics(ts)), as_np(jr.model.diagnostics(js)), rtol, "diagnostics")
    ext = jax.jit(lambda s: jr.model.diag_fields(s, extended=True))(js)
    close_dicts(as_np(tm.diag_fields(ts, extended=True)), as_np(ext), rtol, "extended")
    if case == "frierson_test_case":
        assert "udt_rdamp" in tdiag       # the Rayleigh sponge ran
        assert float(np.ptp(tleaves[".t_surf"])) > 10.0    # prescribed initial SSTs
    if case == "rrtm_grey":
        assert float(tdiag["swdn_sfc"].max()) > 100.0      # the sun is up somewhere


def test_three_steps_float32_match_isca_tpu(jax_runners):
    """3 float32 steps from cold start: the port's float32 run is as accurate
    as isca_tpu's, to within 3x, on every field (its largest difference from
    isca_tpu's float64 run within 3x isca_tpu's own float32-versus-float64
    difference). Measured at T21L8: at most 2.6x (div, at the top level of
    the northernmost row). The port's and isca_tpu's float32 runs differ
    from each other by up to 3.6x isca_tpu's own gap there (div; vcomp 2.9x,
    vor 2.8x): the analysis of phi+KE (~1e5 m^2/s^2, cancelling sums)
    rounds 1.3x worse in MKL's sgemm than in XLA's dot, and the implicit
    solve carries it into the divergence. No convection threshold is
    involved: neither run rains in these 3 steps."""
    j32, j64 = (jax_runner(jax_runners, "frierson", d) for d in (jnp.float32, jnp.float64))
    ref32 = as_np(j32.model.diag_fields(j32.run(3)[0]))
    ref64 = as_np(j64.model.diag_fields(j64.run(3)[0]))
    tm = port_model("frierson", torch.float32)
    ts = tm.run(tm.initial_state(), 3)
    assert ts.dyn.tg.curr.dtype == torch.float32 and ts.time_seconds.dtype == torch.float32
    got = as_np(tm.diag_fields(ts))
    assert set(got) == set(ref32) and {"sphum", "t_surf"} <= set(got)
    for k in ref32:
        ref_err = float(np.abs(ref32[k].astype(np.float64) - ref64[k]).max())
        err = float(np.abs(got[k].astype(np.float64) - ref64[k]).max())
        assert ref_err > 0 and err <= 3.0 * ref_err, (k, err, ref_err)


# ---------------------------------------------------------------------------
# restarts, state conversion, CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["isca_tpu", "isca_tpu_torch"])
def test_restart_interchange(jax_runners, tmp_path, writer):
    jr = jax_runner(jax_runners, "frierson")
    tm = port_model("frierson")
    path = str(tmp_path / "res.npz")
    if writer == "isca_tpu":
        js, _ = jr.run(2)
        jrestart.save_restart(path, js)
        loaded = trestart.load_restart(path, tm.initial_state())
        close_dicts({k: v.numpy() for k, v in flatten_with_paths(loaded)}, jax_leaves(js),
                    0.0, "restart")
        # and the port continues from it as isca_tpu does
        after = tm.step(loaded)
        js2, _ = jr.rest(js)
        close_dicts({k: v.numpy() for k, v in flatten_with_paths(after)}, jax_leaves(js2),
                    1e-9, "continued")
    else:
        ts = tm.run(tm.initial_state(), 2)
        trestart.save_restart(path, ts)
        loaded = jrestart.load_restart(path, jr.model.initial_state())
        close_dicts(jax_leaves(loaded), {k: v.numpy() for k, v in flatten_with_paths(ts)},
                    0.0, "restart")


def test_convert_round_trip_and_missing_key():
    tm = port_model("frierson")
    state = tm.run(tm.initial_state(), 2)
    d = grey_moist_state_to_numpy(state)
    assert set(d) == set(GREY_MOIST_STATE_KEYS)
    assert d["time_seconds"].dtype == np.float32 and d["time_seconds"].shape == ()
    assert d["rad_cache_age"].dtype == np.int32 and d["vors_curr"].dtype == np.complex128
    back = grey_moist_state_to_numpy(grey_moist_state_from_numpy(d, torch.float64, device="cpu"))
    for k in GREY_MOIST_STATE_KEYS:
        np.testing.assert_array_equal(back[k], d[k], err_msg=k)
        assert back[k].dtype == d[k].dtype, k
    s32 = grey_moist_state_from_numpy(d, torch.float32, device="cpu")
    assert s32.dyn.tracers["sphum"].curr.dtype == torch.float32
    assert s32.time_seconds.dtype == torch.float32 and s32.rad_cache.age.dtype == torch.int32
    del d["sphum_prev"]
    with pytest.raises(KeyError, match="sphum_prev"):
        grey_moist_state_from_numpy(d, torch.float64, device="cpu")


def test_cold_start_shares_time_levels_and_is_not_written():
    """Cold start hands one tensor to both time levels; a step must leave it
    as it was."""
    tm = port_model("frierson")
    s = tm.initial_state()
    assert s.dyn.tracers["sphum"].prev is s.dyn.tracers["sphum"].curr
    before = {k: v.copy() for k, v in grey_moist_state_to_numpy(s).items()}
    tm.step(s, first=True)
    for k, v in grey_moist_state_to_numpy(s).items():
        np.testing.assert_array_equal(v, before[k], err_msg=k)


def test_cli_frierson(tmp_path):
    from scipy.io import netcdf_file

    argv = ["frier", "--model", "frierson", "--resolution", "T21", "--levels", "8",
            "--dt", "2400", "--days", "1", "--daily", "--device", "cpu",
            "--datadir", str(tmp_path)]
    assert tmain.main(argv) == 0
    model = tmain.build_model(tmain.argparse.Namespace(
        model="frierson", resolution="T21", levels=8, dt=2400.0, device="cpu"))
    assert isinstance(model, tmoist.GreyMoistModel)
    with netcdf_file(str(tmp_path / "frier" / "run0001" / "atmos_daily.nc"), mmap=False) as nc:
        temp = np.array(nc.variables["temp"][:])
    assert temp.shape == (1, 8, 32, 64) and np.isfinite(temp).all()
    assert (tmp_path / "frier" / "restarts" / "res0001.npz").exists()


def test_configs_mirror_isca_tpu():
    """Same fields and defaults as isca_tpu's (dtype aside) for the model's
    own configurations."""
    pairs = [(jmoist.GreyMoistConfig, tmoist.GreyMoistConfig)]
    for jcls, tcls in pairs:
        jf = {f.name: f.default for f in dataclasses.fields(jcls)}
        tf = {f.name: f.default for f in dataclasses.fields(tcls)}
        assert list(tf) == list(jf)
        for k in ("initial_sphum", "t_surf_init", "sphum_vert_scheme"):
            assert tf[k] == jf[k], k
    jd, td = jmoist.GreyMoistConfig().core, tmoist.GreyMoistConfig().core
    for f in dataclasses.fields(jd):
        if f.name not in ("dtype", "constants"):
            assert getattr(td, f.name) == getattr(jd, f.name), f.name
    assert tmoist.FRIERSON_BK == jmoist.FRIERSON_BK
    jml_f = [f.name for f in dataclasses.fields(jml.MixedLayerConfig)]
    tml_f = [f.name for f in dataclasses.fields(tml.MixedLayerConfig)]
    assert set(tml_f) <= set(jml_f) and {"prescribe_initial_dist", "delta_T"} <= set(tml_f)


def test_unported_options_raise():
    cfg = config(TORCH, "frierson", torch.float64)
    for phys in (dict(convection_scheme="FULL_BETTS_MILLER"), dict(convection_scheme="RAS"),
                 dict(do_damping=True, damping=tdd.DampingDriverConfig(do_topo_drag=True)),
                 dict(do_damping=True, damping=tdd.DampingDriverConfig(do_mg_drag=True)),
                 dict(do_damping=True, damping=tdd.DampingDriverConfig(do_cg_drag=True)),
                 dict(bl_scheme="mellor_yamada"), dict(bl_scheme="edt"),
                 dict(do_shallow_conv=True), dict(do_cloud_simple=True)):
        with pytest.raises(NotImplementedError):
            tmoist.GreyMoistModel(dataclasses.replace(
                cfg, physics=dataclasses.replace(cfg.physics, **phys)), device="cpu")
    dt_rad = dataclasses.replace(cfg, physics=dataclasses.replace(cfg.physics, dt_rad=3600.0))
    m = tmoist.GreyMoistModel(dt_rad, device="cpu")
    with pytest.raises(NotImplementedError, match="dt_rad"):
        m.step(m.initial_state(), first=True)
    # the SST series hook of the driver is not ported (ROADMAP A.5b)
    m = tmoist.GreyMoistModel(cfg, device="cpu")
    m.physics.sst_series = object()
    with pytest.raises(NotImplementedError, match="sst_series"):
        m.step(m.initial_state(), first=True)
