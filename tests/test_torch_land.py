"""Land, topography, bucket hydrology and time series in isca_tpu_torch
against isca_tpu.

* utils/land_generator (the port's numpy copy) in every land and topography
  mode, exactly; write_land read back through load_topography;
* utils/topography: gaussian_topography and land_mask exactly,
  band_limit_topography (rtol 1e-12), regularize_topography and
  smooth_ocean_topography (rtol 1e-10);
* utils/input_files: regrid_conservative, topog_stats and load_topography
  (both its same-grid and its regridding branch) exactly, on NetCDF files
  written with scipy under tmp_path;
* utils/time_interp: TimeSeries (periodic and not, from a float32 clock
  tensor and from numbers), monthly_climatology, from_netcdf,
  interp_pressure and load_pressure_climatology (zonal-mean and lat-lon
  files) at float64, rtol 1e-12; the loaders and the threefry key default
  to CUDA, and a CO2 series off the model's device raises;
* GreyMoistModel.set_land: the surface geopotential from metres and from
  m^2/s^2, zsurf, the warning above 9500 m and the unit check;
* the bucket: its land-aware initial depth, leapfrog and cap;
* 10 steps at T21L8 float64 against isca_tpu (rtol 1e-9, every leaf) in the
  bucket_model, realistic_continents_topo and variable_co2_grey
  configurations of tools/trip_test.py and in one with the land options of
  the driver and the mixed layer; restarts of the bucket-land model
  interchange both ways;
* the bucket_model, realistic_continents_fixed_sst,
  realistic_continents_variable_qflux, realistic_continents_topo and
  variable_co2_grey trip goldens over 2 model days (RTOL 1e-7).
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
from scipy.io import netcdf_file

from isca_tpu.io import restart as jrestart
from isca_tpu.models import moist as jmoist
from isca_tpu.physics import mixed_layer as jml
from isca_tpu.physics import moist_driver as jmd
from isca_tpu.physics import surface_flux as jsf
from isca_tpu.spectral import transforms as jtr
from isca_tpu.utils import input_files as jin
from isca_tpu.utils import land_generator as jland
from isca_tpu.utils import time_interp as jti
from isca_tpu.utils import topography as jtopo
from isca_tpu_torch.dycore.primitive import PrimitiveConfig as TPC
from isca_tpu_torch.io import restart as trestart
from isca_tpu_torch.models import moist as tmoist
from isca_tpu_torch.physics import mixed_layer as tml
from isca_tpu_torch.physics import moist_driver as tmd
from isca_tpu_torch.physics import surface_flux as tsf
from isca_tpu_torch.physics import two_stream_gray as ttsg
from isca_tpu_torch.spectral import transforms as ttr
from isca_tpu_torch.utils import input_files as tin
from isca_tpu_torch.utils import land_generator as tland
from isca_tpu_torch.utils import time_interp as tti
from isca_tpu_torch.utils import topography as ttopo
from isca_tpu_torch.utils.tree import flatten_with_paths

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
from tools import trip_test  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Eager T21 steps are many small ops: one intra-op thread runs them
    faster and leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tables():
    """T21 transforms of both packages and the grid in degrees."""
    JT = jtr.make_transforms("T21", dtype=jnp.float64)
    TT = ttr.make_transforms("T21", dtype=torch.float64, device="cpu")
    return JT, TT, np.degrees(TT.lats.numpy()), np.degrees(TT.lons.numpy())


def close(got, want, rtol, what=""):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max(initial=0.0),
                               err_msg=what)


# ---------------------------------------------------------------------------
# land generator, topography, input files
# ---------------------------------------------------------------------------

LAND_CASES = [
    dict(land_mode="square"),
    dict(land_mode="square", boundaries=(-30.0, 10.0, 100.0, 200.0)),
    dict(land_mode="continents", topo_mode="sauliere2012"),
    dict(land_mode="continents", continents=("NA", "EA", "OZ"), topo_mode="sauliere2012",
         mountains=("tibet",)),
    dict(land_mode="continents_old", topo_mode="gaussian"),
    dict(land_mode="none", topo_mode="gaussian", topo_gauss=(20.0, 90.0, 25.0, 8.0, 2000.0),
         waterworld=True),
]


@pytest.mark.parametrize("kw", LAND_CASES)
def test_generate_land_matches_isca_tpu(tables, kw):
    _, _, lats, lons = tables
    for got, want in zip(tland.generate_land(lats, lons, **kw), jland.generate_land(lats, lons, **kw)):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        tland.generate_land(lats, lons, land_mode="islands")


def test_write_land_reads_back(tables, tmp_path):
    _, _, lats, lons = tables
    land, topo = tland.write_land(tmp_path / "land.nc", lats, lons, land_mode="continents",
                                  topo_mode="sauliere2012")
    for var, want in (("zsurf", topo), ("land_mask", land)):
        got = tin.load_topography(str(tmp_path / "land.nc"), lats, lons, var=var)
        np.testing.assert_array_equal(got, want.astype(np.float32))
        np.testing.assert_array_equal(
            got, jin.load_topography(str(tmp_path / "land.nc"), lats, lons, var=var))


def test_gaussian_topography_and_land_mask_match_isca_tpu(tables):
    _, _, lats, lons = tables
    for kw in (dict(), dict(height=2500.0, olon=300.0, olat=-20.0, rlon=10.0, rlat=5.0)):
        np.testing.assert_array_equal(ttopo.gaussian_topography(lons, lats, **kw),
                                      jtopo.gaussian_topography(lons, lats, **kw))
    for kw in (dict(), dict(land_mode="continents"), dict(land_mode="continents",
                                                          continents=("AF", "IND")),
               dict(land_mode="none")):
        np.testing.assert_array_equal(ttopo.land_mask(lons, lats, **kw),
                                      jtopo.land_mask(lons, lats, **kw))


@pytest.mark.parametrize("passes,fraction", [(0, 0.0), (2, 0.02), (5, 0.1)])
def test_band_limit_topography_matches_isca_tpu(tables, passes, fraction):
    JT, TT, lats, lons = tables
    _, topo = jland.generate_land(lats, lons, "continents", topo_mode="sauliere2012")
    got = ttopo.band_limit_topography(TT, topo, n_smooth_passes=passes, smooth_fraction=fraction)
    assert got.dtype == torch.float64 and got.device.type == "cpu"
    close(got, jtopo.band_limit_topography(JT, topo, n_smooth_passes=passes,
                                           smooth_fraction=fraction), 1e-12)


def test_ocean_topography_smoothing_matches_isca_tpu(tables):
    JT, TT, lats, lons = tables
    land, topo = jland.generate_land(lats, lons, "continents", topo_mode="sauliere2012")
    got, frac = ttopo.regularize_topography(TT, topo, 1.0 - land, 1.0e-7)
    want, jfrac = jtopo.regularize_topography(JT, topo, 1.0 - land, 1.0e-7)
    close(got, want, 1e-10)
    assert abs(frac - jfrac) <= 1e-10
    got, lam, frac = ttopo.smooth_ocean_topography(TT, topo, 1.0 - land)
    want, jlam, jfrac = jtopo.smooth_ocean_topography(JT, topo, 1.0 - land)
    close(got, want, 1e-10)
    assert abs(lam - jlam) <= 1e-10 * jlam and abs(frac - jfrac) <= 1e-10
    assert abs(frac - 0.93) < 1e-3


def _write_nc(path, lat, lon, **fields):
    with netcdf_file(str(path), "w") as nc:
        nc.createDimension("lat", len(lat))
        nc.createDimension("lon", len(lon))
        for name, vals in (("lat", lat), ("lon", lon)):
            nc.createVariable(name, "f8", (name,))[:] = vals
        for name, vals in fields.items():
            nc.createVariable(name, "f8", ("lat", "lon"))[:] = vals


def test_regrid_conservative_and_topog_stats_match_isca_tpu(tables, tmp_path):
    _, _, lats, lons = tables
    rng = np.random.default_rng(4)
    fine_lat = np.linspace(89.5, -89.5, 180)          # north to south, as ERA files
    fine_lon = np.arange(0.0, 360.0, 1.0)
    z = np.maximum(rng.normal(200.0, 900.0, (180, 360)), -50.0)
    for got, want in zip(tin.regrid_conservative(fine_lat, fine_lon, z, lats, lons),
                         jin.regrid_conservative(fine_lat, fine_lon, z, lats, lons)):
        np.testing.assert_array_equal(got, want)
    _write_nc(tmp_path / "topo.nc", fine_lat, fine_lon, zsurf=z)
    got = tin.topog_stats(str(tmp_path / "topo.nc"), lats, lons)
    want = jin.topog_stats(str(tmp_path / "topo.nc"), lats, lons)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert 0.0 < got[2].mean() < 1.0                  # a land fraction
    np.testing.assert_array_equal(
        tin.load_topography(str(tmp_path / "topo.nc"), lats, lons),
        jin.load_topography(str(tmp_path / "topo.nc"), lats, lons))


# ---------------------------------------------------------------------------
# time series
# ---------------------------------------------------------------------------

YEAR = 360 * 86400.0
TIMES = [0.0, 3.0e6, 14.5 * 86400.0, 200.0 * 86400.0, 359.9 * 86400.0, 400.0 * 86400.0]


def both_series(periodic, rng):
    data = rng.normal(size=(5, 3, 4))
    times = np.array([10.0, 50.0, 100.0, 250.0, 340.0]) * 86400.0
    jts = jti.TimeSeries(data=jnp.asarray(data), times=jnp.asarray(times), periodic=periodic,
                         period_seconds=YEAR)
    tts = tti.TimeSeries(data=torch.as_tensor(data), times=torch.as_tensor(times),
                         periodic=periodic, period_seconds=YEAR)
    return jts, tts


@pytest.mark.parametrize("periodic", [True, False])
def test_time_series_matches_isca_tpu(periodic):
    jts, tts = both_series(periodic, np.random.default_rng(5))
    for t in TIMES:
        want = jts.at(t)
        close(tts.at(t), want, 1e-12, f"t={t}")
        # from the model's float32 clock tensor, as the driver calls it
        t32 = np.float32(t)
        close(tts.at(torch.tensor(t32)), jts.at(jnp.asarray(t32)), 1e-12, f"t32={t}")


def test_monthly_climatology_and_from_netcdf_match_isca_tpu(tmp_path):
    rng = np.random.default_rng(6)
    fields = rng.normal(size=(12, 4, 6))
    jc = jti.monthly_climatology(fields, dtype=jnp.float64)
    tc = tti.monthly_climatology(fields, dtype=torch.float64, device="cpu")
    close(tc.times, jc.times, 0.0)
    for t in TIMES:
        close(tc.at(t), jc.at(t), 1e-12)
    with netcdf_file(str(tmp_path / "co2.nc"), "w") as nc:
        nc.createDimension("time", 4)
        nc.createVariable("time", "f8", ("time",))[:] = [0.0, 100.0, 200.0, 400.0]
        nc.createVariable("co2", "f8", ("time",))[:] = [280.0, 300.0, 350.0, 560.0]
    jf = jti.from_netcdf(str(tmp_path / "co2.nc"), "co2", dtype=jnp.float64)
    tf = tti.from_netcdf(str(tmp_path / "co2.nc"), "co2", dtype=torch.float64, device="cpu")
    for t in TIMES:
        close(tf.at(t), jf.at(t), 1e-12)


def test_interp_pressure_matches_isca_tpu():
    rng = np.random.default_rng(7)
    plevs = np.array([1.0e3, 5.0e3, 2.0e4, 5.0e4, 8.5e4, 1.0e5])
    field = rng.normal(size=(3, 4, 6))
    p_full = np.sort(rng.uniform(5.0e2, 1.02e5, (3, 4, 9)), axis=-1)
    close(tti.interp_pressure(torch.as_tensor(field), torch.as_tensor(plevs),
                              torch.as_tensor(p_full)),
          jti.interp_pressure(jnp.asarray(field), plevs, jnp.asarray(p_full)), 1e-12)


@pytest.mark.parametrize("zonal", [True, False])
def test_load_pressure_climatology_matches_isca_tpu(tables, tmp_path, zonal):
    _, _, lats, lons = tables
    rng = np.random.default_rng(8)
    lat_in, lon_in = np.linspace(-90.0, 90.0, 19), np.arange(0.0, 360.0, 30.0)
    p_in = np.array([1000.0, 500.0, 100.0, 10.0])      # hPa, decreasing
    shape = (12, 4, 19) if zonal else (12, 4, 19, 12)
    path = tmp_path / "o3.nc"
    with netcdf_file(str(path), "w") as nc:
        for name, vals in (("time", np.arange(12.0)), ("pfull", p_in), ("lat", lat_in)) + (
                () if zonal else (("lon", lon_in),)):
            nc.createDimension(name, len(vals))
            nc.createVariable(name, "f8", (name,))[:] = vals
        dims = ("time", "pfull", "lat") if zonal else ("time", "pfull", "lat", "lon")
        nc.createVariable("ozone", "f8", dims)[:] = rng.uniform(1e-7, 1e-5, shape)
    jp = jti.load_pressure_climatology(str(path), "ozone", lats, lons, dtype=jnp.float64)
    tp = tti.load_pressure_climatology(str(path), "ozone", lats, lons, dtype=torch.float64,
                                       device="cpu")
    close(tp.plevs, jp.plevs, 0.0)
    p_full = np.broadcast_to(np.linspace(2.0e3, 9.5e4, 5), (32, 64, 5)).copy()
    for t in (0.0, 40.0 * 86400.0, 355.0 * 86400.0):
        close(tp.at(t, torch.as_tensor(p_full)), jp.at(t, jnp.asarray(p_full)), 1e-12)


@pytest.mark.parametrize("loader", ["monthly_climatology", "from_netcdf",
                                    "load_pressure_climatology", "prng_key"])
def test_loaders_default_to_cuda(monkeypatch, tmp_path, loader):
    """device=None is CUDA, as for every entry point of the port: with no
    card the loaders raise rather than build on the CPU."""
    from isca_tpu_torch.utils import threefry

    path = tmp_path / "x.nc"
    with netcdf_file(str(path), "w") as nc:
        for name, vals in (("time", np.arange(12.0)), ("pfull", [1000.0, 10.0]),
                           ("lat", [-45.0, 45.0])):
            nc.createDimension(name, len(vals))
            nc.createVariable(name, "f8", (name,))[:] = vals
        nc.createVariable("x", "f8", ("time", "pfull", "lat"))[:] = np.ones((12, 2, 2))
    call = {
        "monthly_climatology": lambda: tti.monthly_climatology(np.ones(12)),
        "from_netcdf": lambda: tti.from_netcdf(str(path), "x"),
        "load_pressure_climatology": lambda: tti.load_pressure_climatology(
            str(path), "x", np.zeros(2), np.zeros(3)),
        "prng_key": lambda: threefry.prng_key(0),
    }[loader]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        call()


# ---------------------------------------------------------------------------
# the GCM with land: configurations of tools/trip_test.py
# ---------------------------------------------------------------------------

TRIP_CORE = dict(resolution="T21", num_levels=8, dt=1200.0, vert_coord_option="uneven_sigma",
                 vert_coord_kwargs=(("scale_heights", 6.0), ("surf_res", 0.5),
                                    ("exponent", 7.5)),
                 do_water_correction=True, water_correction_limit=200.0e2, robert_coeff=0.03)
GOLDEN_CASES = ["bucket_model", "realistic_continents_fixed_sst",
                "realistic_continents_variable_qflux", "realistic_continents_topo",
                "variable_co2_grey"]


def physics_kw(pkg, case):
    """The trip test's physics options for `case`, and whether it takes the
    square land mask (tools/trip_test.py build_*); "land_options" adds the
    land options of the driver, surface fluxes and mixed layer."""
    ml, tsg, sf = pkg["ml"], pkg["tsg"], pkg["sf"]
    return {
        "bucket_model": (dict(bucket=True), True),
        "realistic_continents_fixed_sst": (dict(mixed_layer=ml.MixedLayerConfig(
            do_ape_sst=True)), True),
        "realistic_continents_variable_qflux": (dict(mixed_layer=ml.MixedLayerConfig(
            do_qflux=True, qflux_amp=30.0)), True),
        "realistic_continents_topo": (dict(bucket=True), False),
        "variable_co2_grey": (dict(radiation=tsg.TwoStreamConfig(rad_scheme="byrne")), False),
        "land_options": (dict(
            bucket=True, land_roughness_prefactor=2.0, max_bucket_depth_land=0.2,
            init_bucket_depth_land=0.1,
            surface=sf.SurfaceFluxConfig(land_humidity_prefactor=0.7, land_evap_prefactor=0.8),
            mixed_layer=ml.MixedLayerConfig(land_option="input", land_h_capacity_prefactor=0.1,
                                            land_albedo_prefactor=1.5)), False),
    }[case]


def co2_ramp(data, times, series_cls):
    return series_cls(data=data([300.0, 600.0]), times=times([0.0, YEAR]), periodic=False,
                      period_seconds=0.0)


def build(pkg, case):
    """A GreyMoistModel of either package for `case`, its land attached."""
    phys, square = physics_kw(pkg, case)
    is_jax = pkg["name"] == "jax"
    dtype = jnp.float64 if is_jax else torch.float64
    cfg = pkg["moist"].GreyMoistConfig(core=pkg["core"](dtype=dtype, **TRIP_CORE),
                                       physics=pkg["md"].MoistPhysicsConfig(**phys))
    model = pkg["moist"].GreyMoistModel(cfg) if is_jax else \
        pkg["moist"].GreyMoistModel(cfg, device="cpu")
    T = model.core.T
    lats, lons = np.degrees(np.asarray(T.lats)), np.degrees(np.asarray(T.lons))
    if square:
        mask, _ = pkg["land"].generate_land(lats, lons, land_mode="square")
        model.set_land(mask)
    elif case in ("realistic_continents_topo", "land_options"):
        land, topo = pkg["land"].generate_land(lats, lons, "continents",
                                               topo_mode="sauliere2012")
        topo = pkg["topo"].band_limit_topography(T, np.asarray(topo, np.float64),
                                                 n_smooth_passes=2, smooth_fraction=0.02)
        model.set_land(land, surf_geopotential=topo)
    if case == "variable_co2_grey":
        f = (lambda x: jnp.asarray(x)) if is_jax else (
            lambda x: torch.tensor(x, dtype=torch.float64))
        model.physics.co2_series = co2_ramp(f, f, pkg["ti"].TimeSeries)
    return model


JAX = dict(name="jax", moist=jmoist, md=jmd, ml=jml, sf=jsf, land=jland, topo=jtopo, ti=jti,
           tsg=__import__("isca_tpu.physics.two_stream_gray", fromlist=["x"]),
           core=__import__("isca_tpu.dycore.primitive", fromlist=["x"]).PrimitiveConfig)
TORCH = dict(name="torch", moist=tmoist, md=tmd, ml=tml, sf=tsf, land=tland, topo=ttopo,
             ti=tti, tsg=ttsg, core=TPC)


class JaxRunner:
    def __init__(self, case):
        self.model = build(JAX, case)
        self.first = jax.jit(lambda s: self.model.step(s, first=True))
        self.rest = jax.jit(self.model.step)

    def run(self, steps):
        s = self.first(self.model.initial_state())
        for _ in range(steps - 1):
            s = self.rest(s)
        return s


@pytest.fixture(scope="module")
def jax_runners():
    return {}


def jax_runner(jax_runners, case):
    if case not in jax_runners:
        jax_runners[case] = JaxRunner(case)
    return jax_runners[case]


def jax_leaves(state):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(state)[0]}


def port_leaves(state):
    return {k: v.numpy() for k, v in flatten_with_paths(state)}


def close_dicts(got, ref, rtol, what):
    assert set(got) == set(ref), (what, set(got) ^ set(ref))
    for k, b in ref.items():
        assert got[k].dtype == b.dtype, (what, k)
        close(got[k], b, rtol, f"{what} {k}")


def test_set_land_matches_isca_tpu():
    jm, tm = build(JAX, "realistic_continents_topo"), build(TORCH, "realistic_continents_topo")
    close(tm.surf_geopotential, jm.surf_geopotential, 1e-12, "surf_geopotential")
    close(tm.physics.zsurf, jm.physics.zsurf, 1e-12, "zsurf")
    np.testing.assert_array_equal(tm.land_mask.numpy(), np.asarray(jm.land_mask))
    assert tm.physics.land_mask is tm.land_mask
    assert 1000.0 < float(tm.physics.zsurf.max()) < 6000.0       # metres
    # geopotential given as such, and the guards
    geo = tm.surf_geopotential.clone()
    tm.set_land(tm.land_mask, surf_geopotential=geo, units="m2/s2")
    assert torch.equal(tm.surf_geopotential, geo)
    with pytest.raises(ValueError, match="units"):
        tm.set_land(tm.land_mask, surf_geopotential=geo, units="km")
    with pytest.warns(RuntimeWarning, match="METERS"):
        tm.set_land(tm.land_mask, surf_geopotential=geo)           # g*z taken for metres


def test_bucket_initial_depth_leapfrog_and_cap(jax_runners):
    """Land starts at init_bucket_depth_land and ocean at init_bucket_depth;
    the leapfrog keeps depths >= 0 and caps land at max_bucket_depth_land."""
    tm = build(TORCH, "bucket_model")
    s0 = tm.initial_state()
    land = tm.land_mask.numpy() > 0.5
    assert land.any() and (~land).any()
    pc = tm.config.physics
    np.testing.assert_array_equal(s0.bucket_depth.curr.numpy(),
                                  np.where(land, pc.init_bucket_depth_land, pc.init_bucket_depth))
    s = tm.run(s0, 3)
    depth = s.bucket_depth.curr.numpy()
    assert (depth[land] <= pc.max_bucket_depth_land).all() and (depth >= 0.0).all()
    assert (s.bucket_depth.prev.numpy() >= 0.0).all()
    assert not np.array_equal(depth[~land], s0.bucket_depth.curr.numpy()[~land])
    js = jax_runner(jax_runners, "bucket_model").run(3)
    close(s.bucket_depth.curr, js.bucket_depth.curr, 1e-9, "bucket curr")
    close(s.bucket_depth.prev, js.bucket_depth.prev, 1e-9, "bucket prev")


def test_co2_series_off_the_model_device_raises():
    """A series on another device than the model raises when the driver runs,
    rather than copy the model time there every step."""
    tm = build(TORCH, "variable_co2_grey")
    meta = lambda x: torch.tensor(x, dtype=torch.float64, device="meta")
    tm.physics.co2_series = co2_ramp(meta, meta, tti.TimeSeries)
    with pytest.raises(ValueError, match="co2_series lies on meta"):
        tm.step(tm.initial_state(), first=True)


@pytest.mark.parametrize("case", ["bucket_model", "realistic_continents_topo",
                                  "variable_co2_grey", "land_options"])
def test_ten_steps_match_isca_tpu(jax_runners, case):
    js = jax_runner(jax_runners, case).run(10)
    tm = build(TORCH, case)
    ts = tm.run(tm.initial_state(), 10)
    close_dicts(port_leaves(ts), jax_leaves(js), 1e-9, "state")


@pytest.mark.parametrize("writer", ["isca_tpu", "isca_tpu_torch"])
def test_bucket_land_restart_interchange(jax_runners, tmp_path, writer):
    jr = jax_runner(jax_runners, "bucket_model")
    tm = build(TORCH, "bucket_model")
    path = str(tmp_path / "res.npz")
    if writer == "isca_tpu":
        js = jr.run(2)
        jrestart.save_restart(path, js)
        loaded = trestart.load_restart(path, tm.initial_state())
        close_dicts(port_leaves(loaded), jax_leaves(js), 0.0, "restart")
        close_dicts(port_leaves(tm.step(loaded)), jax_leaves(jr.rest(js)), 1e-9, "continued")
    else:
        ts = tm.run(tm.initial_state(), 2)
        trestart.save_restart(path, ts)
        loaded = jrestart.load_restart(path, jr.model.initial_state())
        close_dicts(jax_leaves(loaded), port_leaves(ts), 0.0, "restart")
        close_dicts(port_leaves(tm.step(ts)), jax_leaves(jr.rest(loaded)), 1e-9, "continued")


@pytest.mark.parametrize("name", GOLDEN_CASES)
def test_two_days_match_trip_goldens(name):
    with open(REPO / "tests" / "goldens" / "trip_goldens.json") as f:
        golden = json.load(f)[name]
    model = build(TORCH, name)
    steps = int(round(trip_test.DAYS * 86400.0 / model.config.core.dt))
    assert steps == 144
    state = model.run(model.initial_state(), steps, first=True)
    got = {k: trip_test.field_stats(v.numpy()) for k, v in sorted(model.diag_fields(state).items())}
    errors = trip_test.compare(name, got, golden)
    assert not errors, "\n".join(errors)


def test_driver_config_mirrors_isca_tpu():
    """The driver's fields of this slice have isca_tpu's names and defaults."""
    jf = {f.name: f.default for f in dataclasses.fields(jmd.MoistPhysicsConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(tmd.MoistPhysicsConfig)}
    assert set(tf) <= set(jf)
    for k in ("bucket", "init_bucket_depth", "init_bucket_depth_land", "max_bucket_depth_land",
              "robert_bucket", "raw_bucket", "land_roughness_prefactor", "gp_surface"):
        assert tf[k] == jf[k], k
