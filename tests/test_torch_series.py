"""The moist driver's series hooks in isca_tpu_torch against isca_tpu: the
prescribed SSTs, the sea-ice albedo, the ocean q-flux and the ozone
climatology.

* albedo_with_ice in both methods (rtol 1e-12) and its ValueError.
* One driver call at float64 on tests/test_torch_physics.py's columns, on a
  grid with land, with all four series of isca_tpu_torch/models/cases.py
  (seeded fields, the same numpy values for both packages) and
  update_albedo_from_ice, do_sc_sst and specify_sst_over_ocean_only: the
  ice albedo, the q-flux zeroed over land, the SSTs pinning the ocean and
  the land left to its energy balance; RRTM (grey LW) takes the ozone
  under lonstep 2 (lonstep 1: tests/test_torch_gcm_gwd.py); every
  tendency and diagnostic at rtol 1e-10 of each field's largest entry.
* A series on another device than the model raises ValueError when the
  driver runs (a series on the meta device stands for it).

The same call with SOCRATES and the continents_sst GCM are in
tests/test_torch_gcm_sst.py.
"""

import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isca_tpu.physics import mixed_layer as jml
from isca_tpu.physics import moist_driver as jmd
from isca_tpu.physics import rrtm_radiation as jrr
from isca_tpu.physics import socrates as jsoc
from isca_tpu.utils import time_interp as jti
from isca_tpu_torch.models import cases
from isca_tpu_torch.physics import mixed_layer as tml
from isca_tpu_torch.physics import moist_driver as tmd
from isca_tpu_torch.physics import rrtm_radiation as trr
from isca_tpu_torch.physics import socrates as tsoc
from isca_tpu_torch.utils import time_interp as tti

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
from tests.test_torch_gcm_ras import (  # noqa: E402,F401
    as_np, close_dicts, jax_series, one_torch_thread)
from tests.test_torch_physics import columns  # noqa: E402

pytestmark = pytest.mark.filterwarnings("ignore:RRTMG-LW is running on SYNTHETIC")
TIME = 40.0 * 86400.0          # 40 days in: between the first two months


def T(a):
    return torch.tensor(np.array(a, np.float64))


@pytest.mark.parametrize("method", ["step_function", "ramp_function"])
def test_albedo_with_ice_matches(method):
    rng = np.random.default_rng(4)
    albedo, ice = rng.uniform(0.05, 0.4, (5, 6)), rng.uniform(0.0, 1.0, (5, 6))
    jcfg = jml.MixedLayerConfig(ice_albedo_method=method, ice_albedo_value=0.65)
    tcfg = tml.MixedLayerConfig(ice_albedo_method=method, ice_albedo_value=0.65)
    ref = jml.albedo_with_ice(jcfg, jnp.asarray(albedo), jnp.asarray(ice))
    got = tml.albedo_with_ice(tcfg, T(albedo), T(ice))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12)
    assert (got.numpy() != albedo).any()


def test_albedo_with_ice_rejects_unknown_method():
    with pytest.raises(ValueError, match="ice_albedo_method"):
        tml.albedo_with_ice(tml.MixedLayerConfig(ice_albedo_method="linear"),
                            torch.zeros(2), torch.zeros(2))


def driver_inputs():
    c = columns(3, shape=(4, 6), L=10)
    lats = np.deg2rad(np.array([-75.0, -20.0, 35.0, 80.0]))
    lons = np.deg2rad(np.arange(6) * 60.0)
    land = np.zeros((4, 6))
    land[1:3, 2:4] = 1.0
    args = [c[k] for k in ("u", "v", "t", "q", "p_full", "p_half", "p_full", "p_half",
                           "z_full", "z_half")]
    return c, lats, lons, land, args


def series_fields(lats, nlon):
    lat = np.degrees(lats)
    return dict(o3=cases.ozone_fields(lat), qflux=cases.qflux_fields(lat, nlon),
                sst=cases.sst_fields(lat, nlon), ice=cases.ice_fields(lat, nlon))


def attach(phys, f, land, pkg):
    """The four series, the land mask and hprime on one package's driver."""
    if pkg == "jax":
        arr, ser = jnp.asarray, jax_series
        phys.o3_series = jti.PressureTimeSeries(series=ser(f["o3"]),
                                                plevs=jnp.asarray(cases.O3_PLEVS))
    else:
        arr = T
        ser = lambda x: tti.monthly_climatology(x, cases.YEAR_SECONDS, torch.float64, "cpu")
        phys.o3_series = tti.PressureTimeSeries(series=ser(f["o3"]), plevs=T(cases.O3_PLEVS))
    phys.qflux_series, phys.sst_series, phys.ice_series = (
        ser(f[k]) for k in ("qflux", "sst", "ice"))
    phys.land_mask = arr(land)
    return phys


def physics_kw(pkg, radiation, lonstep=1):
    ml, rr = (jml, jrr) if pkg == "jax" else (tml, trr)
    kw = dict(mixed_layer=ml.MixedLayerConfig(do_sc_sst=True, specify_sst_over_ocean_only=True,
                                              update_albedo_from_ice=True,
                                              ice_albedo_method="ramp_function"))
    if radiation == "rrtm":
        kw.update(radiation_scheme="rrtm",
                  rrtm=rr.RRTMConfig(lw_scheme="grey", lonstep=lonstep, do_seasonal=True))
    else:
        kw.update(radiation_scheme="socrates")
    return kw


def compare_driver_call(radiation, lonstep=1):
    c, lats, lons, land, args = driver_inputs()
    f = series_fields(lats, len(lons))
    jp = jmd.MoistPhysics(jmd.MoistPhysicsConfig(**physics_kw("jax", radiation, lonstep)),
                          jnp.asarray(lats), jnp.asarray(lons))
    tp = tmd.MoistPhysics(tmd.MoistPhysicsConfig(**physics_kw("torch", radiation, lonstep)),
                          T(lats), T(lons))
    if radiation == "socrates":
        jp.radiation = jsoc.SocratesRadiation(jsoc.SocratesConfig(), dtype=jnp.float64)
        tp.radiation = tsoc.SocratesRadiation(tsoc.SocratesConfig(), dtype=torch.float64,
                                              device="cpu")
    attach(jp, f, land, "jax")
    attach(tp, f, land, "torch")
    kw = dict(gmt=1.3, time_since_ae=0.7, time_seconds=TIME)
    ref = jp(1440.0, 720.0, *map(jnp.asarray, args), jnp.asarray(c["t_surf"]), **kw)
    got = tp(1440.0, 720.0, *map(T, args), T(c["t_surf"]), **kw)
    for name in ("dt_u", "dt_v", "dt_t", "dt_q", "t_surf"):
        close_dicts({name: getattr(got, name).numpy()}, {name: np.asarray(getattr(ref, name))},
                    1e-10, "driver")
    close_dicts(as_np(got.diagnostics), as_np(ref.diagnostics), 1e-10, "diagnostics")
    return got, tp, land, f


@pytest.mark.parametrize("lonstep", [2])
def test_driver_with_all_series_matches_rrtm(lonstep):
    got, tp, land, f = compare_driver_call("rrtm", lonstep)
    ocean = land < 0.5
    sst = tp.sst_series.at(TIME).numpy()
    np.testing.assert_allclose(got.t_surf.numpy()[ocean], sst[ocean], rtol=1e-12)
    assert not np.allclose(got.t_surf.numpy()[~ocean], sst[~ocean])
    assert "albedo" in got.diagnostics
    assert tp.radiation.o3_field.shape == (4, 6, 10)
    ice = tp.ice_series.at(TIME).numpy()
    assert ((ice > 0.0) & (ice < 1.0)).any()


@pytest.mark.parametrize("hook", ["sst_series", "ice_series", "qflux_series", "o3_series"])
def test_series_off_the_model_device_raises(hook):
    c, lats, lons, land, args = driver_inputs()
    tp = tmd.MoistPhysics(tmd.MoistPhysicsConfig(**physics_kw("torch", "rrtm")), T(lats),
                          T(lons))
    f = series_fields(lats, len(lons))
    attach(tp, f, land, "torch")
    meta = tti.monthly_climatology(f["qflux"], cases.YEAR_SECONDS, torch.float64, "meta")
    setattr(tp, hook, tti.PressureTimeSeries(series=meta, plevs=torch.ones(3, device="meta"))
            if hook == "o3_series" else meta)
    with pytest.raises(ValueError, match=f"{hook} lies on meta"):
        tp(1440.0, 720.0, *map(T, args), T(c["t_surf"]), time_seconds=TIME)
