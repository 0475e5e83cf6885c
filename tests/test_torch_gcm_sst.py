"""The SOCRATES driver with the ozone series, and the continents_sst GCM:
isca_tpu_torch against isca_tpu.

* One driver call at float64 with all four series of
  isca_tpu_torch/models/cases.py, as in tests/test_torch_series.py, with
  SOCRATES at float64 in both packages (its gas optics take the ozone
  field): every tendency and diagnostic at rtol 1e-10 of each field's
  largest entry.
* The continents_sst GCM (realistic continents with the bucket, hprime
  300 m over land and do_mg_drag, prescribed ocean SSTs and sea ice) cut to
  T21L8, 10 steps from cold start at float64: every leaf of the state and
  the last step's diagnostics (albedo, udt_gwd) at rtol 1e-9 of each
  field's largest entry; the ocean's surface temperature equals the series,
  the land's does not.
"""

import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import torch

from isca_tpu.models import moist as jmoist
from isca_tpu_torch.models import cases
from isca_tpu_torch.models import moist as tmoist

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
from tests.test_torch_gcm_ras import (  # noqa: E402,F401
    JaxRunner, compare_runs, jax_series, one_torch_thread, to_jax)
from tests.test_torch_series import compare_driver_call  # noqa: E402


def test_driver_with_all_series_matches_socrates():
    got, tp, _, _ = compare_driver_call("socrates")
    assert tp.radiation.o3_field is not None and float(got.diagnostics["olr"].min()) > 0.0



def test_continents_sst_gcm_matches_isca_tpu():
    tcfg = cases.continents_config(torch.float64, True, resolution="T21", num_levels=8)
    tm = cases.set_continents(tmoist.GreyMoistModel(tcfg, device="cpu"))
    jm = jmoist.GreyMoistModel(to_jax(tcfg))
    land, topo = cases.continents_land(tm)
    jm.set_land(land, surf_geopotential=topo)
    jm.physics.hprime = jnp.where(jnp.asarray(land) > 0.5, cases.HPRIME_LAND, 0.0)
    lat, nlon = np.degrees(tm.core.T.lats.numpy()), tm.core.T.nlon
    jm.physics.sst_series = jax_series(cases.sst_fields(lat, nlon, cases.SEED + 2))
    jm.physics.ice_series = jax_series(cases.ice_fields(lat, nlon, cases.SEED + 3))
    assert tm.config.physics.bucket and tm.config.physics.damping.do_mg_drag
    ts, tdiag = compare_runs(tm, tm.initial_state(), JaxRunner(jm), jm.initial_state())
    assert float(tdiag["udt_gwd"].abs().max()) > 0.0 and "albedo" in tdiag
    ocean = land < 0.5
    sst = tm.physics.sst_series.at(ts.time_seconds - tm.config.core.dt).numpy()
    np.testing.assert_allclose(ts.t_surf.numpy()[ocean], sst[ocean], rtol=1e-12)
    assert not np.allclose(ts.t_surf.numpy()[~ocean], sst[~ocean], atol=0.5)
