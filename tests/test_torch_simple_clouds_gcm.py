"""The simple_clouds GCM of isca_tpu_torch against isca_tpu's, over 10 steps.

exp/test_cases/simple_clouds_test_case.py as written
(`simple_clouds_test_case_config`: RRTM radiation through RRTMConfig(), so
RRTMG-SW and RRTMG-LW, with SimCloud feeding both cloud optics) cut to
T21L10 and float64, and started moist (a uniform 0.01 kg/kg, so that
SimCloud makes clouds from the first step; the test case's dry start makes
none in 10 steps). Every leaf of the state and the last step's physics
diagnostics at GCM_RTOL = 1e-6 of each field's largest entry, the RRTM GCM's
bound (ROADMAP C.5: XLA's float32 arcsin in the seasonal declination;
measured here: 7.8e-8 at most, in divergence). Each step runs the cloudy RRTMG-SW solve
(sw_flux twice: clear, then total sky) and RRTMG-LW's cloudy sweeps.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isca_tpu.models import moist as jmoist
from isca_tpu.physics import rrtm_radiation as jrr
from isca_tpu.physics import rrtmg_sw as jsw
from isca_tpu_torch.models import moist as tmoist
from isca_tpu_torch.physics import rrtmg_sw as tsw
from tests.test_torch_socrates_gcm import CUT, INITIAL_SPHUM, STEPS, as64, rel_err
from tests.test_torch_socrates_gcm import one_torch_thread  # noqa: F401 (autouse)
from isca_tpu_torch.utils.tree import flatten_with_paths

# the committed LW k-tables are synthetic, and say so at every construction
pytestmark = pytest.mark.filterwarnings("ignore:RRTMG-LW is running on SYNTHETIC")

GCM_RTOL = 1e-6

# isca_tpu's cldprop_sw caches its tables at the first call; made inside a
# jax.jit trace they would be that trace's tracers, and the next trace would
# fail on them (ROADMAP C.9), so the cache is filled here, outside any trace
jsw._CldTables()


def test_simple_clouds_gcm_matches_isca_tpu():
    cfg = jmoist.GreyMoistConfig(initial_sphum=INITIAL_SPHUM)
    jcfg = dataclasses.replace(
        cfg, core=dataclasses.replace(cfg.core, dtype=jnp.float64, **CUT),
        physics=dataclasses.replace(cfg.physics, radiation_scheme="rrtm",
                                    rrtm=jrr.RRTMConfig(), do_cloud_simple=True))
    jm = jmoist.GreyMoistModel(jcfg)
    s = jax.jit(lambda s: jm.step(s, first=True))(jm.initial_state())
    rest = jax.jit(jm.step_with_diagnostics)
    for _ in range(STEPS - 1):
        s, jdiag = rest(s)
    jleaves = {jax.tree_util.keystr(k): as64(v)
               for k, v in jax.tree_util.tree_flatten_with_path(s)[0]}

    tcfg = dataclasses.replace(
        tmoist.simple_clouds_test_case_config(dtype=torch.float64, **CUT),
        initial_sphum=INITIAL_SPHUM)
    tm = tmoist.GreyMoistModel(tcfg, device="cpu")
    assert tm.physics.radiation.lw_rrtmg is not None and tm.physics.cloud is not None
    plain, calls = tsw.sw_flux_solve_reference, []
    tsw.sw_flux_solve_reference = lambda *a, **kw: calls.append(kw.get("cloud")) or plain(
        *a, **kw)
    try:
        ts = tm.run(tm.initial_state(), STEPS - 1)
        ts, tdiag = tm.step_with_diagnostics(ts)
    finally:
        tsw.sw_flux_solve_reference = plain
    # two solves per step, the second with the cloud set
    assert len(calls) == 2 * STEPS and all(c is not None for c in calls[1::2])
    tleaves = dict(flatten_with_paths(ts))
    assert set(tleaves) == set(jleaves) and set(tdiag) == set(jdiag)
    for k, b in jleaves.items():
        assert rel_err(as64(tleaves[k]), b) <= GCM_RTOL, (k, rel_err(as64(tleaves[k]), b))
    for k, b in jdiag.items():
        assert rel_err(as64(tdiag[k]), as64(b)) <= GCM_RTOL, k
    cf = tdiag["cf"].numpy()
    assert cf.max() == 1.0 and ((cf > 0) & (cf < 1)).any()
    assert np.isfinite(tdiag["olr"].numpy()).all()
