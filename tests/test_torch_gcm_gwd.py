"""The MiMA GCM with its damping, the convective gravity-wave drag and the
ozone and q-flux series: isca_tpu_torch against isca_tpu over 10 steps.

isca_tpu_torch/models/cases.py mima_gwd_config() (mima_test_case_config():
RRTMG-SW and RRTMG-LW, seasonal sun, full Betts-Miller; plus mima.nml's
Rayleigh sponge and do_cg_drag) cut to T21L8, with add_mima_series' seeded
12-month ozone climatology on 24 pressure levels (RRTM's o3 input,
interpolated onto the model's pressures each step) and q-flux series; the
same numpy fields feed isca_tpu's TimeSeries. From the cold start at
float64: every leaf of the state and the last step's physics diagnostics
(gwfu_cgwd and udt_rdamp among them) at rtol 1e-6 of each field's largest
entry, the bound of the RRTM GCMs (ROADMAP C.5: XLA's float32 arcsin, one
ulp from torch's, moves the seasonal sun's declination).
"""

import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isca_tpu.models import moist as jmoist
from isca_tpu.utils import time_interp as jti
from isca_tpu_torch.models import cases
from isca_tpu_torch.models import moist as tmoist

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
from tests.test_torch_gcm_ras import (  # noqa: E402,F401
    JaxRunner, compare_runs, jax_series, one_torch_thread, to_jax)

# the committed LW k-tables are synthetic, and say so at every construction
pytestmark = pytest.mark.filterwarnings("ignore:RRTMG-LW is running on SYNTHETIC")
MIMA_RTOL = 1e-6


def mima_l8():
    """T21 with 8 of GreyMoistConfig()'s uneven-sigma levels."""
    return dict(resolution="T21", num_levels=8)


def test_mima_gwd_gcm_matches_isca_tpu():
    tcfg = cases.mima_gwd_config(torch.float64, **mima_l8())
    tm = cases.add_mima_series(tmoist.GreyMoistModel(tcfg, device="cpu"))
    jm = jmoist.GreyMoistModel(to_jax(tcfg))
    assert jm.physics.cg_drag is not None and tm.physics.cg_drag is not None
    assert np.array_equal(tm.physics.cg_drag.source_level.numpy(),
                          np.asarray(jm.physics.cg_drag.source_level))
    lat = np.degrees(tm.core.T.lats.numpy())
    jm.physics.o3_series = jti.PressureTimeSeries(
        series=jax_series(cases.ozone_fields(lat)), plevs=jnp.asarray(cases.O3_PLEVS))
    jm.physics.qflux_series = jax_series(cases.qflux_fields(lat, tm.core.T.nlon,
                                                            cases.SEED + 1))
    ts, tdiag = compare_runs(tm, tm.initial_state(), JaxRunner(jm), jm.initial_state(),
                             rtol=MIMA_RTOL)
    assert float(tdiag["gwfu_cgwd"].abs().max()) > 0.0
    assert {"udt_rdamp", "gwfv_cgwd", "olr"} <= set(tdiag)
    o3 = tm.physics.radiation.o3_field
    assert o3 is not None and o3.shape == ts.dyn.tg.curr.movedim(0, -1).shape
    assert 1e-8 < float(o3.min()) and float(o3.max()) < 3e-5
