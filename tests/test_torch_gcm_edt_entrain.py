"""The GCM with the EDT and entrain boundary layers: isca_tpu_torch's
GreyMoistModel against isca_tpu's over 10 steps at float64.

frierson_test_case_config() with bl_scheme="edt" and "entrain", cut to
T21L8, from the cold start (the surface is warmer than the isothermal air,
so both schemes find convective layers): every leaf of the state and the
last step's physics diagnostics (z_pbl, tke_edt, wentr_pbl) at rtol 1e-9 of
each field's largest entry.
"""

import pathlib
import sys

import pytest
import torch

from isca_tpu.models import moist as jmoist
from isca_tpu_torch.models import cases
from isca_tpu_torch.models import moist as tmoist

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
from tests.test_torch_gcm_ras import (  # noqa: E402,F401
    T21L8, JaxRunner, compare_runs, one_torch_thread, to_jax)


@pytest.mark.parametrize("scheme,diag", [("edt", "tke_edt"), ("entrain", "wentr_pbl")])
def test_bl_gcm_matches_isca_tpu(scheme, diag):
    tcfg = cases.ras_bl_config(torch.float64, scheme, **T21L8)
    tm = tmoist.GreyMoistModel(tcfg, device="cpu")
    jm = jmoist.GreyMoistModel(to_jax(tcfg))
    ts, tdiag = compare_runs(tm, tm.initial_state(), JaxRunner(jm), jm.initial_state())
    assert float(tdiag["z_pbl"].max()) > 0.0 and float(tdiag[diag].max()) > 0.0
