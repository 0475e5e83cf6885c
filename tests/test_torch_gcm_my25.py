"""The GCM with the MY2.5 and stable-BL boundary layers: isca_tpu_torch's
GreyMoistModel against isca_tpu's over 10 steps at float64.

* frierson_test_case_config() with bl_scheme="mellor_yamada", cut to T21L8,
  from the cold start (the surface is warmer than the isothermal air, so
  the TKE grows): every leaf of the state (the TKE on its L+1 half levels
  among them) and the last step's physics diagnostics (tke, el0, z_pbl) at
  rtol 1e-9 of each field's largest entry.
* MY2.5's TKE through restarts both ways: isca_tpu's state after 4 steps,
  written by isca_tpu, loaded by the port and run 6 more steps, equals
  isca_tpu's 10-step run (rtol 1e-9), and the port's 4-step state loads in
  isca_tpu bit for bit.
* bl_scheme="stable_bl" with do_shallow_conv from
  isca_tpu_torch/models/cases.py's convective start (moist enough for
  shallow convection to act): the same comparison, akhsc among the
  diagnostics.
"""

import pathlib
import sys

import numpy as np
import torch

from isca_tpu.io import restart as jrestart
from isca_tpu.models import moist as jmoist
from isca_tpu_torch.io import restart as trestart
from isca_tpu_torch.models import cases
from isca_tpu_torch.models import moist as tmoist
from isca_tpu_torch.utils.tree import flatten_with_paths

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
from tests.test_torch_gcm_ras import (  # noqa: E402,F401
    GCM_RTOL, T21L8, JaxRunner, close_dicts, compare_runs, jax_leaves, one_torch_thread,
    shared_start, to_jax)


def models(scheme):
    tcfg = cases.ras_bl_config(torch.float64, scheme, **T21L8)
    return tmoist.GreyMoistModel(tcfg, device="cpu"), jmoist.GreyMoistModel(to_jax(tcfg))


def test_my25_gcm_matches_isca_tpu_and_restarts_both_ways(tmp_path):
    tm, jm = models("mellor_yamada")
    jr = JaxRunner(jm)
    ts, tdiag = compare_runs(tm, tm.initial_state(), jr, jm.initial_state())
    assert float(ts.tke.max()) > 0.0 and {"tke", "el0", "z_pbl"} <= set(tdiag)

    # isca_tpu writes after 4 steps, the port reads and runs 6 more
    js4, _ = jr.run(jm.initial_state(), 4)
    path = str(tmp_path / "jax4.npz")
    jrestart.save_restart(path, js4)
    ts4 = trestart.load_restart(path, tm.initial_state())
    assert float(ts4.tke.max()) > 0.0
    assert np.array_equal(ts4.tke.numpy(), np.asarray(js4.tke))
    ts10 = tm.run(ts4, 6, first=False)
    js10 = js4
    for _ in range(6):
        js10, _ = jr.rest(js10)
    close_dicts({k: v.numpy() for k, v in flatten_with_paths(ts10)}, jax_leaves(js10),
                GCM_RTOL, "state after the restart")

    # the port writes after 4 steps, isca_tpu reads its state exactly
    ts4p = tm.run(tm.initial_state(), 4)
    path = str(tmp_path / "torch4.npz")
    trestart.save_restart(path, ts4p)
    js4p = jrestart.load_restart(path, jm.initial_state())
    got = jax_leaves(js4p)
    for k, v in flatten_with_paths(ts4p):
        assert np.array_equal(v.numpy(), got[k]), k


def test_stable_bl_shallow_conv_gcm_matches_isca_tpu(tmp_path):
    tm, jm = models("stable_bl")
    assert tm.config.physics.do_shallow_conv
    ts, js = shared_start(tm, jm, cases.convective_start(tm), tmp_path)
    ts, tdiag = compare_runs(tm, ts, JaxRunner(jm), js)
    assert float(tdiag["akhsc"].max()) > 0.0 and float(tdiag["z_pbl"].max()) > 0.0
