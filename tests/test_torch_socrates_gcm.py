"""The SOCRATES aquaplanet GCM of isca_tpu_torch against isca_tpu's, over 10
steps from a cold start, with and without SimCloud.

The configurations are exp/test_cases/socrates_aquaplanet_test_case.py's,
as written (`socrates_aquaplanet_test_case_config`, with and without
--clouds) but cut to T21L10 and float64, and started moist (a uniform
0.01 kg/kg: condensation then saturates the upper levels, and SimCloud makes
clouds there from the first step; the test case's dry start makes none in
10 steps). Every leaf of the state and the
last step's physics diagnostics are compared, each at a tolerance relative
to the field's largest entry:

* With float64 SOCRATES on both sides (a `SocratesRadiation(..., dtype=
  float64)` set as the physics' radiation before the first step; no
  isca_tpu file changes): GCM_RTOL_F64 = 1e-6. What is left is ROADMAP C.5:
  XLA's float32 arcsin, one ulp off torch's, moves the seasonal declination
  taken from the float32 clock (measured here: 1.1e-7 at most, in the SW
  heating).
* As the drivers build it, in float32 inside the float64 model (ROADMAP
  C.8): each field within GAP_FACTOR = 5 times isca_tpu's own difference
  between its float32 and its float64 SOCRATES runs (measured here: 3.6 in
  divergence without clouds, 1.7 with them). The port's float32 SOCRATES
  lies 2-3 times farther from the float64 run than isca_tpu's in the LW
  fluxes and the winds and temperature: its float32 exp, log, pow and sums
  round other than XLA's, and where the difference comes from is not
  split out yet.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isca_tpu.models import moist as jmoist
from isca_tpu.physics import socrates as js
from isca_tpu_torch.models import moist as tmoist
from isca_tpu_torch.physics import socrates as ts
from isca_tpu_torch.utils.tree import flatten_with_paths

STEPS = 10
CUT = dict(resolution="T21", num_levels=10)
# the test case starts dry (2e-6 kg/kg), and makes no cloud in 10 steps
INITIAL_SPHUM = 0.01
GCM_RTOL_F64 = 1e-6
GAP_FACTOR = 5.0


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small ops: one intra-op thread, the cores left to the other
    test workers (as tests/test_torch_moist.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_config(with_clouds):
    """socrates_aquaplanet_test_case.py with isca_tpu's classes, cut as CUT,
    started moist."""
    cfg = jmoist.GreyMoistConfig(initial_sphum=INITIAL_SPHUM)
    return dataclasses.replace(
        cfg, core=dataclasses.replace(cfg.core, dtype=jnp.float64, **CUT),
        physics=dataclasses.replace(
            cfg.physics, radiation_scheme="socrates",
            socrates=js.SocratesConfig(stellar_constant=1370.0, co2_ppmv=300.0),
            do_cloud_simple=with_clouds))


def jax_run(cfg, f64):
    """isca_tpu's GCM over STEPS steps: {path: leaf} of the state and the
    last step's diagnostics."""
    model = jmoist.GreyMoistModel(cfg)
    if f64:
        model.physics.radiation = js.SocratesRadiation(cfg.physics.socrates, dtype=jnp.float64)
    s = jax.jit(lambda s: model.step(s, first=True))(model.initial_state())
    rest = jax.jit(model.step_with_diagnostics)
    for _ in range(STEPS - 1):
        s, diag = rest(s)
    leaves = {jax.tree_util.keystr(k): as64(v)
              for k, v in jax.tree_util.tree_flatten_with_path(s)[0]}
    return leaves, {k: as64(v) for k, v in diag.items()}


def port_run(cfg, f64):
    model = tmoist.GreyMoistModel(cfg, device="cpu")
    if f64:
        model.physics.radiation = ts.SocratesRadiation(
            cfg.physics.socrates, dtype=torch.float64, device="cpu")
    else:
        assert model.physics.radiation.dtype == torch.float32
    s = model.run(model.initial_state(), STEPS - 1)
    s, diag = model.step_with_diagnostics(s)
    leaves = {k: as64(v) for k, v in flatten_with_paths(s)}
    return leaves, {k: as64(v) for k, v in diag.items()}


def as64(x):
    """A leaf as a float64 (or complex128) numpy array."""
    x = np.asarray(x.numpy() if torch.is_tensor(x) else x)
    return x.astype(np.complex128 if np.iscomplexobj(x) else np.float64)


def rel_err(a, b):
    scale = float(np.abs(b).max(initial=0.0))
    return float(np.abs(a - b).max(initial=0.0)) / scale if scale else float(np.abs(a).max())


@pytest.mark.parametrize("with_clouds", [False, True])
def test_socrates_gcm_matches_isca_tpu(with_clouds):
    cfg = dataclasses.replace(
        tmoist.socrates_aquaplanet_test_case_config(with_clouds, dtype=torch.float64, **CUT),
        initial_sphum=INITIAL_SPHUM)
    jcfg = jax_config(with_clouds)
    runs = {(pkg, f64): run(c, f64) for pkg, run, c in (("jax", jax_run, jcfg),
                                                        ("torch", port_run, cfg))
            for f64 in (True, False)}
    for part in (0, 1):                          # state leaves, diagnostics
        j64, j32 = runs["jax", True][part], runs["jax", False][part]
        t64, t32 = runs["torch", True][part], runs["torch", False][part]
        assert set(t64) == set(j64) == set(t32) == set(j32)
        for k in j64:
            if k == ".rad_cache.age":
                assert int(t64[k]) == int(j64[k]) == 1
                continue
            assert rel_err(t64[k], j64[k]) <= GCM_RTOL_F64, (k, rel_err(t64[k], j64[k]))
            gap = float(np.abs(j32[k] - j64[k]).max(initial=0.0))
            err = float(np.abs(t32[k] - j32[k]).max(initial=0.0))
            assert err <= GAP_FACTOR * gap, (k, err, gap)
    diag = runs["torch", False][1]
    if with_clouds:
        assert diag["cf"].max() == 1.0 and diag["tot_cld_amt"].mean() > 10.0
    else:
        assert "cf" not in diag
    olr, temp = diag["olr"], runs["torch", False][0][".dyn.tg.curr"]
    assert np.isfinite(olr).all() and 100.0 < olr.mean() < 400.0
    assert np.isfinite(temp).all() and 150.0 < temp.min() < temp.max() < 350.0
