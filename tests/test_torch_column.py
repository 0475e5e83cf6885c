"""The slice as a whole: isca_tpu_torch's ColumnModel (RRTM radiation,
RRTMG-SW + grey LW) against isca_tpu's from the same perturbed state.

Both packages start from one state carried by isca_tpu_torch.convert and run
4 steps at float64 on the CPU; the state after them agrees to rtol 1e-9 (the
same arithmetic; only reassociated sums, libm last bits and the float32 clock
differ, and 4 steps do not amplify them past ~1e-11).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isca_tpu.models import column as jcol
from isca_tpu.physics.moist_driver import MoistPhysicsConfig as JMoist
from isca_tpu.physics.rrtm_radiation import RRTMConfig as JRRTM
from isca_tpu_torch.convert import (STATE_KEYS, column_state_from_numpy,
                                    column_state_to_numpy)
from isca_tpu_torch.models import column as tcol
from isca_tpu_torch.physics.moist_driver import MoistPhysicsConfig as TMoist
from isca_tpu_torch.physics.rrtm_radiation import RRTMConfig as TRRTM

SHAPE = dict(nlat=2, nlon=4, num_levels=8, dt=600.0, lat_deg=30.0)
RTOL = 1e-9

def configs(**shape):
    shape = {**SHAPE, **shape}
    rrtm = dict(lw_scheme="grey", do_seasonal=True, o3_mmr=1e-6)
    j = jcol.ColumnConfig(dtype=jnp.float64, physics=JMoist(
        radiation_scheme="rrtm", rrtm=JRRTM(**rrtm)), **shape)
    t = tcol.ColumnConfig(dtype=torch.float64, physics=TMoist(
        radiation_scheme="rrtm", rrtm=TRRTM(**rrtm)), **shape)
    return j, t


def jax_state_dict(s):
    d = {f"{n}_{lvl}": getattr(getattr(s, n), lvl)
         for n in ("t", "q", "u", "v") for lvl in ("prev", "curr")}
    d.update(t_surf=s.t_surf, time_seconds=s.time_seconds)
    return {k: np.array(v) for k, v in d.items()}


def jax_state(d):
    two = lambda n: jcol.TwoLevel(jnp.asarray(d[f"{n}_prev"]), jnp.asarray(d[f"{n}_curr"]))
    return jcol.ColumnState(t=two("t"), q=two("q"), u=two("u"), v=two("v"),
                            t_surf=jnp.asarray(d["t_surf"]),
                            time_seconds=jnp.asarray(d["time_seconds"], jnp.float32))


def perturbed_state(jmodel, seed=1):
    """isca_tpu's initial_state() with a moist, conditionally unstable
    profile and per-column noise, at local noon: convection, condensation
    and the shortwave solve all have work in the first steps."""
    d = jax_state_dict(jmodel.initial_state())
    rng = np.random.default_rng(seed)
    pf = np.asarray(jmodel.p_full)
    t = np.maximum(300.0 * (pf / 1e5) ** 0.19, 200.0) + rng.uniform(-5, 5, pf.shape)
    es = 610.78 * np.exp(17.27 * (t - 273.15) / (t - 35.85))
    q = np.minimum(0.9 * 0.622 * es / pf, 0.02) * rng.uniform(0.5, 1.5, pf.shape)
    for lvl in ("prev", "curr"):
        d[f"t_{lvl}"], d[f"q_{lvl}"] = t.copy(), q.copy()
    d["u_prev"] = d["u_curr"] = rng.normal(0.0, 5.0, pf.shape)
    d["t_surf"] = d["t_surf"] + 15.0 + rng.uniform(-5, 5, d["t_surf"].shape)
    d["time_seconds"] = np.float32(43200.0)
    return d


def test_convert_round_trip():
    jcfg, tcfg = configs()
    d = perturbed_state(jcol.ColumnModel(jcfg))
    back = column_state_to_numpy(column_state_from_numpy(d, torch.float64, device="cpu"))
    assert set(back) == set(STATE_KEYS)
    for k in STATE_KEYS:
        np.testing.assert_array_equal(back[k], d[k], err_msg=k)
    assert back["time_seconds"].dtype == np.float32
    with pytest.raises(KeyError, match="t_surf"):
        column_state_from_numpy({k: d[k] for k in STATE_KEYS if k != "t_surf"},
                                device="cpu")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_model_setup_matches(dtype):
    jdt = jnp.float32 if dtype == torch.float32 else jnp.float64
    jcfg, tcfg = configs()
    jm = jcol.ColumnModel(dataclasses.replace(jcfg, dtype=jdt))
    tm = tcol.ColumnModel(dataclasses.replace(tcfg, dtype=dtype), device="cpu")
    # float32: the two packages' float32 log1p/exp differ in the last bits,
    # and the Simmons-Burridge alpha carries that into p_full (2e-6 relative)
    rtol = 2e-6 if dtype == torch.float32 else 1e-12
    for name in ("pk", "bk", "p_half", "p_full", "ln_p_half", "ln_p_full"):
        a = getattr(tm, name)
        assert a.dtype == dtype
        np.testing.assert_allclose(a.numpy(), np.asarray(getattr(jm, name)), rtol=rtol,
                                   err_msg=name)
    assert tm.top_is_zero == jm.top_is_zero
    js = jax_state_dict(jm.initial_state())
    ts = column_state_to_numpy(tm.initial_state())
    for k in STATE_KEYS:
        np.testing.assert_array_equal(ts[k], js[k], err_msg=k)
        assert ts[k].dtype == js[k].dtype, k
    diag = tm.diag_fields(tm.initial_state())
    assert diag["temp"].shape == (8, 2, 4)


def test_column_run_matches_isca_tpu():
    """4 steps of the whole slice at float64 from the same perturbed state."""
    jcfg, tcfg = configs()
    jm, tm = jcol.ColumnModel(jcfg), tcol.ColumnModel(tcfg, device="cpu")
    d = perturbed_state(jm)
    ref = jax_state_dict(jax.jit(lambda s: jm.run(s, 4, first=True))(jax_state(d)))
    out = column_state_to_numpy(tm.run(column_state_from_numpy(d, torch.float64, "cpu"), 4))
    for k in STATE_KEYS:
        assert out[k].dtype == ref[k].dtype, k
        np.testing.assert_allclose(out[k], ref[k], rtol=RTOL, atol=1e-12 * np.abs(ref[k]).max(),
                                   err_msg=k)
    # the run moved the state: physics, not a no-op, was compared
    assert np.abs(out["t_curr"] - d["t_curr"]).max() > 0.1
    assert np.abs(out["t_surf"] - d["t_surf"]).max() > 1e-3
    assert out["time_seconds"] == np.float32(43200.0 + 4 * 600.0)
