"""Radiation substepping (`dt_rad > dt`) in isca_tpu_torch against isca_tpu.

isca_tpu recomputes radiation when `rad_cache.age % n_rad == 0` (a
`lax.cond`); a computed step stores age 1, a reused step the cache with
age + 1. The port makes the same decision on the host from a host-side age
(`moist_driver.rad_due`), so a step reads nothing from the device.

* The moist driver (FULL_BETTS_MILLER, RRTMG-SW + RRTMG-LW) over 25 calls at
  n_rad = 4 from a zero cache, the sun moving between calls: the ages, the
  calls that recompute radiation (counted on the port's RRTM adapter) and
  every field of the cache after each call equal isca_tpu's (rtol 1e-10).
* The MiMA test case (exp/test_cases/mima_test_case.py: GreyMoistConfig()
  with RRTM radiation, seasonal sun, o3_mmr 1e-6, FULL_BETTS_MILLER) cut to
  T21L8, float64, with dt_rad = 4 dt: 7 steps in each package recompute at
  steps 1 and 5 and agree at rtol 1e-6 (the RRTM GCM's bound, ROADMAP C.5);
  a restart written at step 2 (age 2 of 4) by either package continues in
  the other, recomputing at the same steps as the writer's uninterrupted
  run and agreeing with it at rtol 1e-6; the port's run chained through its
  restart equals its direct run bit for bit.
"""

import dataclasses
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isca_tpu.io import restart as jrestart
from isca_tpu.models import moist as jmoist
from isca_tpu.physics import moist_driver as jmd
from isca_tpu.physics import rrtm_radiation as jrr
from isca_tpu_torch.io import restart as trestart
from isca_tpu_torch.models import moist as tmoist
from isca_tpu_torch.physics import moist_driver as tmd
from isca_tpu_torch.physics import rrtm_radiation as trr
from isca_tpu_torch.utils.tree import flatten_with_paths

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
from tests.test_torch_physics import columns  # noqa: E402

# the committed LW k-tables are synthetic, and say so at every construction
pytestmark = pytest.mark.filterwarnings("ignore:RRTMG-LW is running on SYNTHETIC")

N_RAD = 4
DRIVER_CALLS = 25
GCM_STEPS, RESTART_AT = 7, 2
GCM_RTOL = 1e-6

JAX = dict(model=jmoist, rrtm=jrr.RRTMConfig)
TORCH = dict(model=tmoist, rrtm=trr.RRTMConfig)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small ops: one intra-op thread, the cores left to the other
    test workers (as tests/test_torch_moist.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def T(a):
    return torch.as_tensor(np.array(a))


def close(port, ref, rtol, msg=""):
    port = port.detach().cpu().numpy() if torch.is_tensor(port) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape and port.dtype == ref.dtype, msg
    np.testing.assert_allclose(port, ref, rtol=rtol,
                               atol=rtol * float(np.abs(ref).max(initial=0.0)), err_msg=msg)


def count_radiation(physics):
    """Wrap the port's RRTM adapter so each radiation computation is logged
    (what the card counts as sw_flux launches)."""
    calls = []
    down = physics.radiation.down

    def counted(*a, **kw):
        calls.append(1)
        return down(*a, **kw)

    physics.radiation.down = counted
    return calls


def test_rad_due_rule():
    cfg = tmd.MoistPhysicsConfig(dt_rad=7200.0)
    cache = tmd.zero_rad_cache((2, 3), 4, torch.float64)
    assert cache.age.device.type == "cpu" and cache.age.dtype == torch.int32
    # MiMA's dt_rad = 7200 s at dt = 720 s: n_rad = 10
    due = []
    for _ in range(21):
        due.append(tmd.rad_due(cfg, 720.0, cache))
        cache = cache._replace(age=tmd.rad_age(1) if due[-1] else cache.age + 1)
    assert [i for i, d in enumerate(due) if d] == [0, 10, 20]
    assert tmd.rad_due(tmd.MoistPhysicsConfig(), 720.0, cache)        # dt_rad <= dt
    assert tmd.rad_due(cfg, 720.0, None)                              # no cache
    on_device = cache._replace(age=torch.zeros((), dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="host"):
        tmd.rad_due(cfg, 720.0, on_device)


def test_driver_decision_sequence_matches_isca_tpu():
    c = columns(9)
    kw = dict(radiation_scheme="rrtm", convection_scheme="FULL_BETTS_MILLER",
              dt_rad=N_RAD * 600.0)
    lats = np.deg2rad(np.array([-20.0, 45.0]))
    lons = np.deg2rad(np.array([0.0, 90.0, 180.0, 270.0]))
    j = jmd.MoistPhysics(jmd.MoistPhysicsConfig(rrtm=jrr.RRTMConfig(o3_mmr=1e-6), **kw),
                         jnp.asarray(lats), jnp.asarray(lons))
    t = tmd.MoistPhysics(tmd.MoistPhysicsConfig(rrtm=trr.RRTMConfig(o3_mmr=1e-6), **kw),
                         T(lats), T(lons))
    calls = count_radiation(t)
    names = ("u", "v", "t", "q", "p_full", "p_half", "p_full", "p_half", "z_full",
             "z_half", "t_surf")
    tsae = np.float32(4.2)
    jstep = jax.jit(lambda cache, gmt, *a: j(1200.0, 600.0, *a, gmt=gmt,
                                             time_since_ae=jnp.asarray(tsae), rad_cache=cache))
    jargs = [jnp.asarray(c[k]) for k in names]
    targs = [T(c[k]) for k in names]
    jcache = jmd.zero_rad_cache((2, 4), 8, jnp.float64)
    tcache = tmd.zero_rad_cache((2, 4), 8, torch.float64)
    jages, tages, recomputed = [], [], []
    for i in range(DRIVER_CALLS):
        gmt = np.float32(0.4 * i)            # the sun moves: a recompute shows
        jcache = jstep(jcache, jnp.asarray(gmt), *jargs).rad_cache
        before = len(calls)
        tcache = t(1200.0, 600.0, *targs, gmt=T(gmt), time_since_ae=T(tsae),
                   rad_cache=tcache).rad_cache
        recomputed.append(len(calls) > before)
        jages.append(int(jcache.age))
        tages.append(int(tcache.age))
        assert tcache.age.device.type == "cpu" and tcache.age.dtype == torch.int32
        for name in tmd.RadCache._fields:
            close(getattr(tcache, name), getattr(jcache, name), 1e-10, f"call {i} {name}")
    assert tages == jages == [i % N_RAD + 1 for i in range(DRIVER_CALLS)]
    assert recomputed == [a == 1 for a in jages]
    assert sum(recomputed) == 7


# ---------------------------------------------------------------------------
# the MiMA test case with dt_rad: runs and restarts in both directions
# ---------------------------------------------------------------------------

def mima_case_config(pkg, dtype):
    """exp/test_cases/mima_test_case.py cut to T21L8, with dt_rad = N_RAD dt."""
    cfg = pkg["model"].GreyMoistConfig()
    core = dataclasses.replace(cfg.core, resolution="T21", num_levels=8, dtype=dtype)
    return dataclasses.replace(cfg, core=core, physics=dataclasses.replace(
        cfg.physics, radiation_scheme="rrtm",
        rrtm=pkg["rrtm"](do_seasonal=True, o3_mmr=1.0e-6),
        convection_scheme="FULL_BETTS_MILLER", dt_rad=N_RAD * core.dt))


def jax_leaves(state):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(state)[0]}


def port_leaves(state):
    return {k: v.numpy() for k, v in flatten_with_paths(state)}


def close_states(got, ref, rtol, what):
    assert set(got) == set(ref), what
    for k, b in ref.items():
        close(got[k], b, rtol, f"{what} {k}")


@pytest.fixture(scope="module")
def jax_run():
    """isca_tpu's GCM_STEPS steps: (model, its leapfrog step, the states)."""
    model = jmoist.GreyMoistModel(mima_case_config(JAX, jnp.float64))
    rest = jax.jit(model.step)
    states = [jax.jit(lambda s: model.step(s, first=True))(model.initial_state())]
    for _ in range(GCM_STEPS - 1):
        states.append(rest(states[-1]))
    return model, rest, states


@pytest.fixture(scope="module")
def port_run():
    """The port's GCM_STEPS steps: (model, the states, the 1-based steps
    that computed radiation, the model's radiation-call log)."""
    model = tmoist.GreyMoistModel(mima_case_config(TORCH, torch.float64), device="cpu")
    calls = count_radiation(model.physics)
    states, computed = [], []
    state = model.initial_state()
    for i in range(GCM_STEPS):
        before = len(calls)
        state = model.step(state, first=i == 0)
        states.append(state)
        if len(calls) > before:
            computed.append(i + 1)
    return model, states, computed, calls


def ages(states):
    return [int(s.rad_cache.age) for s in states]


def test_gcm_runs_agree(jax_run, port_run):
    _, _, jstates = jax_run
    _, tstates, computed, _ = port_run
    assert ages(tstates) == ages(jstates) == [1, 2, 3, 4, 1, 2, 3]
    assert computed == [1, 5]
    close_states(port_leaves(tstates[-1]), jax_leaves(jstates[-1]), GCM_RTOL, "direct")
    # the reused steps carry the stored radiation unchanged
    assert torch.equal(tstates[3].rad_cache.tdt_rad, tstates[0].rad_cache.tdt_rad)
    assert not torch.equal(tstates[4].rad_cache.tdt_rad, tstates[0].rad_cache.tdt_rad)


@pytest.mark.parametrize("writer", ["isca_tpu", "isca_tpu_torch"])
def test_restart_mid_interval_continues_in_the_other(jax_run, port_run, tmp_path, writer):
    jm, jrest, jstates = jax_run
    tm, tstates, _, calls = port_run
    path = str(tmp_path / "res.npz")
    if writer == "isca_tpu":
        assert int(jstates[RESTART_AT - 1].rad_cache.age) == 2
        jrestart.save_restart(path, jstates[RESTART_AT - 1])
        state = trestart.load_restart(path, tm.initial_state())
        assert state.rad_cache.age.device.type == "cpu" and int(state.rad_cache.age) == 2
        cont, computed = [], []
        for i in range(GCM_STEPS - RESTART_AT):
            before = len(calls)
            state = tm.step(state)
            cont.append(state)
            if len(calls) > before:
                computed.append(RESTART_AT + i + 1)
        assert computed == [5]
        assert ages(cont) == ages(jstates[RESTART_AT:])
        close_states(port_leaves(state), jax_leaves(jstates[-1]), GCM_RTOL, "continued")
    else:
        trestart.save_restart(path, tstates[RESTART_AT - 1])
        state = jrestart.load_restart(path, jm.initial_state())
        assert int(state.rad_cache.age) == 2
        cont = []
        for _ in range(GCM_STEPS - RESTART_AT):
            state = jrest(state)
            cont.append(state)
        assert ages(cont) == ages(tstates[RESTART_AT:])
        close_states(jax_leaves(state), port_leaves(tstates[-1]), GCM_RTOL, "continued")


def test_chained_run_equals_direct_bit_for_bit(port_run, tmp_path):
    tm, tstates, _, _ = port_run
    path = str(tmp_path / "res.npz")
    trestart.save_restart(path, tstates[RESTART_AT - 1])
    state = trestart.load_restart(path, tm.initial_state())
    state = tm.run(state, GCM_STEPS - RESTART_AT, first=False)
    direct = flatten_with_paths(tstates[-1])
    chained = flatten_with_paths(state)
    assert [p for p, _ in chained] == [p for p, _ in direct]
    for (p, a), (_, b) in zip(chained, direct):
        assert a.device == b.device and a.dtype == b.dtype and torch.equal(a, b), p
