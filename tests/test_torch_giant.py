"""The giant planet in isca_tpu_torch against isca_tpu: dry convective
adjustment, the giant-planet lower boundary, and the model.

* dry_convection, gp_surface_flux and rayleigh_bottom_drag per function on
  seeded random columns at float64, rtol 1e-12 of each field's largest
  entry (lzb and lcl exactly);
* giant_planet_model at T21L8 float64 (dt = 900 s): 10 steps from cold start
  against isca_tpu at rtol 1e-9 (every leaf, diagnostic fields, the last
  step's physics diagnostics), and the giant_planet trip golden (192 steps,
  2 model days, tools/trip_test.py's compare at RTOL 1e-7);
* restarts interchange both ways; the CLI's giant model; JUPITER.
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

from isca_tpu.io import restart as jrestart
from isca_tpu.models import giant as jgiant
from isca_tpu.physics import dry_convection as jdc
from isca_tpu.physics import giant_planet as jgp
from isca_tpu_torch import __main__ as tmain
from isca_tpu_torch.io import restart as trestart
from isca_tpu_torch.models import giant as tgiant
from isca_tpu_torch.models import moist as tmoist
from isca_tpu_torch.physics import dry_convection as tdc
from isca_tpu_torch.physics import giant_planet as tgp
from isca_tpu_torch.utils.tree import flatten_with_paths

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
from tools import trip_test  # noqa: E402

TRIP = dict(resolution="T21", num_levels=8, dt=900.0)   # trip_test.build_giant_planet


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Eager T21 steps are many small ops: one intra-op thread runs them
    faster and leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def columns(seed=0, shape=(6, 9), L=20):
    """Random giant-planet columns: even sigma at ps ~ 3 bar, a dry adiabat
    with noise, so some columns are unstable near the surface."""
    rng = np.random.default_rng(seed)
    ps = 3.0e5 * (1.0 + 0.02 * rng.standard_normal(shape))
    sig = np.linspace(0.0, 1.0, L + 1)
    p_half = sig * ps[..., None]
    p_half[..., 0] = 0.5 * p_half[..., 1] * 0.1
    p_full = 0.5 * (p_half[..., 1:] + p_half[..., :-1])
    kappa = 2.0 / 7.0
    t = 200.0 * (p_full / 3.0e5) ** kappa + rng.normal(0.0, 3.0, shape + (L,))
    t[..., -3:] += rng.uniform(0.0, 6.0, shape + (3,))
    u = rng.normal(0.0, 20.0, shape + (L,))
    v = rng.normal(0.0, 20.0, shape + (L,))
    return dict(t=t, p_full=p_full, p_half=p_half, u=u, v=v,
                lat=rng.uniform(-1.5, 1.5, shape),
                dt_u=rng.normal(0, 1e-5, shape + (L,)), dt_v=rng.normal(0, 1e-5, shape + (L,)),
                dt_t=rng.normal(0, 1e-5, shape + (L,)))


def close(got, want, rtol=1e-12, what=""):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max(initial=0.0),
                               err_msg=what)


@pytest.mark.parametrize("tau,gamma", [(21600.0, 1.0), (14400.0, 0.7)])
def test_dry_convection_matches_isca_tpu(tau, gamma):
    c = columns()
    jcfg = jdc.DryConvectionConfig(tau=tau, gamma=gamma, constants=jgiant.JUPITER)
    tcfg = tdc.DryConvectionConfig(tau=tau, gamma=gamma, constants=tgiant.JUPITER)
    want = jdc.dry_convection(jcfg, *(jnp.asarray(c[k]) for k in ("t", "p_full", "p_half")))
    got = tdc.dry_convection(tcfg, *(torch.as_tensor(c[k]) for k in ("t", "p_full", "p_half")))
    for f in want._fields:
        close(getattr(got, f), getattr(want, f), what=f)
    assert got.lzb.dtype == torch.int32 and got.lcl.dtype == torch.int32
    convecting = (np.asarray(want.cape) > np.asarray(want.cin)) & (np.asarray(want.lzb) < 19)
    assert 0 < convecting.sum() < convecting.size      # both kinds of column


def test_gp_surface_flux_matches_isca_tpu():
    c = columns(1)
    want = jgp.gp_surface_flux(jgp.GiantPlanetConfig(constants=jgiant.JUPITER),
                               jnp.asarray(c["dt_t"]), jnp.asarray(c["p_half"]))
    got = tgp.gp_surface_flux(tgp.GiantPlanetConfig(constants=tgiant.JUPITER),
                              torch.as_tensor(c["dt_t"]), torch.as_tensor(c["p_half"]))
    close(got, want)


@pytest.mark.parametrize("variable_drag,conserve", [(False, True), (True, True), (True, False)])
def test_rayleigh_bottom_drag_matches_isca_tpu(variable_drag, conserve):
    c = columns(2)
    kw = dict(variable_drag=variable_drag, do_energy_conserv_ray=conserve, sigma_b=0.7)
    names = ("lat", "u", "v", "p_half", "p_full", "dt_u", "dt_v", "dt_t")
    want = jgp.rayleigh_bottom_drag(jgp.GiantPlanetConfig(constants=jgiant.JUPITER, **kw),
                                    1800.0, *(jnp.asarray(c[k]) for k in names))
    got = tgp.rayleigh_bottom_drag(tgp.GiantPlanetConfig(constants=tgiant.JUPITER, **kw),
                                   1800.0, *(torch.as_tensor(c[k]) for k in names))
    for f in want._fields:
        close(getattr(got, f), getattr(want, f), what=f)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_giant():
    """isca_tpu's giant model at the trip size with compiled steps."""
    model = jgiant.giant_planet_model(dtype=jnp.float64, **TRIP)
    first = jax.jit(lambda s: model.step(s, first=True))
    rest = jax.jit(model.step_with_diagnostics)
    return model, first, rest


def port_giant():
    return tgiant.giant_planet_model(dtype=torch.float64, device="cpu", **TRIP)


def jax_leaves(state):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(state)[0]}


def port_leaves(state):
    return {k: v.numpy() for k, v in flatten_with_paths(state)}


def close_dicts(got, ref, rtol, what):
    assert set(got) == set(ref), (what, set(got) ^ set(ref))
    for k, b in ref.items():
        close(got[k], b, rtol, f"{what} {k}")


def test_ten_steps_match_isca_tpu(jax_giant):
    jm, first, rest = jax_giant
    js = first(jm.initial_state())
    for _ in range(9):
        js, jdiag = rest(js)
    tm = port_giant()
    ts, tdiag = tm.step_with_diagnostics(tm.run(tm.initial_state(), 9))
    close_dicts(port_leaves(ts), jax_leaves(js), 1e-9, "state")
    close_dicts({k: v.numpy() for k, v in tdiag.items()},
                {k: np.asarray(v) for k, v in jdiag.items()}, 1e-9, "diagnostics")
    # no surface fluxes; dry convection and the damping driver ran (its
    # 50 Pa sponge lies above the top level at L8, so it is zero here)
    assert "flux_t" not in tdiag and {"cape", "udt_rdamp"} <= set(tdiag)


def test_two_days_match_trip_golden():
    with open(REPO / "tests" / "goldens" / "trip_goldens.json") as f:
        golden = json.load(f)["giant_planet"]
    model = port_giant()
    steps = int(round(trip_test.DAYS * 86400.0 / model.config.core.dt))
    assert steps == 192
    state = model.run(model.initial_state(), steps, first=True)
    got = {k: trip_test.field_stats(v.numpy()) for k, v in sorted(model.diag_fields(state).items())}
    errors = trip_test.compare("giant_planet", got, golden)
    assert not errors, "\n".join(errors)


@pytest.mark.parametrize("writer", ["isca_tpu", "isca_tpu_torch"])
def test_restart_interchange(jax_giant, tmp_path, writer):
    jm, first, rest = jax_giant
    tm = port_giant()
    path = str(tmp_path / "res.npz")
    if writer == "isca_tpu":
        js = rest(first(jm.initial_state()))[0]
        jrestart.save_restart(path, js)
        loaded = trestart.load_restart(path, tm.initial_state())
        close_dicts(port_leaves(loaded), jax_leaves(js), 0.0, "restart")
        close_dicts(port_leaves(tm.step(loaded)), jax_leaves(rest(js)[0]), 1e-9, "continued")
    else:
        ts = tm.run(tm.initial_state(), 2)
        trestart.save_restart(path, ts)
        loaded = jrestart.load_restart(path, jm.initial_state())
        close_dicts(jax_leaves(loaded), port_leaves(ts), 0.0, "restart")
        close_dicts(port_leaves(tm.step(ts)), jax_leaves(rest(loaded)[0]), 1e-9, "continued")


def test_cli_giant(tmp_path):
    from scipy.io import netcdf_file

    argv = ["jup", "--model", "giant", "--resolution", "T21", "--levels", "8",
            "--dt", "1800", "--days", "1", "--daily", "--device", "cpu",
            "--datadir", str(tmp_path)]
    assert tmain.main(argv) == 0
    model = tmain.build_model(tmain.argparse.Namespace(
        model="giant", resolution="T21", levels=8, dt=1800.0, device="cpu"))
    assert isinstance(model, tmoist.GreyMoistModel)
    assert model.config.core.constants == tgiant.JUPITER
    with netcdf_file(str(tmp_path / "jup" / "run0001" / "atmos_daily.nc"), mmap=False) as nc:
        temp = np.array(nc.variables["temp"][:])
    assert temp.shape == (1, 8, 32, 64) and np.isfinite(temp).all()


def test_config_mirrors_isca_tpu():
    assert dataclasses.asdict(tgiant.JUPITER) == dataclasses.asdict(jgiant.JUPITER)
    tm = tgiant.giant_planet_model(device="cpu", resolution="T21", num_levels=4)
    jm = jgiant.giant_planet_model(resolution="T21", num_levels=4)
    for part in ("core", "physics"):
        tc, jc = getattr(tm.config, part), getattr(jm.config, part)
        for f in dataclasses.fields(tc):
            tv, jv = getattr(tc, f.name), getattr(jc, f.name)
            if f.name in ("dtype", "rrtm") or dataclasses.is_dataclass(tv):
                continue
            assert tv == jv, (part, f.name)
    plain = lambda x: dataclasses.asdict(x) if dataclasses.is_dataclass(x) else x
    for name in ("dry_convection", "giant", "radiation", "damping"):
        tv, jv = getattr(tm.config.physics, name), getattr(jm.config.physics, name)
        for f in dataclasses.fields(tv):
            if f.name in ("mg", "cg", "orbit"):
                continue
            assert plain(getattr(tv, f.name)) == plain(getattr(jv, f.name)), (name, f.name)
    assert tm.config.t_surf_init == jm.config.t_surf_init == 200.0
