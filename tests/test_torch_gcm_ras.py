"""The GCM with RAS convection: isca_tpu_torch's GreyMoistModel against
isca_tpu's over 10 steps at float64, and the helpers the other
tests/test_torch_gcm_*.py files share.

* frierson_test_case_config() with convection_scheme="RAS", cut to T21L8,
  from isca_tpu_torch/models/cases.py's convective start (a 6.5 K/km lapse rate from
  300 K, 80% relative humidity below sigma 0.7; the isothermal dry cold
  start convects nowhere), which both packages load from one restart file:
  every leaf of the state and the last step's physics diagnostics (klcl
  and ras_precip_ev among them) at rtol 1e-9 of each field's largest
  entry. RAS rains in most columns; the cut to 8 levels leaves 5 cloud
  types, and klcl stays in [L//2-1, L-1] (comp_lcl's floor is where a
  parcel without an LCL in the column goes; tests/test_torch_ras.py holds
  such a column).
* The driver's RAS branch in one call on tests/test_ras.py's soundings
  against isca_tpu's, rtol 1e-10.

Helpers: `to_jax` turns a port configuration into isca_tpu's (same class
names at the same module paths), `jax_series` builds isca_tpu's series from
the same numpy fields as isca_tpu_torch/models/cases.py, `JaxRunner`
compiles isca_tpu's two step functions once, and `compare_runs` holds a
port run to an isca_tpu run leaf by leaf.
"""

import dataclasses
import importlib
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
from isca_tpu.utils import time_interp as jti
from isca_tpu_torch.io import restart as trestart
from isca_tpu_torch.models import cases
from isca_tpu_torch.models import moist as tmoist
from isca_tpu_torch.physics import moist_driver as tmd
from isca_tpu_torch.utils.tree import flatten_with_paths

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
from tests.test_ras import make_sounding  # noqa: E402

GCM_RTOL = 1e-9
STEPS = 10
# the Frierson sigma ladder cut to 8 layers (every third half level)
FRIERSON_BK_L8 = tuple(tmoist.FRIERSON_BK[i] for i in (0, 3, 6, 9, 12, 15, 18, 21, 25))
T21L8 = dict(resolution="T21", num_levels=8,
             vert_coord_kwargs=(("bk", FRIERSON_BK_L8), ("pk", (0.0,) * 9)))


def to_jax(obj):
    """isca_tpu's counterpart of a port configuration: each dataclass becomes
    the class of the same name in the same module of isca_tpu, field by
    field; torch dtypes become jax.numpy's."""
    if isinstance(obj, torch.dtype):
        return {torch.float64: jnp.float64, torch.float32: jnp.float32}[obj]
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        mod = importlib.import_module(type(obj).__module__.replace("isca_tpu_torch", "isca_tpu"))
        jcls = getattr(mod, type(obj).__name__)
        return jcls(**{f.name: to_jax(getattr(obj, f.name)) for f in dataclasses.fields(obj)})
    return obj


def jax_series(fields, dtype=jnp.float64):
    return jti.monthly_climatology(fields, cases.YEAR_SECONDS, dtype)


class JaxRunner:
    """An isca_tpu model with its step functions compiled once."""

    def __init__(self, model):
        self.model = model
        self.first = jax.jit(lambda s: model.step(s, first=True))
        self.rest = jax.jit(model.step_with_diagnostics)

    def run(self, state, steps):
        """The state after `steps` steps and the last step's diagnostics."""
        s, diag = self.first(state), None
        for _ in range(steps - 1):
            s, diag = self.rest(s)
        return s, diag


def port_run(model, state, steps):
    s = model.run(state, steps - 1)
    return model.step_with_diagnostics(s, first=False)


def as_np(fields):
    return {k: (v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v))
            for k, v in fields.items()}


def jax_leaves(state):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(state)[0]}


def close_dicts(got, ref, rtol, what):
    assert set(got) == set(ref), (what, set(got) ^ set(ref))
    wide = lambda x: x if np.iscomplexobj(x) else x.astype(np.float64)   # ints and bools
    for k, b in ref.items():
        a = got[k]
        assert a.shape == b.shape, (what, k, a.shape, b.shape)
        scale = float(np.abs(b).max(initial=0.0))
        np.testing.assert_allclose(wide(a), wide(b), rtol=rtol, atol=rtol * scale,
                                   err_msg=f"{what} {k}")


def compare_runs(tm, ts, jr, js, steps=STEPS, rtol=GCM_RTOL):
    """Run both models `steps` steps from their given states and hold the
    port's state leaves and last-step diagnostics to isca_tpu's. Returns
    the port's final state and diagnostics."""
    js, jdiag = jr.run(js, steps)
    ts, tdiag = port_run(tm, ts, steps)
    close_dicts({k: v.numpy() for k, v in flatten_with_paths(ts)}, jax_leaves(js), rtol,
                "state")
    close_dicts(as_np(tdiag), as_np(jdiag), rtol, "step diagnostics")
    return ts, tdiag


def shared_start(tm, jm, state, tmp_path):
    """The port's `state` as both packages' initial state: written by the
    port's restart writer and read back by each package."""
    path = str(tmp_path / "start.npz")
    trestart.save_restart(path, state)
    return trestart.load_restart(path, tm.initial_state()), jrestart.load_restart(
        path, jm.initial_state())


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small ops: one intra-op thread, the cores left to the other
    test workers (as tests/test_torch_moist.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------

def test_ras_gcm_matches_isca_tpu(tmp_path):
    tcfg = cases.ras_bl_config(torch.float64, "RAS", **T21L8)
    tm = tmoist.GreyMoistModel(tcfg, device="cpu")
    jm = jmoist.GreyMoistModel(to_jax(tcfg))
    ts, js = shared_start(tm, jm, cases.convective_start(tm), tmp_path)
    ts, tdiag = compare_runs(tm, ts, JaxRunner(jm), js)
    rain = tdiag["convection_rain"].numpy()
    assert (rain > 0.0).mean() > 0.5
    klcl = tdiag["klcl"].numpy()
    assert klcl.min() >= 8 // 2 - 1 and klcl.max() <= 7
    assert "ras_precip_ev" in tdiag


def test_ras_driver_branch_matches_isca_tpu():
    t, q, u, v, pf, ph, zh, _ = make_sounding(L=12, ncol=4)
    rng = np.random.default_rng(2)
    u = np.asarray(u) + rng.normal(0.0, 3.0, u.shape)
    ncol, L = t.shape
    lats = np.deg2rad(np.array([-10.0, 25.0]))
    lons = np.deg2rad(np.array([0.0, 180.0]))
    shape = (2, 2)
    col = lambda a: np.asarray(a).reshape(shape + np.asarray(a).shape[1:])
    zf = 0.5 * (np.asarray(zh)[:, 1:] + np.asarray(zh)[:, :-1])
    args = [col(a) for a in (u, 0.5 * np.asarray(u), t, q, pf, ph, pf, ph, zf, zh)]
    t_surf = col(np.asarray(t)[:, -1] + 1.0)
    kw = dict(convection_scheme="RAS", bl_scheme="my25")
    jp = jmd.MoistPhysics(jmd.MoistPhysicsConfig(**kw), jnp.asarray(lats), jnp.asarray(lons))
    tp = tmd.MoistPhysics(tmd.MoistPhysicsConfig(**kw), torch.as_tensor(lats),
                          torch.as_tensor(lons))
    tke = np.abs(rng.normal(0.0, 0.2, shape + (L + 1,)))
    ref = jp(1440.0, 720.0, *map(jnp.asarray, args), jnp.asarray(t_surf),
             time_seconds=3600.0, tke=jnp.asarray(tke))
    got = tp(1440.0, 720.0, *(torch.tensor(a) for a in args), torch.tensor(t_surf),
             time_seconds=3600.0, tke=torch.tensor(tke))
    assert float(np.asarray(ref.diagnostics["convection_rain"]).max()) > 0.0
    for name in ("dt_u", "dt_v", "dt_t", "dt_q", "t_surf"):
        close_dicts({name: getattr(got, name).numpy()}, {name: np.asarray(getattr(ref, name))},
                    1e-10, "tendencies")
    close_dicts(as_np(got.diagnostics), as_np(ref.diagnostics), 1e-10, "diagnostics")
