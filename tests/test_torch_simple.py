"""The simple models of isca_tpu_torch against isca_tpu's: stirring, the
barotropic vorticity model and the shallow-water model.

* make_stirring's tables and one stir update at float64 (rtol 1e-12; the
  key bit for bit), and the tables at float32 exactly;
* 10 steps from cold start at T21 float64, every leaf of the state (the
  stirring key bit for bit), the diagnostic fields and the global
  diagnostics at rtol 1e-9 of each field's largest entry, in four
  configurations (stirred and default barotropic, stirred and forced
  shallow water with a vortex pair);
* the barotropic_vort_eq_stirring and shallow_water_stirring trip goldens:
  2 model days at T21 float64 through tools/trip_test.py's field_stats and
  compare (RTOL 1e-7);
* restarts written by either package load in the other and continue alike,
  the key included; the numpy state round trip; the CLI's barotropic and
  shallow models; configs mirror isca_tpu's; the wind guard.
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
from isca_tpu.models import barotropic as jbaro
from isca_tpu.models import shallow as jshallow
from isca_tpu.physics import stirring as jstir
from isca_tpu.spectral import transforms as jtr
from isca_tpu_torch import __main__ as tmain
from isca_tpu_torch import convert
from isca_tpu_torch.io import restart as trestart
from isca_tpu_torch.models import barotropic as tbaro
from isca_tpu_torch.models import shallow as tshallow
from isca_tpu_torch.physics import stirring as tstir
from isca_tpu_torch.spectral import transforms as ttr
from isca_tpu_torch.utils import threefry
from isca_tpu_torch.utils.tree import flatten_with_paths

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
from tools import trip_test  # noqa: E402

# tools/trip_test.py build_barotropic_vort_eq_stirring / build_shallow_water_stirring
CASES = {
    "barotropic_vort_eq_stirring": ("barotropic", dict(
        resolution="T21", dt=1200.0, initial_zonal_wind="zero", stirring_amplitude=3.0e-11,
        damping_order=2, damping_coeff_r=1.929e-6)),
    "barotropic_two_jets": ("barotropic", dict(resolution="T21", dt=1800.0)),
    "shallow_water_stirring": ("shallow", dict(
        resolution="T21", dt=1200.0, stirring_amplitude=1.0e-11)),
    "shallow_forced_vortices": ("shallow", dict(
        resolution="T21", dt=600.0, physics_on=True, add_initial_vortex_pair=True,
        u_deep_mag=5.0, u_upper_mag_init=10.0, stirring_amplitude=2.0e-11,
        stirring_B=1.0, seed=None)),
}
PKGS = {"jax": {"barotropic": (jbaro.BarotropicConfig, jbaro.BarotropicModel),
                "shallow": (jshallow.ShallowConfig, jshallow.ShallowModel)},
        "torch": {"barotropic": (tbaro.BarotropicConfig, tbaro.BarotropicModel),
                  "shallow": (tshallow.ShallowConfig, tshallow.ShallowModel)}}
TO_NUMPY = {"barotropic": (convert.barotropic_state_to_numpy,
                           convert.barotropic_state_from_numpy,
                           convert.BAROTROPIC_STATE_KEYS),
            "shallow": (convert.shallow_state_to_numpy, convert.shallow_state_from_numpy,
                        convert.SHALLOW_STATE_KEYS)}
SEED = 2**31 + 11      # initial_state seed of the last case (a key word >= 2^31)


def case_kw(case):
    kind, kw = CASES[case]
    kw = dict(kw)
    seed = kw.pop("seed", 0)
    return kind, kw, SEED if seed is None else seed


def port_model(case, dtype=torch.float64):
    kind, kw, _ = case_kw(case)
    cfg_cls, model_cls = PKGS["torch"][kind]
    return model_cls(cfg_cls(dtype=dtype, **kw), device="cpu")


class JaxRunner:
    """An isca_tpu model with its first and later steps compiled once."""

    def __init__(self, case):
        kind, kw, self.seed = case_kw(case)
        cfg_cls, model_cls = PKGS["jax"][kind]
        self.model = model_cls(cfg_cls(dtype=jnp.float64, **kw))
        self.first = jax.jit(lambda s: self.model.step(s, first=True))
        self.rest = jax.jit(self.model.step)

    def run(self, steps):
        s = self.first(self.model.initial_state(self.seed))
        for _ in range(steps - 1):
            s = self.rest(s)
        return s


@pytest.fixture(scope="module")
def jax_runners():
    return {}


def jax_runner(jax_runners, case):
    if case not in jax_runners:
        jax_runners[case] = JaxRunner(case)
    return jax_runners[case]


def jax_leaves(state):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(state)[0]}


def port_leaves(state):
    return {k: v.numpy() for k, v in flatten_with_paths(state)}


def as_np(fields):
    return {k: (v.numpy() if torch.is_tensor(v) else np.asarray(v)) for k, v in fields.items()}


def close_dicts(got, ref, rtol, what):
    assert set(got) == set(ref), (what, set(got) ^ set(ref))
    for k, b in ref.items():
        a = got[k]
        assert a.shape == b.shape and a.dtype == b.dtype, (what, k, a.shape, b.shape, a.dtype)
        if k == ".rng":
            np.testing.assert_array_equal(a, b, err_msg=f"{what} {k}")
            continue
        scale = float(np.abs(b).max(initial=0.0))
        np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * scale, err_msg=f"{what} {k}")


# ---------------------------------------------------------------------------
# stirring
# ---------------------------------------------------------------------------

STIR_KW = dict(amplitude=3.0e-11, B=0.5, lon0=170.0, n_total_forcing_max=14)


@pytest.mark.parametrize("jdtype,tdtype", [(jnp.float64, torch.float64),
                                           (jnp.float32, torch.float32)])
def test_make_stirring_matches_isca_tpu(jdtype, tdtype):
    JT = jtr.make_transforms("T21", dtype=jdtype)
    TT = ttr.make_transforms("T21", dtype=tdtype, device="cpu")
    js, ts = jstir.make_stirring(JT, 1200.0, **STIR_KW), tstir.make_stirring(TT, 1200.0, **STIR_KW)
    for f in ("amplitude", "a", "b", "do_localize"):
        assert getattr(ts, f) == getattr(js, f), f
    for f in ("mask", "localize"):
        got, want = getattr(ts, f).numpy(), np.asarray(getattr(js, f))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want, err_msg=f)
    assert ts.mask.sum() > 0


@pytest.mark.parametrize("do_localize", [True, False])
def test_stir_matches_isca_tpu(do_localize):
    JT = jtr.make_transforms("T21", dtype=jnp.float64)
    TT = ttr.make_transforms("T21", dtype=torch.float64, device="cpu")
    kw = dict(STIR_KW, do_localize=do_localize)
    js, ts = jstir.make_stirring(JT, 1200.0, **kw), tstir.make_stirring(TT, 1200.0, **kw)
    rng = np.random.default_rng(3)
    s0 = (rng.normal(size=TT.spec_shape) + 1j * rng.normal(size=TT.spec_shape)) * 1e-11
    jsn, jkey = jax.jit(lambda s, k: jstir.stir(js, JT, s, k))(
        jnp.asarray(s0), jax.random.PRNGKey(5))
    tsn, tkey = tstir.stir(ts, TT, torch.as_tensor(s0), threefry.prng_key(5, "cpu"))
    np.testing.assert_array_equal(tkey.numpy(), np.asarray(jkey))
    want = np.asarray(jsn)
    np.testing.assert_allclose(tsn.numpy(), want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())


def test_stir_without_amplitude_is_identity():
    TT = ttr.make_transforms("T21", dtype=torch.float64, device="cpu")
    s, key = torch.zeros(TT.spec_shape, dtype=torch.complex128), threefry.prng_key(1, "cpu")
    out, key2 = tstir.stir(tstir.make_stirring(TT, 1200.0), TT, s, key)
    assert out is s and key2 is key


# ---------------------------------------------------------------------------
# models against isca_tpu, and the goldens
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", list(CASES))
def test_ten_steps_match_isca_tpu(jax_runners, case):
    jr = jax_runner(jax_runners, case)
    js = jr.run(10)
    tm = port_model(case)
    ts = tm.run(tm.initial_state(jr.seed), 10)
    tl = port_leaves(ts)
    assert tl[".rng"].dtype == np.uint32 and ".s_stir" in tl
    close_dicts(tl, jax_leaves(js), 1e-9, "state")
    close_dicts(as_np(tm.diag_fields(ts)), as_np(jr.model.diag_fields(js)), 1e-9, "diag_fields")
    close_dicts(as_np(tm.diagnostics(ts)), as_np(jr.model.diagnostics(js)), 1e-9, "diagnostics")
    if CASES[case][1].get("stirring_amplitude"):
        assert float(np.abs(tl[".s_stir"]).max()) > 0.0


@pytest.mark.parametrize("name", ["barotropic_vort_eq_stirring", "shallow_water_stirring"])
def test_two_days_match_trip_goldens(name):
    with open(REPO / "tests" / "goldens" / "trip_goldens.json") as f:
        golden = json.load(f)[name]
    model = port_model(name)
    steps = int(round(trip_test.DAYS * 86400.0 / model.config.dt))
    assert steps == 144
    state = model.run(model.initial_state(), steps, first=True)
    got = {k: trip_test.field_stats(v.numpy()) for k, v in sorted(model.diag_fields(state).items())}
    errors = trip_test.compare(name, got, golden)
    assert not errors, "\n".join(errors)


# ---------------------------------------------------------------------------
# restarts, state conversion, CLI, configs, validity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["isca_tpu", "isca_tpu_torch"])
@pytest.mark.parametrize("case", ["barotropic_vort_eq_stirring", "shallow_water_stirring"])
def test_restart_interchange(jax_runners, tmp_path, case, writer):
    """A restart written after 2 steps by one package loads in the other, key
    included, and both continue alike."""
    jr = jax_runner(jax_runners, case)
    tm = port_model(case)
    path = str(tmp_path / "res.npz")
    if writer == "isca_tpu":
        js = jr.run(2)
        jrestart.save_restart(path, js)
        loaded = trestart.load_restart(path, tm.initial_state())
        close_dicts(port_leaves(loaded), jax_leaves(js), 0.0, "restart")
        close_dicts(port_leaves(tm.run(loaded, 3, first=False)),
                    jax_leaves(jr.rest(jr.rest(jr.rest(js)))), 1e-9, "continued")
    else:
        ts = tm.run(tm.initial_state(), 2)
        trestart.save_restart(path, ts)
        with np.load(path) as data:
            paths = json.loads(str(data["_paths"]))
            assert data[f"leaf_{paths.index('.rng')}"].dtype == np.uint32
        loaded = jrestart.load_restart(path, jr.model.initial_state())
        close_dicts(jax_leaves(loaded), port_leaves(ts), 0.0, "restart")
        close_dicts(port_leaves(tm.run(ts, 3, first=False)),
                    jax_leaves(jr.rest(jr.rest(jr.rest(loaded)))), 1e-9, "continued")


@pytest.mark.parametrize("kind", ["barotropic", "shallow"])
def test_convert_round_trip_and_missing_key(kind):
    case = {"barotropic": "barotropic_vort_eq_stirring", "shallow": "shallow_water_stirring"}[kind]
    to_np, from_np, keys = TO_NUMPY[kind]
    tm = port_model(case)
    d = to_np(tm.run(tm.initial_state(), 2))
    assert set(d) == set(keys)
    assert d["rng"].dtype == np.uint32 and d["vors_curr"].dtype == np.complex128
    assert d["s_stir"].dtype == np.complex128 and d["u_curr"].dtype == np.float64
    back = to_np(from_np(d, torch.float64, device="cpu"))
    for k in keys:
        np.testing.assert_array_equal(back[k], d[k], err_msg=k)
        assert back[k].dtype == d[k].dtype, k
    s32 = from_np(d, torch.float32, device="cpu")
    assert s32.vors.curr.dtype == torch.complex64 and s32.u.curr.dtype == torch.float32
    assert s32.rng.dtype == torch.uint32
    del d["rng"]
    with pytest.raises(KeyError, match="rng"):
        from_np(d, torch.float64, device="cpu")


@pytest.mark.parametrize("model,fields", [("barotropic", ("ucomp", "vcomp", "vor")),
                                          ("shallow", ("ucomp", "vcomp", "vor", "h"))])
def test_cli_simple_models(tmp_path, model, fields):
    from scipy.io import netcdf_file

    argv = ["simple", "--model", model, "--resolution", "T21", "--dt", "3600",
            "--days", "1", "--daily", "--device", "cpu", "--datadir", str(tmp_path)]
    assert tmain.main(argv) == 0
    built = tmain.build_model(tmain.argparse.Namespace(
        model=model, resolution="T21", levels=8, dt=3600.0, device="cpu"))
    assert isinstance(built, PKGS["torch"][model][1])
    with netcdf_file(str(tmp_path / "simple" / "run0001" / "atmos_daily.nc"), mmap=False) as nc:
        got = {k: np.array(v[:]) for k, v in nc.variables.items() if k in fields}
    assert set(got) == set(fields)
    for v in got.values():
        assert v.shape == (1, 32, 64) and np.isfinite(v).all()
    assert (tmp_path / "simple" / "restarts" / "res0001.npz").exists()


@pytest.mark.parametrize("kind", ["barotropic", "shallow"])
def test_configs_mirror_isca_tpu(kind):
    jcls, tcls = PKGS["jax"][kind][0], PKGS["torch"][kind][0]
    jf = {f.name: f.default for f in dataclasses.fields(jcls)}
    tf = {f.name: f.default for f in dataclasses.fields(tcls)}
    assert list(tf) == list(jf)
    for k in jf:
        if k != "dtype":
            assert tf[k] == jf[k], k
    assert tf["dtype"] == torch.float32 and jf["dtype"] == jnp.float32
    jstate = [f.name for f in dataclasses.fields(
        {"barotropic": jbaro.BarotropicState, "shallow": jshallow.ShallowState}[kind])]
    tstate = [f.name for f in dataclasses.fields(
        {"barotropic": tbaro.BarotropicState, "shallow": tshallow.ShallowState}[kind])]
    assert tstate == jstate


@pytest.mark.parametrize("case", ["barotropic_vort_eq_stirring", "shallow_water_stirring"])
def test_wind_guard_matches_isca_tpu(jax_runners, case):
    jr = jax_runner(jax_runners, case)
    tm = port_model(case)
    ts = tm.initial_state()
    assert bool(tm.validity(ts).ok)
    assert tm.validity_name == jr.model.validity_name
    assert tm.validity_range == jr.model.validity_range
    u = ts.u.curr.clone()
    u[3, 5] = 2.0e3
    bad = dataclasses.replace(ts, u=ts.u._replace(curr=u))
    rep = tm.validity(bad)
    jbad = jr.model.initial_state()
    jbad = dataclasses.replace(jbad, u=jbad.u._replace(curr=jnp.asarray(u.numpy())))
    jrep = jr.model.validity(jbad)
    assert not bool(rep.ok) and not bool(jrep.ok)
    assert float(rep.vmax) == float(jrep.vmax) == 2.0e3
    np.testing.assert_array_equal(rep.max_idx.numpy(), np.asarray(jrep.max_idx))
