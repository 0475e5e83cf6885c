"""The run harness of isca_tpu_torch against isca_tpu's: time manager,
checksums, restarts (both ways), change_resolution, spectral_diagnostics,
the validity message, Experiment with NetCDF diagnostics and restart
chaining, alerts, logging and the CLI.

Held-Suarez at T21L8, dt = 1800 s, float64 on the CPU (as
tests/test_infrastructure.py), and the column_test_case model (grey
radiation) on 2 x 4 columns at dt = 1800 s. Tolerances:

* isca_tpu's tables and digests (ModelTime, chksum, restart key paths,
  describe_violation, CLI file tree, NetCDF coordinates): equal.
* NetCDF fields written by both packages: within 2 float32 ulps (rtol
  2.5e-7, atol 1e-7 x max|field|): the float64 averages agree to ~1e-12,
  and each side rounds once to float32.
* Restart leaves after one or two 1-day segments, and spectral_diagnostics
  after 6 steps: rtol 1e-9 and 1e-10 of each leaf's largest entry (the same
  arithmetic, reassociated). change_resolution: 1e-12 (a pad and a
  bilinear regrid of the same input).
* The port against itself (a chained run against a direct run, a restart
  round trip): equal to the bit (torch.equal), as the same eager ops run in
  the same order.
"""

import json
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import netcdf_file

import isca_tpu.__main__ as jmain
import isca_tpu.utils.alerts as jalerts
from isca_tpu.dycore.primitive import PrimitiveConfig as JPC
from isca_tpu.experiment import Experiment as JExperiment
from isca_tpu.io import restart as jrestart
from isca_tpu.io.diag_manager import DiagTable as JDiagTable
from isca_tpu.models.column import ColumnConfig as JColCfg
from isca_tpu.models.column import ColumnModel as JColModel
from isca_tpu.models.dry import HeldSuarezConfig as JHSC
from isca_tpu.models.dry import HeldSuarezModel as JHSM
from isca_tpu.utils import chksum as jchk
from isca_tpu.utils import validity as jval
from isca_tpu.utils.events import FailedRunError as JFailedRunError
from isca_tpu.utils.time_manager import ModelTime as JModelTime
import isca_tpu_torch.__main__ as tmain
from isca_tpu_torch.dycore.primitive import PrimitiveConfig as TPC
from isca_tpu_torch.experiment import Experiment
from isca_tpu_torch.io import restart as trestart
from isca_tpu_torch.io.diag_manager import DiagTable
from isca_tpu_torch.models.column import ColumnConfig, ColumnModel
from isca_tpu_torch.models.dry import HeldSuarezConfig, HeldSuarezModel
from isca_tpu_torch.utils import alerts
from isca_tpu_torch.utils import chksum as tchk
from isca_tpu_torch.utils import validity as tval
from isca_tpu_torch.utils.events import EventEmitter, FailedRunError
from isca_tpu_torch.utils.time_manager import ModelTime
from isca_tpu_torch.utils.tree import flatten_with_paths

HS = dict(resolution="T21", num_levels=8, dt=1800.0)
COL = dict(nlat=2, nlon=4, num_levels=25, dt=1800.0)
NC_RTOL, NC_ATOL = 2.5e-7, 1e-7        # NetCDF: 2 float32 ulps; atol x max|field|
STATE_RTOL = 1e-9                      # restart leaves, x max|leaf|
EVENTS = ("run:ready", "run:progress", "run:complete", "run:failed")


def hs_models(dtype=jnp.float64, **core):
    kw = {**HS, **core}
    tdtype = torch.float64 if dtype == jnp.float64 else torch.float32
    return (JHSM(JHSC(core=JPC(dtype=dtype, **kw))),
            HeldSuarezModel(HeldSuarezConfig(core=TPC(dtype=tdtype, **kw)), device="cpu"))


def column_models():
    return (JColModel(JColCfg(dtype=jnp.float64, **COL)),
            ColumnModel(ColumnConfig(dtype=torch.float64, **COL), device="cpu"))


def hs_table(table_cls):
    t = table_cls().add_file("atmos_daily", 86400)
    t.add_field("atmos_daily", "dynamics", "temp", time_avg=True)
    t.add_field("atmos_daily", "dynamics", "ps", time_avg=True)
    t.add_field("atmos_daily", "dynamics", "ucomp", time_avg=False)
    t.add_field("atmos_daily", "dynamics", "vcomp", reduction="max")
    t.add_field("atmos_daily", "dynamics", "omega", reduction="min")
    return t


def column_table(table_cls):
    t = table_cls().add_file("atmos_daily", 86400)
    t.add_field("atmos_daily", "dynamics", "temp", time_avg=True)
    t.add_field("atmos_daily", "dynamics", "t_surf", time_avg=True)
    return t


def record_events(exp):
    seen = []
    for ev in EVENTS:
        exp.on(ev, lambda e, i, *a, ev=ev: seen.append((ev, i) + tuple(a)))
    return seen


def read_nc(path):
    with netcdf_file(path, "r", mmap=False) as nc:
        return {k: (np.array(v[:]), v.typecode()) for k, v in nc.variables.items()}


def assert_nc_agree(port_path, ref_path):
    port, ref = read_nc(port_path), read_nc(ref_path)
    assert sorted(port) == sorted(ref)
    for k, (b, code) in ref.items():
        a, code_port = port[k]
        assert code_port == code and a.shape == b.shape, k
        if k in ("time", "lat", "lon", "pfull", "phalf"):
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            assert np.isfinite(a).all(), k
            np.testing.assert_allclose(a, b, rtol=NC_RTOL,
                                       atol=NC_ATOL * np.abs(b).max(), err_msg=k)


def restart_leaves(path):
    with np.load(path) as d:
        paths = json.loads(str(d["_paths"]))
        return paths, [d[f"leaf_{i}"] for i in range(len(paths))]


def assert_restarts_agree(port_path, ref_path, rtol=STATE_RTOL):
    pp, port = restart_leaves(port_path)
    rp, ref = restart_leaves(ref_path)
    assert pp == rp
    for p, a, b in zip(pp, port, ref):
        assert a.dtype == b.dtype and a.shape == b.shape, p
        np.testing.assert_allclose(a, b, rtol=0, atol=rtol * np.abs(b).max(), err_msg=p)


def assert_states_equal(a, b):
    fa, fb = flatten_with_paths(a), flatten_with_paths(b)
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (p, x), (_, y) in zip(fa, fb):
        assert x.dtype == y.dtype and torch.equal(x, y), p


def jax_paths(state):
    return [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(state)[0]]


# ---------------------------------------------------------------------------
# both packages run the same experiments (one run each, shared by the tests)
# ---------------------------------------------------------------------------

def run_pair(root, name, models, table, days=1, segments=2):
    """isca_tpu and the port through their Experiments, `segments` chained
    segments each; returns both experiments' directories and event lists."""
    out = {}
    for pkg, model, exp_cls, table_cls in (("jax", models[0], JExperiment, JDiagTable),
                                           ("torch", models[1], Experiment, DiagTable)):
        exp = exp_cls(name, model, table(table_cls), datadir=str(root / pkg))
        events = record_events(exp)
        for i in range(1, segments + 1):
            exp.run(i, days=days)
        out[pkg] = (exp.datadir, events)
    return out


@pytest.fixture(scope="module")
def hs_pair(tmp_path_factory):
    return run_pair(tmp_path_factory.mktemp("hs"), "hs", hs_models(), hs_table)


@pytest.fixture(scope="module")
def column_pair(tmp_path_factory):
    return run_pair(tmp_path_factory.mktemp("col"), "column", column_models(), column_table)


PAIRS = {"held_suarez": "hs_pair", "column": "column_pair"}


# ---------------------------------------------------------------------------
# time manager, chksum, validity message
# ---------------------------------------------------------------------------

# the four calendar cases of tests/test_infrastructure.py::TestTimeManager
@pytest.mark.parametrize("date,calendar,advance", [
    ((2, 3, 15, 6, 30, 0), "thirty_day_months", 86400 * 16),
    ((1, 2, 28), "noleap", 86400),
    ((4, 2, 28), "julian", 86400),
    ((1, 7, 1), "thirty_day_months", 0),
])
def test_model_time_matches(date, calendar, advance):
    t = ModelTime.from_date(*date, calendar=calendar) + advance
    j = JModelTime.from_date(*date, calendar=calendar) + advance
    assert t.seconds == j.seconds
    assert t.date() == j.date()
    assert t.fraction_of_year() == j.fraction_of_year()
    assert t.fraction_of_day() == j.fraction_of_day()


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.complex64, np.complex128])
def test_chksum_matches(dtype):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((16, 24))
    if np.iscomplexobj(np.zeros((), dtype)):
        x = x + 1j * rng.standard_normal((16, 24))
    x = x.astype(dtype)
    t = torch.from_numpy(x)
    assert tchk.chksum(t) == jchk.chksum(jnp.asarray(x)) == jchk.chksum(x)
    # a strided view digests as its contiguous copy
    assert tchk.chksum(t.T) == jchk.chksum(np.ascontiguousarray(x.T))
    tree = {"b": {"c": t[:2]}, "a": t}
    jtree = {"b": {"c": jnp.asarray(x[:2])}, "a": jnp.asarray(x)}
    assert tchk.tree_chksum(tree) == jchk.tree_chksum(jtree)
    assert list(tchk.tree_chksum(tree)) == ["['a']", "['b']['c']"]
    assert tchk.combined_chksum(tree) == jchk.combined_chksum(jtree)


@pytest.mark.parametrize("case", ["located_3d", "bare_2d", "in_range"])
def test_describe_violation_matches(case):
    f = np.full((4, 5, 6) if case == "located_3d" else (5, 6), 250.0)
    if case != "in_range":
        f[(2, 3, 1) if f.ndim == 3 else (3, 1)] = 90.0
        f[(1, 0, 5) if f.ndim == 3 else (0, 5)] = 510.0
    lats = np.deg2rad(np.linspace(-60, 60, 5))
    lons = np.deg2rad(np.linspace(0, 300, 6))
    grid = dict(lats=lats, lons=lons) if case == "located_3d" else {}
    rep = tval.check_range(torch.from_numpy(f), 100.0, 500.0)
    jrep = jval.check_range(jnp.asarray(f), 100.0, 500.0)
    assert bool(rep.ok) == bool(jrep.ok) == (case == "in_range")
    tgrid = {k: torch.from_numpy(v) for k, v in grid.items()}
    msg = tval.describe_violation("temperature", rep, 100.0, 500.0, **tgrid)
    assert msg == jval.describe_violation("temperature", jrep, 100.0, 500.0, **grid)


# ---------------------------------------------------------------------------
# restarts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model", list(PAIRS))
def test_restart_paths_match(model):
    jm, tm = hs_models() if model == "held_suarez" else column_models()
    paths = [p for p, _ in flatten_with_paths(tm.initial_state())]
    assert paths == jax_paths(jm.initial_state())
    assert ".vors.prev" in paths or ".time_seconds" in paths


@pytest.mark.parametrize("model", list(PAIRS))
def test_restart_loads_in_both_packages(model, request):
    """A restart written by isca_tpu loads into the port with the same
    digests as isca_tpu's own load, and the reverse; column time stays
    float32 at float64."""
    pair = request.getfixturevalue(PAIRS[model])
    jm, tm = hs_models() if model == "held_suarez" else column_models()
    name = "res0001.npz"
    jfile = os.path.join(pair["jax"][0], "restarts", name)
    tfile = os.path.join(pair["torch"][0], "restarts", name)
    from_jax = trestart.load_restart(jfile, tm.initial_state())
    assert tchk.tree_chksum(from_jax) == jchk.tree_chksum(
        jrestart.load_restart(jfile, jm.initial_state()))
    from_port = jrestart.load_restart(tfile, jm.initial_state())
    assert jchk.tree_chksum(from_port) == tchk.tree_chksum(
        trestart.load_restart(tfile, tm.initial_state()))
    if model == "column":
        assert from_jax.time_seconds.dtype == torch.float32
        assert restart_leaves(tfile)[1][-1].dtype == np.float32


def test_restart_round_trip_and_mismatches(tmp_path):
    _, tm = hs_models()
    s = tm.run(tm.initial_state(), 3)
    path = str(tmp_path / "res.npz")
    trestart.save_restart(path, s)
    assert_states_equal(trestart.load_restart(path, tm.initial_state()), s)
    # a float32 template: cast on load
    _, t32 = hs_models(jnp.float32)
    s32 = trestart.load_restart(path, t32.initial_state())
    assert s32.tg.curr.dtype == torch.float32 and s32.vors.curr.dtype == torch.complex64
    _, other = hs_models(num_levels=5)
    with pytest.raises(ValueError, match="resolution mismatch"):
        trestart.load_restart(path, other.initial_state())
    _, col = column_models()
    with pytest.raises(ValueError, match="structure mismatch"):
        trestart.load_restart(path, col.initial_state())


def test_change_resolution_matches(hs_pair):
    jm21, tm21 = hs_models()
    jm42, tm42 = hs_models(resolution="T42")
    src = os.path.join(hs_pair["jax"][0], "restarts", "res0001.npz")
    js = jrestart.change_resolution(jrestart.load_restart(src, jm21.initial_state()),
                                    jm21.core.T, jm42.core.T, jm42.initial_state())
    ts = trestart.change_resolution(trestart.load_restart(src, tm21.initial_state()),
                                    tm21.core.T, tm42.core.T, tm42.initial_state())
    jflat = jax.tree_util.tree_flatten_with_path(js)[0]
    tflat = flatten_with_paths(ts)
    assert [p for p, _ in tflat] == jax_paths(js)
    for (p, a), (_, b) in zip(tflat, jflat):
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape and a.shape[-2:] in ((64, 128), (43, 44)), p
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-12 * np.abs(b).max(),
                                   err_msg=p)


# ---------------------------------------------------------------------------
# spectral_diagnostics (HeldSuarezModel.diag_fields(extended=True))
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("topography", [False, True])
def test_spectral_diagnostics_matches(topography, tmp_path):
    jm, tm = hs_models()
    if topography:
        # a seeded smooth mountain, up to ~1.5 km: sigma > 0.8 starts at
        # other levels in different columns, so slp's level search is used
        rng = np.random.default_rng(5)
        lat = np.asarray(jm.core.T.lats)[:, None]
        lon = np.asarray(jm.core.T.lons)[None, :]
        c_lat, c_lon, amp = rng.uniform(-0.8, 0.8), rng.uniform(0, 2 * np.pi), rng.uniform(1e4, 1.5e4)
        phi = amp * np.exp(-((lat - c_lat) / 0.4) ** 2) * (1.0 + np.cos(lon - c_lon)) / 2.0
        jm.surf_geopotential = jnp.asarray(phi)
        tm.surf_geopotential = torch.from_numpy(phi)
    s = tm.run(tm.initial_state(), 6)
    path = str(tmp_path / "res.npz")
    trestart.save_restart(path, s)
    js = jrestart.load_restart(path, jm.initial_state())
    port = tm.diag_fields(s, extended=True)
    # what jm.diag_fields(js, extended=True) returns, under one jit (eager
    # JAX compiles each of its ~200 ops)
    ref = jax.jit(jm.core.spectral_diagnostics)(js, jm.surf_geopotential)
    assert sorted(port) == sorted(ref)
    for k, b in ref.items():
        a, b = port[k].numpy(), np.asarray(b)
        assert a.shape == b.shape, k
        np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-10 * np.abs(b).max(), err_msg=k)
    if topography:
        assert np.ptp(port["slp"].numpy() - port["ps"].numpy()) > 1e3
    static = tm.core.static_diag_fields()
    jstatic = jm.core.static_diag_fields()
    for k in ("pk", "bk", "zsurf"):
        np.testing.assert_array_equal(static[k].numpy(), np.asarray(jstatic[k]))


# ---------------------------------------------------------------------------
# Experiment
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model", list(PAIRS))
def test_chained_segments_equal_direct_run(model, tmp_path):
    """Two 1-day segments through a restart == one 2-day run, to the bit."""
    make = (lambda: hs_models()[1]) if model == "held_suarez" else (lambda: column_models()[1])
    exp = Experiment("chain", make(), None, datadir=str(tmp_path))
    exp.run(1, days=1)
    chained = exp.run(2, days=1)
    direct_model = make()
    direct = direct_model.run(direct_model.initial_state(), 96)
    assert_states_equal(chained, direct)
    res = trestart.load_restart(os.path.join(exp.datadir, "restarts", "res0002.npz"),
                                direct_model.initial_state())
    assert_states_equal(res, direct)


@pytest.mark.parametrize("model", list(PAIRS))
def test_experiment_matches_isca_tpu(model, request):
    """The same 2 x 1-day experiment through both packages: NetCDF files,
    restarts and events agree."""
    pair = request.getfixturevalue(PAIRS[model])
    (jdir, jevents), (tdir, tevents) = pair["jax"], pair["torch"]
    assert tevents == jevents
    assert [e[0] for e in tevents] == ["run:ready", "run:progress", "run:complete"] * 2
    for i in (1, 2):
        run = f"run{i:04d}"
        assert sorted(os.listdir(os.path.join(tdir, run))) == sorted(
            os.listdir(os.path.join(jdir, run)))
        assert_nc_agree(os.path.join(tdir, run, "atmos_daily.nc"),
                        os.path.join(jdir, run, "atmos_daily.nc"))
        res = os.path.join("restarts", f"res{i:04d}.npz")
        assert_restarts_agree(os.path.join(tdir, res), os.path.join(jdir, res))
    rec = read_nc(os.path.join(tdir, "run0002", "atmos_daily.nc"))
    assert rec["time"][0].tolist() == [2.0]
    if model == "held_suarez":
        assert rec["temp"][0].shape == (1, 8, 32, 64) and rec["ps"][0].shape == (1, 32, 64)
    else:
        assert rec["temp"][0].shape == (1, 25, 2, 4) and rec["t_surf"][0].shape == (1, 2, 4)


def test_port_continues_from_isca_tpu_restart(hs_pair, tmp_path):
    _, tm = hs_models()
    exp = Experiment("cont", tm, hs_table(DiagTable), datadir=str(tmp_path))
    jdir = hs_pair["jax"][0]
    exp.run(2, days=1, restart_file=os.path.join(jdir, "restarts", "res0001.npz"))
    assert_restarts_agree(os.path.join(exp.datadir, "restarts", "res0002.npz"),
                          os.path.join(jdir, "restarts", "res0002.npz"))
    assert_nc_agree(os.path.join(exp.datadir, "run0002", "atmos_daily.nc"),
                    os.path.join(jdir, "run0002", "atmos_daily.nc"))


def test_validity_abort_matches_isca_tpu(tmp_path):
    """Temperature outside an absurdly tight valid_range_t: the same
    located-extremum message as isca_tpu's, after the day's diagnostics
    were flushed (test_infrastructure.py::test_experiment_aborts_...)."""
    jm, tm = hs_models(valid_range_t=(263.9, 264.1))
    msgs, failed = [], []
    for pkg, model, exp_cls, table_cls in (("jax", jm, JExperiment, JDiagTable),
                                           ("torch", tm, Experiment, DiagTable)):
        table = table_cls().add_file("atmos_daily", 86400)
        table.add_field("atmos_daily", "dynamics", "temp", time_avg=True)
        exp = exp_cls("bad_run", model, table, datadir=str(tmp_path / pkg))
        exp.on("run:failed", lambda e, i, pkg=pkg: failed.append((pkg, i)))
        with pytest.raises(FailedRunError if pkg == "torch" else JFailedRunError) as ei:
            exp.run(1, days=2)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]
    assert msgs[1].startswith("segment 1 at day 1.00: temperature out of valid range")
    assert "lat" in msgs[1] and "level" in msgs[1]
    assert failed == [("jax", 1), ("torch", 1)]
    rec = read_nc(str(tmp_path / "torch" / "bad_run" / "run0001" / "atmos_daily.nc"))
    assert rec["time"][0].tolist() == [1.0] and np.isfinite(rec["temp"][0]).all()
    assert not os.path.exists(tmp_path / "torch" / "bad_run" / "restarts" / "res0001.npz")


def test_json_logging_and_nonfinite_abort(tmp_path):
    _, tm = hs_models()
    exp = Experiment("events", tm, None, datadir=str(tmp_path), json_logging=True)
    exp.run(1, days=2)
    rows = [json.loads(line) for line in open(os.path.join(exp.datadir, "run0001",
                                                           "steps.jsonl"))]
    assert [r["day"] for r in rows] == [1.0, 2.0]
    assert 150 < rows[-1]["tmin"] <= rows[-1]["tmax"] < 500
    assert rows[-1]["mean_ps"] == pytest.approx(101325.0, rel=1e-3)
    failed = []
    exp.on("run:failed", lambda e, i: failed.append(i))
    real = tm.diagnostics
    tm.diagnostics = lambda s: {**real(s), "tmin": float("nan")}
    with pytest.raises(FailedRunError, match="non-finite"):
        exp.run(2, days=1)
    assert failed == [2]


def test_profile_writes_trace(tmp_path):
    _, tm = hs_models()
    exp = Experiment("prof", tm, None, datadir=str(tmp_path), profile=True)
    exp.run(1, days=1)
    trace = os.path.join(exp.datadir, "run0001", "profile", "trace.json")
    assert os.path.getsize(trace) > 0


def test_progress_derive_and_prune(tmp_path):
    import io
    from isca_tpu_torch.utils.loghandler import exp_progress
    _, tm = hs_models()
    exp = Experiment("prog", tm, None, datadir=str(tmp_path))
    buf = io.StringIO()
    with exp_progress(exp, description="t", out=buf) as p:
        p._bar = None
        exp.run(1, days=2)
    assert "segment 1 day 2.00" in buf.getvalue()
    assert not exp._events.get("run:progress")
    d = exp.derive("prog_derived")
    assert d.model is exp.model and d.datadir.endswith("prog_derived")
    d.run(1, days=1)
    assert sorted(os.listdir(os.path.join(d.datadir, "run0001"))) == [
        "git_hash_used.txt", "provenance.json"]
    rdir = os.path.join(exp.datadir, "restarts")
    for i in range(2, 8):
        open(os.path.join(rdir, f"res{i:04d}.npz"), "wb").close()
    deleted = exp.prune_restarts(keep_every=3, keep_last=1)
    assert sorted(os.listdir(rdir)) == ["res0003.npz", "res0006.npz", "res0007.npz"]
    assert len(deleted) == 4


def test_colored_formatter_and_logger():
    from isca_tpu_torch.utils.loghandler import ColoredFormatter, enable_colored_logging
    rec = logging.LogRecord("isca_tpu_torch", logging.WARNING, "x", 1, "hi", (), None)
    assert "\033[33m" in ColoredFormatter(use_color=True).format(rec)
    assert "\033" not in ColoredFormatter(use_color=False).format(rec)
    log = enable_colored_logging()
    n = len(log.handlers)
    assert log.name == "isca_tpu_torch" and enable_colored_logging() is log
    assert len(log.handlers) == n


def test_clocks():
    from isca_tpu_torch.utils.clocks import Clocks
    c = Clocks()
    with c.clock("a"):
        pass
    assert "rss" in c.summary() and c._count["a"] == 1


def test_source_control_status(tmp_path):
    out = tmp_path / "git_hash_used.txt"
    s = alerts.write_source_control_status(str(out))
    assert out.read_text().startswith("*---commit hash used for isca_tpu_torch code")
    assert s["commit"]
    # outside a git tree the commit is "unknown", as isca_tpu's
    assert alerts.source_control_status(str(tmp_path))["commit"] == "unknown"
    assert jalerts.source_control_status(str(tmp_path))["commit"] == "unknown"


def test_disk_guard(tmp_path):
    em = EventEmitter()
    events = []
    em.on("disk:low", lambda *a: events.append(a))
    assert alerts.check_disk_space(str(tmp_path), limit_gb=0.0, cutoff_gb=0.0) > 0
    alerts.check_disk_space(str(tmp_path), limit_gb=1e9, cutoff_gb=0.0, emitter=em)
    assert len(events) == 1 and events[0][2] is False
    with pytest.raises(alerts.DiskSpaceError):
        alerts.check_disk_space(str(tmp_path), limit_gb=1e9, cutoff_gb=1e9, emitter=em)
    assert events[-1][2] is True
    # the Experiment checks before any compute
    _, tm = hs_models()
    exp = Experiment("disk", tm, None, datadir=str(tmp_path),
                     disk_limit_gb=1e9, disk_cutoff_gb=1e9)
    with pytest.raises(alerts.DiskSpaceError):
        exp.run(1, days=1)
    assert not os.path.exists(os.path.join(exp.datadir, "restarts", "res0001.npz"))


def test_email_on_failure(tmp_path, monkeypatch):
    sent = []
    monkeypatch.setattr(alerts, "send_email", lambda rcpt, msg, **kw: sent.append((rcpt, msg)))
    _, tm = hs_models(valid_range_t=(263.9, 264.1))
    exp = Experiment("alert_run", tm, None, datadir=str(tmp_path))
    alerts.email_on_failure(exp, "user@example.com")
    with pytest.raises(FailedRunError):
        exp.run(1, days=1)
    assert sent == [("user@example.com", "experiment alert_run segment 1 FAILED")]
    assert os.path.exists(os.path.join(exp.datadir, "run0001", "git_hash_used.txt"))
    exp.emit("disk:low", "/x", 1.5, True)
    assert sent[-1] == ("user@example.com", "disk space low: 1.5 GB free at /x (run aborted)")


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def file_tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def test_cli_matches_isca_tpu(tmp_path):
    """The same arguments through both CLIs (float32 HS at T21L8, two daily
    segments): the same files, and atmos_daily.nc within 3x isca_tpu's own
    float32-versus-float64 difference (the port's float64 run stands for
    isca_tpu's: they agree to ~1e-12), the rule of tests/test_torch_dry.py."""
    args = ["cli", "--resolution", "T21", "--levels", "8", "--dt", "1800",
            "--days", "1", "-n", "2", "--daily"]
    assert jmain.main(args + ["--datadir", str(tmp_path / "jax")]) == 0
    assert tmain.main(args + ["--datadir", str(tmp_path / "torch"), "--device", "cpu"]) == 0
    jroot, troot = tmp_path / "jax" / "cli", tmp_path / "torch" / "cli"
    assert file_tree(troot) == file_tree(jroot)
    assert "run0002/atmos_daily.nc" in file_tree(troot)
    _, t64 = hs_models()
    table = DiagTable().add_file("atmos_daily", 86400)
    for f in ("ucomp", "vcomp", "temp", "ps"):
        table.add_field("atmos_daily", "dynamics", f, time_avg=True)
    exp64 = Experiment("cli64", t64, table, datadir=str(tmp_path / "f64"))
    exp64.run(1, days=1)
    exp64.run(2, days=1)
    for run in ("run0001", "run0002"):
        port, ref = (read_nc(str(r / run / "atmos_daily.nc")) for r in (troot, jroot))
        ref64 = read_nc(os.path.join(exp64.datadir, run, "atmos_daily.nc"))
        assert sorted(port) == sorted(ref)
        for k in ("time", "lat", "lon", "pfull", "phalf"):
            np.testing.assert_array_equal(port[k][0], ref[k][0], err_msg=k)
        for k in ("ucomp", "vcomp", "temp", "ps"):
            a, b, b64 = port[k][0].astype(np.float64), ref[k][0], ref64[k][0]
            gap = np.abs(b.astype(np.float64) - b64).max()
            assert gap > 0 and np.abs(a - b).max() <= 3.0 * gap, (run, k)


@pytest.mark.parametrize("model", ["barotropic", "shallow", "giant"])
def test_cli_unported_models_raise(model, tmp_path):
    """The CLI's last three models were ported, so none raises any more: each
    builds the model class isca_tpu's CLI builds (their runs are tested in
    tests/test_torch_simple.py and tests/test_torch_giant.py)."""
    assert model in tmain.MODELS and tmain.MODELS == jmain.MODELS
    assert not hasattr(tmain, "UNPORTED")
    args = tmain.argparse.Namespace(model=model, resolution="T21", levels=4, dt=1800.0,
                                    device="cpu")
    assert type(tmain.build_model(args)).__name__ == type(jmain.build_model(args)).__name__
