"""The MiMA GCMs on the port's mesh: mima_test_case_config() and mima_gwd,
sharded over 4 gloo ranks on the CPU, against isca_tpu's single-device runs
and the port's own; and the helpers of tests/test_torch_parallel_clouds.py
and tests/test_torch_parallel_models.py, which do the same for the other
models.

One `spawn` of 4 gloo ranks per file (one torch thread each) runs
tests/torch_sharded_cases.py's `run_gcm(..., which)`: each case cut to
T21L8 at float64 (PrimitiveConfig(mesh=...), or the model's mesh argument),
3 leapfrog steps from the cold start (first=False: the forward first step
is held by tests/test_torch_parallel.py and the card's `sharded` phase,
and isca_tpu then compiles one step per case); rank 0 writes the gathered state and last-step grid diagnostics,
each rank its block of the spectral temperature or vorticity. Here the
ranks then write a tile restart of MiMA's state (RadCache, TKE and the
bucket among its leaves) and read it back. Meanwhile this process runs
isca_tpu's single-device runs (one compile of each case's 3 steps) and the
port's single-device runs with the mesh's m padding.

* mima_test_case_config() (RRTMG-SW with RRTMG-LW, seasonal sun, full
  Betts-Miller), so that sw_flux runs on each rank's band; mima_gwd with
  the convective gravity-wave drag and the seeded ozone and q-flux series,
  which every rank builds on the whole globe and cuts to its band.
* Every leaf of the sharded state against isca_tpu's single device on the
  true m rows, within rtol of the leaf's largest entry: for the seasonal
  RRTM and SOCRATES GCMs (ROADMAP C.5) 3x the largest gap measured after 3
  steps (SEASONAL_RTOL), 1e-9 for the others; and against
  the port's single device at rtol 1e-9, with the last step's grid
  diagnostics and the global means and extrema of `diagnostics()` (each
  an all_reduce on the mesh); each rank's m block distinct.
* The MiMA tile set both ways: isca_tpu's combine of the port's tiles is
  the port's gathered state, and a tile set isca_tpu writes of that state
  on its 8 virtual devices loads into each of the port's 4 ranks' blocks
  bit for bit.

The ranks import no JAX.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_sharded_cases as cases
from isca_tpu.dycore.time_integration import TwoLevel as JTwoLevel
from isca_tpu.io import distributed as jdio
from isca_tpu.models import column as jcolumn
from isca_tpu.models import giant as jgiant
from isca_tpu.models import moist as jmoist
from isca_tpu.models import shallow as jshallow
from isca_tpu.parallel import mesh as jmesh
from isca_tpu.physics import rrtmg_sw as jsw
from isca_tpu.physics import socrates as jsocrates
from isca_tpu.utils import time_interp as jti
from isca_tpu_torch.io import distributed as dio
from isca_tpu_torch.models import cases as mcases
from isca_tpu_torch.parallel.mesh import Mesh, shard_pytree, spawn
from isca_tpu_torch.utils.tree import flatten_with_paths, unflatten
from tests.test_torch_gcm_ras import jax_series, one_torch_thread, to_jax  # noqa: F401
from tests.test_torch_parallel import jax_leaves, leaves_np, read, true_rows

# the committed LW k-tables are synthetic, and say so at every construction
pytestmark = pytest.mark.filterwarnings("ignore:RRTMG-LW is running on SYNTHETIC")
RTOL = 1e-9
# Against isca_tpu, the GCMs whose radiation takes the seasonal declination
# from the float32 clock (ROADMAP C.5: XLA's float32 arcsin is one ulp off
# torch's) differ by more than RTOL. After the 3 steps the largest gap of
# any leaf, relative to its largest entry, measured 1.04e-7 (mima, in
# rad_cache.tdt_solar), 2.97e-7 (mima_gwd, rad_cache.tdt_rad), 1.18e-7
# (simple_clouds, dyn.divg) and 9.8e-8 (socrates_cloud, rad_cache.tdt_solar);
# each is held at 3x its gap, rounded up to one figure. Against the port's
# single device every case is held at RTOL.
SEASONAL_RTOL = {"mima": 4e-7, "mima_gwd": 9e-7, "simple_clouds": 4e-7,
                 "socrates_cloud": 3e-7}
WHICH = "mima"
JAX_DEVICES = 8
# isca_tpu's cloud optics cache their tables at the first call: fill it
# outside any trace (ROADMAP C.9)
jsw._CldTables()


# ---- the port's single-device runs (this process) -------------------------

def port_single(name):
    """The port's single-device model of a case with the mesh's m padding
    (pad_m_to=NRANKS; shallow water's 32 m rows need none), its 3 steps'
    state and last-step grid diagnostics as numpy leaves."""
    model = cases.gcm_model(name, device="cpu")
    if hasattr(model, "core"):
        core = dataclasses.replace(model.config.core, pad_m_to=cases.NRANKS)
        model = _with_core(name, model, core)
    state, diag = cases.gcm_steps(name, model, cases.gcm_start(name, model))
    diag = {f"['{k}']": v.numpy() for k, v in diag.items()
            if torch.is_tensor(v) and v.ndim >= 2}
    means = ({f"['{k}']": v.numpy() for k, v in cases.global_means(model, state).items()}
             if hasattr(model, "diagnostics") else {})
    return leaves_np(state), diag, means


def _with_core(name, model, core):
    """The case's model rebuilt with another core configuration, with what
    gcm_model attaches after construction."""
    from isca_tpu_torch.models.moist import GreyMoistModel

    new = GreyMoistModel(dataclasses.replace(model.config, core=core), device="cpu")
    if name == "socrates_cloud":
        new.physics.radiation = model.physics.radiation
    for attr in ("o3_series", "qflux_series", "sst_series", "ice_series", "hprime"):
        setattr(new.physics, attr, getattr(model.physics, attr))
    if model.land_mask is not None:
        new.land_mask = new.physics.land_mask = model.land_mask
        new.surf_geopotential = model.surf_geopotential
        new.physics.zsurf = model.physics.zsurf
    return new


# ---- isca_tpu's single-device runs (this process) ---------------------------

def jax_model(name, tm):
    """isca_tpu's model of a case, fed what the port's single-device model
    `tm` is fed (land, topography, hprime, series, float64 SOCRATES)."""
    if name == "giant":
        return jgiant.giant_planet_model(resolution="T21", num_levels=8, dtype=jnp.float64)
    cfg = to_jax(tm.config)
    if name == "shallow":
        return jshallow.ShallowModel(cfg)
    if name == "column":
        return jcolumn.ColumnModel(cfg)
    jm = jmoist.GreyMoistModel(cfg)
    lat = np.degrees(tm.core.T.lats.numpy())
    nlon = tm.core.T.nlon
    if name == "mima_gwd":
        jm.physics.o3_series = jti.PressureTimeSeries(
            series=jax_series(mcases.ozone_fields(lat)), plevs=jnp.asarray(mcases.O3_PLEVS))
        jm.physics.qflux_series = jax_series(mcases.qflux_fields(lat, nlon, mcases.SEED + 1))
    if name in ("continents", "continents_sst"):
        land, topo = mcases.continents_land(tm)
        jm.set_land(land, surf_geopotential=topo)
    if name == "continents_sst":
        jm.physics.hprime = jnp.where(jnp.asarray(land) > 0.5, mcases.HPRIME_LAND, 0.0)
        jm.physics.sst_series = jax_series(mcases.sst_fields(lat, nlon, mcases.SEED + 2))
        jm.physics.ice_series = jax_series(mcases.ice_fields(lat, nlon, mcases.SEED + 3))
    if name == "socrates_cloud":
        jm.physics.radiation = jsocrates.SocratesRadiation(
            to_jax(tm.config.physics.socrates), dtype=jnp.float64)
    return jm


def jax_start(name, jm):
    if name != "column":
        return jm.initial_state()
    c = jm.config
    d = {k: jnp.asarray(v) for k, v in
         cases.column_start(c.nlat, c.nlon, c.num_levels).items()}
    two = lambda n: JTwoLevel(d[f"{n}_prev"], d[f"{n}_curr"])
    return jcolumn.ColumnState(t=two("t"), q=two("q"), u=two("u"), v=two("v"),
                               t_surf=d["t_surf"], time_seconds=d["time_seconds"])


def jax_single(name):
    """isca_tpu's 3 leapfrog steps of a case on one device (first=False,
    as the port's cases run them: one compile of one step), as numpy
    leaves."""
    tm = cases.gcm_model(name, device="cpu")
    jm = jax_model(name, tm)
    run = jax.jit(lambda s: jm.run(s, cases.GCM_STEPS, first=False))
    return jax_leaves(run(jax_start(name, jm)))


# ---- fixtures ---------------------------------------------------------------

def references_of(which):
    """isca_tpu's and the port's single-device results of GCM_FILES[which]."""
    return {name: (jax_single(name), port_single(name)) for name in cases.GCM_FILES[which]}


def ranks_fixture(which, tmp_path_factory):
    """The 4 ranks of GCM_FILES[which], started first so that they run beside
    this process's runs; the spawn context and the output directory."""
    out = tmp_path_factory.mktemp(f"sharded_{which}")
    ctx = spawn(cases.run_gcm, cases.NRANKS, "gloo", str(out / "init"),
                args=(str(out), which), threads=1, join=False)
    return ctx, out


def join(ctx, out):
    while not ctx.join():
        pass
    return out


def stop(ctx):
    for p in ctx.processes:
        if p.is_alive():
            p.terminate()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    ctx, out = ranks_fixture(WHICH, tmp_path_factory)
    yield ctx, out
    stop(ctx)


@pytest.fixture(scope="module")
def references(ranks):
    return references_of(WHICH)


@pytest.fixture(scope="module")
def sharded(ranks, references):
    return join(*ranks)


# ---- the checks (the three files) ---------------------------------------------

def close(got, ref, rtol, what):
    """Every leaf of `ref` in `got`, within rtol of the leaf's largest entry
    (complex leaves on the true m rows)."""
    for path, b in ref.items():
        a, b = true_rows(got[path], b)
        assert a.shape == b.shape, (what, path, a.shape, b.shape)
        wide = lambda x: x if np.iscomplexobj(x) else np.asarray(x, np.float64)
        scale = float(np.abs(b).max(initial=0.0))
        np.testing.assert_allclose(wide(a), wide(b), rtol=0, atol=rtol * scale,
                                   err_msg=f"{what} {path}")


def check_isca_tpu(sharded_dir, references, name):
    got = read(sharded_dir, name)
    ref = references[name][0]
    assert set(got) == set(ref), set(got) ^ set(ref)
    close(got, ref, SEASONAL_RTOL.get(name, RTOL), f"{name} against isca_tpu")


def check_single(sharded_dir, references, name):
    state, diag, means = references[name][1]
    got = read(sharded_dir, name)
    assert set(got) == set(state)
    for path, b in state.items():
        assert got[path].shape == b.shape and got[path].dtype == b.dtype, path
    close(got, state, RTOL, f"{name} against one device")
    if diag:
        close(read(sharded_dir, f"{name}_diag"), diag, RTOL, f"{name} diagnostics")
    if means:
        got = read(sharded_dir, f"{name}_means")
        assert set(got) == set(means)
        close(got, means, RTOL, f"{name} global means and extrema")


def check_m_blocks(sharded_dir, name):
    whole = next(v for k, v in read(sharded_dir, name).items()
                 if k in (".dyn.ts.curr", ".vors.curr"))
    blocks, starts = [], []
    for r in range(cases.NRANKS):
        with np.load(sharded_dir / f"{name}_rank{r}.npz") as d:
            block, m0 = d["block"], int(d["m_start"])
        rows = block.shape[-2]
        np.testing.assert_array_equal(block, whole[..., m0:m0 + rows, :])
        assert rows * cases.NRANKS == whole.shape[-2]
        blocks.append(block)
        starts.append(m0)
    assert starts == [r * rows for r in range(cases.NRANKS)]
    assert all(not np.array_equal(blocks[0], b) for b in blocks[1:])


# ---- the tests ------------------------------------------------------------------

@pytest.mark.parametrize("name", cases.GCM_FILES[WHICH])
def test_sharded_gcm_matches_isca_tpu_single_device(sharded, references, name):
    check_isca_tpu(sharded, references, name)


@pytest.mark.parametrize("name", cases.GCM_FILES[WHICH])
def test_sharded_gcm_matches_port_single_device(sharded, references, name):
    check_single(sharded, references, name)


@pytest.mark.parametrize("name", cases.GCM_FILES[WHICH])
def test_sharded_gcm_m_blocks_distinct(sharded, name):
    check_m_blocks(sharded, name)


def _mima_template(mesh):
    """This rank's template blocks of the MiMA state (initial_state sharded
    from one device with the mesh's m padding)."""
    cfg = cases.gcm_config("mima")
    cfg = dataclasses.replace(cfg, core=dataclasses.replace(cfg.core, pad_m_to=cases.NRANKS))
    from isca_tpu_torch.models.moist import GreyMoistModel

    model = GreyMoistModel(cfg, device="cpu")
    return shard_pytree(mesh, model.initial_state(), nlat=model.core.T.nlat), model


def test_mima_tile_restart_both_ways(sharded, tmp_path):
    """The ranks read their MiMA tiles back bit for bit themselves. Here:
    isca_tpu's combine of the port's 4 tiles is the gathered state; a tile
    set isca_tpu writes of that state on its 8 devices (its MiMA model on
    its mesh gives the structure) loads into each of the port's ranks'
    blocks bit for bit, RadCache's host int32 age too."""
    whole = read(sharded, "mima")
    assert len(list((sharded / "mima_tiles").glob("tile*.npz"))) == cases.NRANKS
    assert {".rad_cache.age", ".rad_cache.tdt_rad", ".tke", ".bucket_depth.curr"} <= set(whole)
    assert float(np.abs(whole[".rad_cache.tdt_rad"]).max()) > 0.0
    combined = tmp_path / "combined.npz"
    jdio.combine_restart_tiles(str(sharded / "mima_tiles"), str(combined))
    got = read(tmp_path, "combined")
    assert list(got) == list(whole)
    for path, b in whole.items():
        np.testing.assert_array_equal(got[path], b, err_msg=path)

    jm = jmesh.make_mesh(JAX_DEVICES)
    jcfg = to_jax(cases.gcm_config("mima"))
    jmodel = jmoist.GreyMoistModel(dataclasses.replace(
        jcfg, core=dataclasses.replace(jcfg.core, mesh=jm)))
    nlat = jmodel.core.T.nlat
    flat, treedef = jax.tree_util.tree_flatten_with_path(jmodel.initial_state())
    jstate = jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(whole[jax.tree_util.keystr(p)]) for p, _ in flat])
    jtiles = tmp_path / "jax_tiles"
    jdio.save_restart_sharded(str(jtiles), jmesh.shard_pytree(jm, jstate, nlat=nlat))

    cfg = cases.gcm_config("mima")
    from isca_tpu_torch.models.moist import GreyMoistModel
    model = GreyMoistModel(dataclasses.replace(
        cfg, core=dataclasses.replace(cfg.core, pad_m_to=cases.NRANKS)), device="cpu")
    template = model.initial_state()
    whole_t = unflatten(template, [torch.as_tensor(whole[p]) for p, _ in
                                   flatten_with_paths(template)])
    for r in range(cases.NRANKS):
        mesh = Mesh(group=None, rank=r, size=cases.NRANKS, backend="gloo",
                    device=torch.device("cpu"))
        like = shard_pytree(mesh, template, nlat=nlat)
        want = shard_pytree(mesh, whole_t, nlat=nlat)
        loaded = dio.load_restart_sharded(str(jtiles), like, mesh)
        for (path, a), (_, b) in zip(flatten_with_paths(loaded), flatten_with_paths(want)):
            assert a.dtype == b.dtype and a.device == b.device, path
            assert torch.equal(a, b), path
