"""The sharded run of isca_tpu_torch: parallel/mesh.py, the sharded
transforms and the sharded Held-Suarez, barotropic and Frierson models,
against isca_tpu's sharded runs and the port's own single-device runs.

One `spawn` of 4 gloo ranks on the CPU (one torch thread each) runs every
case of tests/torch_sharded_cases.py and writes the results; meanwhile this
process runs isca_tpu's sharded counterparts on the conftest's 8 virtual
devices. The cases mirror tests/test_parallel.py:

* Held-Suarez at T21L8, 6 steps, and at T42L25, 2 steps (in place of
  isca_tpu's T85 case), float64, through PrimitiveConfig(mesh=...);
* the barotropic model (resolution 31), 12 steps, and the stirred one, 4
  steps (every rank draws the whole field and keeps its m rows);
* Frierson at T21L8 with its grid `sphum` tracer and the water fixer, 6
  steps (the tracer's halo rows cross the ranks' bands);
* the transforms: T21's 22 m rows padded to 24, overlap_chunks=3 bit-equal
  to 1 with 3 all_to_all calls per transform (counted by wrapping
  dist.all_to_all_single in the ranks), rhomboidal and fourier_inc=2 on the
  mesh, and no gather-like collective inside a transform;
* spectral_diagnostics and two initial_conditions states on the mesh.

Each case is held against isca_tpu's sharded run on the true m rows at
isca_tpu's own tolerances (tests/test_parallel.py: tg 1e-10, psg 1e-8,
vorg 1e-13, sphum 1e-12; its T85 and moist cases 1e-9, 1e-7 and ug 1e-8)
and against the port's single-device run with the same m padding, every
leaf: bit for bit where a step takes no global mean (the transforms, the
barotropic model, the initial states built on the whole globe), and at
rtol 1e-9 of the leaf's largest entry (the port's single-device tolerance
against isca_tpu, tests/test_torch_dry.py) where the fixers take means: the
all_reduce sums the bands in another order than one device does, and 6
steps amplify that to ~5e-11 of a leaf's largest entry. The spectral
state's m blocks are distinct on the 4 ranks. The ranks import no JAX.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_sharded_cases as cases
from isca_tpu.dycore import initial_conditions as jic
from isca_tpu.dycore.primitive import PrimitiveConfig as JPC
from isca_tpu.dycore.primitive import PrimitiveCore as JCore
from isca_tpu.models.barotropic import BarotropicConfig as JBC
from isca_tpu.models.barotropic import BarotropicModel as JBM
from isca_tpu.models.dry import HeldSuarezConfig as JHSC
from isca_tpu.models.dry import HeldSuarezModel as JHSM
from isca_tpu.models.moist import GreyMoistConfig as JGC
from isca_tpu.models.moist import GreyMoistModel as JGM
from isca_tpu.parallel import mesh as jmesh
from isca_tpu.spectral import transforms as jtr
from isca_tpu_torch.dycore import initial_conditions as tic
from isca_tpu_torch.dycore.primitive import PrimitiveCore as TCore
from isca_tpu_torch.models.barotropic import BarotropicModel as TBM
from isca_tpu_torch.models.dry import HeldSuarezConfig as THSC
from isca_tpu_torch.models.dry import HeldSuarezModel as THSM
from isca_tpu_torch.models.moist import GreyMoistConfig as TGC
from isca_tpu_torch.models.moist import GreyMoistModel as TGM
from isca_tpu_torch.parallel.mesh import spawn
from isca_tpu_torch.spectral import transforms as ttr
from isca_tpu_torch.utils.tree import flatten_with_paths

JAX_DEVICES = 8
# isca_tpu's own tolerances (tests/test_parallel.py), by leaf
JAX_TOL = {
    "hs": {".tg.curr": 1e-10, ".psg.curr": 1e-8},
    "hs_t42": {".tg.curr": 1e-9, ".psg.curr": 1e-7, ".ug.curr": 1e-8},
    "barotropic": {".vorg.curr": 1e-13},
    "barotropic_stirred": {".vorg.curr": 1e-13},
    "frierson": {".dyn.tg.curr": 1e-9, ".dyn.psg.curr": 1e-7,
                 ".dyn.tracers['sphum'].curr": 1e-12, ".t_surf": 1e-9},
}
# sharded against single-device, per case: 0 = bit for bit
SINGLE_RTOL = {"hs": 1e-9, "hs_t42": 1e-9, "frierson": 1e-9}
MODEL_CASES = tuple(JAX_TOL)
SPEC_STATE = {"hs": ".ts.curr", "hs_t42": ".ts.curr", "barotropic": ".vors.curr",
              "barotropic_stirred": ".vors.curr", "frierson": ".dyn.ts.curr"}


def leaves_np(tree):
    """{key path: numpy array} of a port or isca_tpu state."""
    if isinstance(tree, dict) and all(isinstance(k, str) and k[:1] in ".[" for k in tree):
        return tree
    out = {}
    for path, leaf in flatten_with_paths(tree):
        out[path] = leaf.detach().cpu().numpy() if torch.is_tensor(leaf) else np.asarray(leaf)
    return out


def jax_leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def read(outdir, name):
    with np.load(outdir / f"{name}.npz", allow_pickle=False) as data:
        paths = json.loads(str(data["_paths"]))
        return {p: data[f"leaf_{i}"] for i, p in enumerate(paths)}


def true_rows(a, b):
    """Complex (..., m, n) arrays cut to their common m rows (the padding
    differs: 4 ranks against 8 devices); other arrays as they are."""
    if np.iscomplexobj(a) and a.ndim >= 2 and a.shape[-2] != b.shape[-2]:
        m = min(a.shape[-2], b.shape[-2])
        return a[..., :m, :], b[..., :m, :]
    return a, b


# ---- isca_tpu's sharded runs (this process, 8 virtual devices) -----------

def _jax_run(model, state, steps, mesh, nlat=None):
    s_sh = jmesh.shard_pytree(mesh, state, nlat=nlat)
    out = jax.jit(lambda s: model.run(s, steps),
                  out_shardings=jmesh.sharding_pytree(mesh, s_sh, nlat=nlat))(s_sh)
    return jax_leaves(out)


def jax_transform_results(T, inputs):
    def f(g, u, v):
        s = jtr.grid_to_spec(T, g)
        vor, div = jtr.vor_div_from_uv_grid(T, u, v)
        uu, vv = jtr.uv_grid_from_vor_div(T, vor, div)
        return {"spec": s, "grid": jtr.spec_to_grid(T, s), "vor": vor, "div": div,
                "u": uu, "v": vv}
    res = jax.jit(f)(*(jnp.asarray(x.numpy()) for x in inputs))
    return {f"['{k}']": np.asarray(v) for k, v in res.items()}


def jax_references():
    mesh = jmesh.make_mesh(JAX_DEVICES)
    ref = {}
    for name, (res, levels, steps) in cases.HS_CASES.items():
        core = JPC(resolution=res, num_levels=levels, dt=600.0, dtype=jnp.float64,
                   mesh=mesh)
        model = JHSM(JHSC(core=core))
        ref[name] = _jax_run(model, model.initial_state(), steps, mesh, model.core.T.nlat)
    for name, (stirred, steps) in cases.BARO_CASES.items():
        model = JBM(JBC(dtype=jnp.float64, **cases.barotropic_kwargs(stirred)))
        ref[name] = _jax_run(model, model.initial_state(), steps, mesh)
    core = JPC(resolution="T21", num_levels=8, dt=720.0, dtype=jnp.float64,
               do_water_correction=True, robert_coeff=0.03, mesh=mesh)
    model = JGM(JGC(core=core))
    ref["frierson"] = _jax_run(model, model.initial_state(), cases.FRIERSON_STEPS, mesh,
                               model.core.T.nlat)
    for name, kw in {"padded": {}, **cases.EXOTIC}.items():
        T = jtr.make_transforms(21 if kw else "T21", dtype=jnp.float64, mesh=mesh, **kw)
        ref[f"tr_{name}"] = jax_transform_results(T, cases.transform_inputs(T, 5))
    T = jtr.make_transforms("T42", dtype=jnp.float64, mesh=mesh)
    g = jnp.asarray(cases.transform_inputs(T, 7)[0].numpy())
    s = jax.jit(lambda x: jtr.grid_to_spec(T, x))(g)
    ref["tr_chunks1"] = {"['spec']": np.asarray(s),
                         "['grid']": np.asarray(jax.jit(lambda x: jtr.spec_to_grid(T, x))(s))}
    jcore = JCore(JPC(resolution="T21", num_levels=8, dt=600.0, dtype=jnp.float64,
                      mesh=mesh))
    for name, build in (("jablonowski", jic.apply_jablonowski_2006),
                        ("polvani_2004", jic.apply_polvani_2004)):
        state, surf = build(jcore)
        ref[name] = {**{"['state']" + k: v for k, v in jax_leaves(state).items()},
                     "['surf']": np.asarray(surf)}
    return ref


# ---- the port's single-device runs (this process) -------------------------

def padded(core):
    """A case's core on one device with the mesh's m padding."""
    return dataclasses.replace(core, pad_m_to=cases.NRANKS)


def single_hs(name):
    res, levels, steps = cases.HS_CASES[name]
    model = THSM(THSC(core=padded(cases.hs_core(res, levels))), device="cpu")
    return model, model.run(model.initial_state(), steps)


def single_run(name):
    """The port's single-device result of a case, m padded as on the mesh."""
    pad = cases.NRANKS
    if name in cases.HS_CASES:
        return leaves_np(single_hs(name)[1])
    if name in cases.BARO_CASES:
        stirred, steps = cases.BARO_CASES[name]
        model = TBM(cases.barotropic_config(stirred), device="cpu")   # 32 m rows divide
        return leaves_np(model.run(model.initial_state(), steps))
    if name == "frierson":
        model = TGM(TGC(core=padded(cases.frierson_core())), device="cpu")
        return leaves_np(model.run(model.initial_state(), cases.FRIERSON_STEPS))
    if name in ("jablonowski", "polvani_2004"):
        core = TCore(padded(cases.hs_core("T21", 8)), device="cpu")
        build = getattr(tic, {"jablonowski": "apply_jablonowski_2006",
                              "polvani_2004": "apply_polvani_2004"}[name])
        state, surf = build(core)
        return leaves_np({"state": state, "surf": surf})
    kind = name[len("tr_"):]
    if kind.startswith("chunks"):
        T = ttr.make_transforms("T42", dtype=torch.float64, device="cpu", pad_m_to=pad)
        g = cases.transform_inputs(T, 7)[0]
        s = ttr.grid_to_spec(T, g)
        return leaves_np({"spec": s, "grid": ttr.spec_to_grid(T, s)})
    kw = cases.EXOTIC.get(kind, {})
    T = ttr.make_transforms(21 if kw else "T21", dtype=torch.float64, device="cpu",
                            pad_m_to=pad, **kw)
    return leaves_np(cases.transform_results(T, *cases.transform_inputs(T, 5)))


# ---- fixtures ---------------------------------------------------------------

@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The 4 ranks, started first so that they run beside isca_tpu's runs."""
    out = tmp_path_factory.mktemp("sharded")
    ctx = spawn(cases.run, cases.NRANKS, "gloo", str(out / "init"), args=(str(out),),
                threads=1, join=False)
    yield ctx, out
    for p in ctx.processes:
        if p.is_alive():
            p.terminate()


@pytest.fixture(scope="module")
def jax_ref():
    return jax_references()


@pytest.fixture(scope="module")
def sharded(ranks, jax_ref):
    """The ranks' output directory, once every rank has ended."""
    ctx, out = ranks
    while not ctx.join():
        pass
    return out


# ---- the tests ----------------------------------------------------------------

@pytest.mark.parametrize("name", MODEL_CASES)
def test_sharded_model_matches_isca_tpu_sharded(sharded, jax_ref, name):
    got, ref = read(sharded, name), jax_ref[name]
    for path, atol in JAX_TOL[name].items():
        a, b = true_rows(got[path], ref[path])
        np.testing.assert_allclose(a, b, rtol=0, atol=atol, err_msg=f"{name} {path}")


@pytest.mark.parametrize("name", MODEL_CASES + ("jablonowski", "polvani_2004"))
def test_sharded_run_matches_single_device(sharded, name):
    got, ref = read(sharded, name), single_run(name)
    assert set(got) == set(ref)
    for path, b in ref.items():
        a = got[path]
        assert a.shape == b.shape and a.dtype == b.dtype, path
        rtol = SINGLE_RTOL.get(name, 0.0)
        if rtol == 0.0 or np.issubdtype(b.dtype, np.integer):
            np.testing.assert_array_equal(a, b, err_msg=f"{name} {path}")
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=rtol * float(np.abs(b).max()),
                                       err_msg=f"{name} {path}")


@pytest.mark.parametrize("name", ("jablonowski", "polvani_2004"))
def test_initial_conditions_on_mesh_match_isca_tpu(sharded, jax_ref, name):
    """Built on the whole globe and sharded: equal to isca_tpu's (its core
    on the 8-device mesh) at rtol 1e-12 of each leaf's largest entry. A
    zonal jet has no divergence and no meridional wind: those leaves are
    rounding noise, held to the scale of their partner of the same units,
    as tests/test_torch_tracers.py holds the single-device states."""
    partner = {".divs.": ".vors.", ".divg.": ".vorg.", ".vg.": ".ug."}
    got, ref = read(sharded, name), jax_ref[name]
    for path, b in ref.items():
        other = next((path.replace(x, y) for x, y in partner.items() if x in path), path)
        a, b = true_rows(got[path], b)
        scale = max(float(np.abs(b).max()), float(np.abs(ref[other]).max()))
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12 * scale,
                                   err_msg=f"{name} {path}")


@pytest.mark.parametrize("name", MODEL_CASES)
def test_spectral_m_blocks_distinct_per_rank(sharded, name):
    whole = read(sharded, name)[SPEC_STATE[name]]
    starts, blocks = [], []
    for r in range(cases.NRANKS):
        with np.load(sharded / f"{name}_rank{r}.npz") as d:
            block, m0 = d["block"], int(d["m_start"])
        rows = block.shape[-2]
        assert rows * cases.NRANKS == whole.shape[-2]
        np.testing.assert_array_equal(block, whole[..., m0:m0 + rows, :])
        starts.append(m0)
        blocks.append(block)
    assert starts == [r * rows for r in range(cases.NRANKS)]
    assert all(not np.array_equal(blocks[0], b) for b in blocks[1:])


@pytest.mark.parametrize("name", ("padded", "rhomboidal", "fourier_inc"))
def test_sharded_transforms(sharded, jax_ref, name):
    """Against isca_tpu's sharded transforms (true m rows) at 1e-12 and the
    port's single-device ones with the same padding bit for bit; padded
    rows stay exact zeros."""
    got = read(sharded, f"tr_{name}")
    single = single_run(f"tr_{name}")
    for path, ref in jax_ref[f"tr_{name}"].items():
        a, b = true_rows(got[path], ref)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12, err_msg=f"{name} {path}")
        np.testing.assert_array_equal(got[path], single[path], err_msg=f"{name} {path}")
    if name == "padded":
        T0 = ttr.make_transforms("T21", dtype=torch.float64, device="cpu")
        m1 = T0.num_fourier + 1
        assert got["['spec']"].shape[-2] == 24 and m1 == 22
        for k in ("['spec']", "['vor']", "['div']"):
            assert float(np.abs(got[k][..., m1:, :]).max()) == 0.0
        # the unpadded single-device transforms on the true rows
        g, u, v = cases.transform_inputs(T0, 5)
        plain = leaves_np(cases.transform_results(T0, g, u, v))
        for path, b in plain.items():
            a, b = true_rows(got[path], b)
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-12, err_msg=path)


def test_overlap_chunks_pipeline(sharded, jax_ref):
    """overlap_chunks=3 is bit-identical to 1, with three all_to_all calls
    per transform (one with 1), and matches isca_tpu's sharded transform."""
    one, three = read(sharded, "tr_chunks1"), read(sharded, "tr_chunks3")
    for k in one:
        np.testing.assert_array_equal(one[k], three[k], err_msg=k)
    calls = json.loads((sharded / "calls.json").read_text())
    for direction in ("g2s", "s2g"):
        assert len(calls[f"{direction}_1"]["all_to_all_single"]) == 1
        assert len(calls[f"{direction}_3"]["all_to_all_single"]) == 3
    single = single_run("tr_chunks1")
    for k, ref in jax_ref["tr_chunks1"].items():
        a, b = true_rows(one[k], ref)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12, err_msg=k)
        np.testing.assert_array_equal(one[k], single[k], err_msg=k)


def test_transform_repartition_is_all_to_all(sharded):
    """The grid <-> spectral re-partition is all_to_all only: no gather-like
    collective and no reduction inside a transform, and each all_to_all
    moves one rank's share (its elements stay below a grid-sized gather)."""
    calls = json.loads((sharded / "calls.json").read_text())
    T = ttr.make_transforms("T42", dtype=torch.float64, device="cpu")
    grid_batch = 7 * T.nlat * T.nlon
    for key, by_name in calls.items():
        for name, sizes in by_name.items():
            if name != "all_to_all_single":
                assert sizes == [], f"{key}: {name} called in a transform"
        assert by_name["all_to_all_single"]
        assert max(by_name["all_to_all_single"]) < grid_batch


def test_sharded_spectral_diagnostics(sharded):
    """EKE (an m = 0 mask on the rank holding m = 0, then a global mean),
    vort_norm (a global max), slp and height on the mesh, against the
    single-device diagnostics of the single-device end state at the HS
    case's rtol."""
    got = read(sharded, "hs_diag")
    model, state = single_hs("hs")
    diag = model.core.spectral_diagnostics(state)
    for k in ("['EKE']", "['vort_norm']", "['slp']", "['height']"):
        b = diag[k[2:-2]].numpy()
        np.testing.assert_allclose(got[k], b, rtol=0,
                                   atol=SINGLE_RTOL["hs"] * float(np.abs(b).max()), err_msg=k)


def test_mesh_errors(sharded):
    """make_mesh(8) on 4 ranks raises ValueError (never a silent
    truncation); a non-Mesh raises TypeError; nlat that does not split over
    the ranks raises isca_tpu's ValueError."""
    errors = json.loads((sharded / "errors.json").read_text())
    assert "n_devices=8" in errors["make_mesh_too_many"]
    assert "Mesh" in errors["not_a_mesh"]
    assert "nlat=30 % 4 == 0" in errors["nlat_does_not_divide"]


@pytest.mark.parametrize("case", ["hs", "frierson", "mima"])
def test_sharding_pytree_describes_shard_pytree(case):
    """sharding_pytree's axis and blocks (from the whole state) are where
    shard_pytree cuts each rank's block, and local_sharding reads the same
    layout back from the block alone (what gather_pytree and the tiles
    use); spectral leaves shard on m, grid leaves on latitude, the 0-d and
    1-d leaves are replicated. MiMA at T21L8 on 4 ranks has the ambiguous
    shapes: a band of 8 rows and 8 levels, so a rank's level-first (8, 8,
    64) block and its level-last RadCache (8, 64, 8) and TKE (8, 64, 9)
    blocks each carry an axis of the band's extent besides the latitude
    axis; RadCache's age is a 0-d host leaf. Meshes built by hand: nothing
    here reaches a collective."""
    from isca_tpu_torch.parallel.mesh import (Mesh, local_sharding, shard_pytree,
                                              sharding_pytree)

    if case == "mima":
        cfg = cases.gcm_config("mima")
        model = TGM(dataclasses.replace(cfg, core=padded(cfg.core)), device="cpu")
    else:
        core = padded(cases.hs_core("T21", 8) if case == "hs" else cases.frierson_core())
        model = (THSM(THSC(core=core), device="cpu") if case == "hs"
                 else TGM(TGC(core=core), device="cpu"))
    whole = model.initial_state()
    nlat = model.core.T.nlat
    flat = flatten_with_paths(whole)
    for r in range(cases.NRANKS):
        mesh = Mesh(group=None, rank=r, size=cases.NRANKS, backend="gloo",
                    device=torch.device("cpu"))
        layout = dict(flatten_with_paths(sharding_pytree(mesh, whole, nlat=nlat)))
        blocks = dict(flatten_with_paths(shard_pytree(mesh, whole, nlat=nlat)))
        for path, leaf in flat:
            sh = layout[path]
            assert sh.shape == tuple(leaf.shape), path
            if leaf.ndim < 2:
                assert sh.axis is None and blocks[path] is leaf, path
                continue
            # level-first (..., lat, lon) on axis -2; level-last (lat, lon, L) on 0
            level_last = not leaf.is_complex() and leaf.shape[-2] != nlat
            assert sh.axis == (0 if level_last else leaf.ndim - 2), path
            start, stop = sh.blocks[r]
            assert torch.equal(blocks[path], leaf.narrow(sh.axis, start, stop - start))
            assert local_sharding(mesh, blocks[path], nlat) == sh, path


def test_unsharded_models_raise_on_a_mesh():
    """Every model runs on a mesh now (tests/test_torch_parallel_gcm.py and
    its two sibling files hold them against isca_tpu), so what raises is a
    wrong mesh: a non-Mesh raises TypeError for each model that takes one; a
    sharded T passed to band_limit_topography raises ValueError (band-limit
    on mesh-less transforms, then set_land the whole field); a column model
    with fewer rows than ranks, or rows that do not split, raises
    ValueError; set_land on a mesh takes only the whole globe's fields. The
    meshes are built by hand: nothing here reaches a collective."""
    from isca_tpu_torch.models.column import ColumnConfig, ColumnModel
    from isca_tpu_torch.models.giant import giant_planet_model
    from isca_tpu_torch.models.moist import (mima_test_case_config,
                                             socrates_aquaplanet_test_case_config)
    from isca_tpu_torch.models.shallow import ShallowModel
    from isca_tpu_torch.parallel.mesh import Mesh
    from isca_tpu_torch.utils.topography import band_limit_topography

    not_a_mesh = object()
    for cfg in (mima_test_case_config(resolution="T21", num_levels=8),
                socrates_aquaplanet_test_case_config(True, resolution="T21", num_levels=8)):
        cfg = dataclasses.replace(cfg, core=dataclasses.replace(cfg.core, mesh=not_a_mesh))
        with pytest.raises(TypeError, match="Mesh"):
            TGM(cfg, device="cpu")
    with pytest.raises(TypeError, match="Mesh"):
        giant_planet_model(resolution="T21", num_levels=8, device="cpu", mesh=not_a_mesh)
    with pytest.raises(TypeError, match="Mesh"):
        ShallowModel(device="cpu", mesh=not_a_mesh)
    with pytest.raises(TypeError, match="Mesh"):
        ColumnModel(device="cpu", mesh=not_a_mesh)

    mesh = Mesh(group=None, rank=0, size=4, backend="gloo", device=torch.device("cpu"))
    Tm = ttr.make_transforms("T21", dtype=torch.float64, mesh=mesh)
    with pytest.raises(ValueError, match="whole globe"):
        band_limit_topography(Tm, np.zeros((Tm.nlat, Tm.nlon)))
    for nlat in (2, 6):
        with pytest.raises(ValueError, match=f"nlat={nlat}"):
            ColumnModel(ColumnConfig(nlat=nlat, nlon=3), mesh=mesh)
    model = TGM(TGC(core=dataclasses.replace(cases.frierson_core(), mesh=mesh)), device="cpu")
    with pytest.raises(ValueError, match="whole globe"):
        model.set_land(np.zeros(model.core.T.grid_shape))


def test_spectral_package_exports_match_isca_tpu():
    import isca_tpu.spectral as jspec
    import isca_tpu_torch.spectral as tspec

    # the package's submodules are not exports (the port's has a third,
    # precision, which holds the transform precision modes)
    names = lambda mod: sorted(k for k in vars(mod) if not k.startswith("_")
                               and k not in ("transforms", "gauss", "precision"))
    assert names(tspec) == names(jspec) and len(names(tspec)) == 17
    from isca_tpu_torch.spectral import area_weighted_mean  # noqa: F401
