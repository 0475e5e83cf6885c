"""The sharded runs of tests/test_torch_parallel.py and
tests/test_torch_distributed_io.py, one function per rank.

`run(rank, outdir)` and `run_io(rank, outdir)` are what every rank of one
`spawn` of 4 gloo ranks on the CPU calls (isca_tpu_torch.parallel.mesh.spawn).
`run` runs each case on the mesh and writes, per case, the global result
gathered on rank 0 (`<case>.npz`, io/restart.py's layout) and each rank's
own block of the spectral state (`<case>_rank<r>.npz`), for the test
process to hold against isca_tpu and the port's single-device runs.
`run_io` writes, reads and combines tile sets. This module imports torch,
numpy and isca_tpu_torch only: the ranks never import JAX.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch
import torch.distributed as dist

from isca_tpu_torch.dycore.primitive import PrimitiveConfig
from isca_tpu_torch.io.restart import save_restart
from isca_tpu_torch.parallel.mesh import gather_pytree, make_mesh
from isca_tpu_torch.spectral import transforms as tr
from isca_tpu_torch.utils.tree import flatten_with_paths

NRANKS = 4
SEED = 11


# ---- the cases' configurations (the test process builds the same) -------

def hs_core(resolution, levels, mesh=None, dtype=torch.float64):
    return PrimitiveConfig(resolution=resolution, num_levels=levels, dt=600.0,
                           dtype=dtype, mesh=mesh)


def frierson_core(mesh=None):
    return PrimitiveConfig(resolution="T21", num_levels=8, dt=720.0, dtype=torch.float64,
                           do_water_correction=True, robert_coeff=0.03, mesh=mesh)


def barotropic_kwargs(stirred):
    """BarotropicConfig's fields of a barotropic case but its dtype (float64);
    the stirred one is the reference stirring test's configuration."""
    extra = (dict(initial_zonal_wind="zero", stirring_amplitude=3e-11, damping_order=2,
                  damping_coeff_r=1.929e-6) if stirred else {})
    return dict(resolution=31, dt=1200.0, **extra)


def barotropic_config(stirred):
    from isca_tpu_torch.models.barotropic import BarotropicConfig

    return BarotropicConfig(dtype=torch.float64, **barotropic_kwargs(stirred))


HS_CASES = {"hs": ("T21", 8, 6), "hs_t42": ("T42", 25, 2)}
BARO_CASES = {"barotropic": (False, 12), "barotropic_stirred": (True, 4)}
FRIERSON_STEPS = 6
EXOTIC = {"rhomboidal": dict(truncation_shape="rhomboidal"), "fourier_inc": dict(fourier_inc=2)}


def transform_inputs(T, batch):
    """Seeded random (g, u, v) on T's whole grid."""
    rng = np.random.default_rng(SEED)
    shape = (batch, T.nlat, T.nlon)
    return tuple(torch.as_tensor(rng.standard_normal(shape)) for _ in range(3))


def transform_results(T, g, u, v):
    """grid_to_spec, spec_to_grid, vor_div_from_uv_grid, uv_grid_from_vor_div."""
    s = tr.grid_to_spec(T, g)
    vor, div = tr.vor_div_from_uv_grid(T, u, v)
    uu, vv = tr.uv_grid_from_vor_div(T, vor, div)
    return {"spec": s, "grid": tr.spec_to_grid(T, s), "vor": vor, "div": div,
            "u": uu, "v": vv}


# ---- per-rank ------------------------------------------------------------

def _write(mesh, outdir, name, tree, nlat, T=None, block=None):
    whole = gather_pytree(mesh, tree, nlat)
    if mesh.rank == 0:
        save_restart(os.path.join(outdir, f"{name}.npz"), whole)
    if block is not None:
        np.savez(os.path.join(outdir, f"{name}_rank{mesh.rank}.npz"),
                 block=block.numpy(), m_start=T.m_start, lat_start=T.lat_start)


def _hs(mesh, outdir):
    from isca_tpu_torch.models.dry import HeldSuarezConfig, HeldSuarezModel

    for name, (res, levels, steps) in HS_CASES.items():
        model = HeldSuarezModel(HeldSuarezConfig(core=hs_core(res, levels, mesh)))
        T = model.core.T
        state = model.run(model.initial_state(), steps)
        _write(mesh, outdir, name, state, T.nlat, T, state.ts.curr)
        if name == "hs":
            diag = model.core.spectral_diagnostics(state)
            _write(mesh, outdir, "hs_diag", {k: diag[k] for k in
                                             ("EKE", "vort_norm", "slp", "height")}, T.nlat)


def _barotropic(mesh, outdir):
    from isca_tpu_torch.models.barotropic import BarotropicModel

    for name, (stirred, steps) in BARO_CASES.items():
        model = BarotropicModel(barotropic_config(stirred), mesh=mesh)
        state = model.run(model.initial_state(), steps)
        _write(mesh, outdir, name, state, model.T.nlat, model.T, state.vors.curr)


def _frierson(mesh, outdir):
    from isca_tpu_torch.models.moist import GreyMoistConfig, GreyMoistModel

    model = GreyMoistModel(GreyMoistConfig(core=frierson_core(mesh)))
    T = model.core.T
    state = model.run(model.initial_state(), FRIERSON_STEPS)
    _write(mesh, outdir, "frierson", state, T.nlat, T, state.dyn.ts.curr)


def _initial_conditions(mesh, outdir):
    from isca_tpu_torch.dycore import initial_conditions as ic
    from isca_tpu_torch.dycore.primitive import PrimitiveCore

    core = PrimitiveCore(hs_core("T21", 8, mesh))
    for name, build in (("jablonowski", ic.apply_jablonowski_2006),
                        ("polvani_2004", ic.apply_polvani_2004)):
        state, surf = build(core)
        _write(mesh, outdir, name, {"state": state, "surf": surf}, core.T.nlat)


def _count_calls(names):
    """Wrap torch.distributed's functions `names` so that each call appends
    the element count of its largest tensor argument to counts[name];
    returns (counts, the original functions)."""
    counts = {n: [] for n in names}
    originals = {n: getattr(dist, n) for n in names}

    def wrap(name):
        def wrapped(*args, **kwargs):
            tensors = [a for a in args if torch.is_tensor(a)]
            counts[name].append(max((t.numel() for t in tensors), default=0))
            return originals[name](*args, **kwargs)
        return wrapped

    for n in names:
        setattr(dist, n, wrap(n))
    return counts, originals


def _transforms(mesh, outdir):
    out = {}
    # padded (22 -> 24 m rows at T21) and the exotic truncations
    for name, kw in {"padded": {}, **EXOTIC}.items():
        Tm = tr.make_transforms(21 if kw else "T21", dtype=torch.float64, mesh=mesh, **kw)
        g, u, v = (Tm.local_lat(x, axis=1) for x in transform_inputs(Tm, 5))
        out[name] = transform_results(Tm, g, u, v)
    # overlap_chunks=3 against 1, and the collectives each transform calls
    gather_like = ("all_gather", "all_gather_into_tensor", "all_gather_object",
                   "broadcast", "gather", "scatter", "reduce_scatter_tensor", "all_reduce")
    counts, originals = _count_calls(("all_to_all_single",) + gather_like)
    calls = {}
    for k in (1, 3):
        Tm = tr.make_transforms("T42", dtype=torch.float64, mesh=mesh, overlap_chunks=k)
        g = Tm.local_lat(transform_inputs(Tm, 7)[0], axis=1)
        for c in counts.values():
            c.clear()
        s = tr.grid_to_spec(Tm, g)
        calls[f"g2s_{k}"] = {n: list(c) for n, c in counts.items()}
        for c in counts.values():
            c.clear()
        back = tr.spec_to_grid(Tm, s)
        calls[f"s2g_{k}"] = {n: list(c) for n, c in counts.items()}
        out[f"chunks{k}"] = {"spec": s, "grid": back}
    for n, f in originals.items():
        setattr(dist, n, f)
    for name, res in out.items():
        nlat = 64 if name.startswith("chunks") else 32
        _write(mesh, outdir, f"tr_{name}", res, nlat)
    if mesh.rank == 0:
        with open(os.path.join(outdir, "calls.json"), "w") as f:
            json.dump(calls, f)


def _mesh_errors(mesh, outdir):
    errors = {}
    try:
        make_mesh(2 * NRANKS, device="cpu")
    except ValueError as err:
        errors["make_mesh_too_many"] = str(err)
    try:
        tr.make_transforms("T21", mesh=object())
    except TypeError as err:
        errors["not_a_mesh"] = str(err)
    try:
        tr.make_transforms(21, nlat=30, nlon=64, mesh=mesh)
    except ValueError as err:
        errors["nlat_does_not_divide"] = str(err)
    if mesh.rank == 0:
        with open(os.path.join(outdir, "errors.json"), "w") as f:
            json.dump(errors, f)


def run(rank, outdir):
    """Every case on a mesh of NRANKS CPU ranks."""
    mesh = make_mesh(NRANKS, device="cpu")
    assert mesh.rank == rank and mesh.backend == "gloo"
    _mesh_errors(mesh, outdir)
    _transforms(mesh, outdir)
    _hs(mesh, outdir)
    _barotropic(mesh, outdir)
    _frierson(mesh, outdir)
    _initial_conditions(mesh, outdir)


# ---- tests/test_torch_distributed_io.py's ranks -------------------------------

IO_STEPS = 3
IO_CORE = dict(resolution="T21", num_levels=8, dt=1200.0)


def io_model(mesh=None, device=None):
    from isca_tpu_torch.models.dry import HeldSuarezConfig, HeldSuarezModel

    core = PrimitiveConfig(dtype=torch.float64, mesh=mesh, pad_m_to=NRANKS, **IO_CORE)
    return HeldSuarezModel(HeldSuarezConfig(core=core), device=device)


def split_tiles(src, dst, parts=2):
    """Re-write a tile set with every block cut into `parts` along its
    sharded axis (a finer layout, as many more ranks would write)."""
    os.makedirs(dst, exist_ok=True)
    for path in sorted(os.listdir(src)):
        if not path.startswith("tile"):
            continue
        data = np.load(os.path.join(src, path), allow_pickle=False)
        index = json.loads(str(data["_index"]))
        for k in range(parts):
            idx_k, arrays_k = [], {}
            for e in index:
                shards = []
                for s in e["shards"]:
                    arr, slices = data[s["key"]], [list(x) for x in s["slices"]]
                    axes = [d for d, (a, b) in enumerate(slices) if b is not None]
                    key = f"{s['key']}_p{k}"
                    if axes:
                        d = axes[0]
                        n = arr.shape[d] // parts
                        arr = np.take(arr, range(k * n, (k + 1) * n), axis=d)
                        slices[d] = [slices[d][0] + k * n, slices[d][0] + (k + 1) * n]
                    elif k:
                        continue          # a whole leaf goes in the first part
                    arrays_k[key] = arr
                    shards.append({"key": key, "slices": slices})
                idx_k.append({**e, "shards": shards})
            np.savez_compressed(os.path.join(dst, f"{path[:-4]}_{k}.npz"),
                                _index=json.dumps(idx_k), **arrays_k)


def _two_rank_roundtrip(outdir):
    """tests/mp_io_worker.py on a 2-rank mesh (a subgroup of the spawn): a
    restart-shaped tree sharded, written as tiles, read back, reduced,
    combined, and its diagnostic tiles merged."""
    from isca_tpu_torch.io import distributed as dio
    from isca_tpu_torch.parallel.mesh import shard_pytree

    group = dist.new_group([0, 1])
    if dist.get_rank() > 1:
        return
    mesh = make_mesh(2, group=group, device="cpu")
    rng = np.random.default_rng(7)
    L, nlat, nlon, M = 3, 8, 16, 48
    host = {
        "tg_prev": rng.standard_normal((L, nlat, nlon)),
        "tg_curr": rng.standard_normal((L, nlat, nlon)),
        "ts_curr": rng.standard_normal((L, M, 20)) + 1j * rng.standard_normal((L, M, 20)),
        "time_seconds": np.float64(86400.0),
    }
    state = shard_pytree(mesh, {k: torch.as_tensor(v) for k, v in host.items()}, nlat=nlat)
    assert state["tg_curr"].shape == (L, nlat // 2, nlon)
    assert state["ts_curr"].shape == (L, M // 2, 20)
    assert state["time_seconds"].shape == ()
    tiledir = os.path.join(outdir, "two_rank_tiles")
    dio.save_restart_sharded(tiledir, state, mesh, nlat=nlat)
    dist.barrier(group)
    rows = []
    for r in range(2):
        with np.load(os.path.join(tiledir, f"tile{r:04d}.npz")) as tile:
            index = json.loads(str(tile["_index"]))
        rows.append([s["slices"][1] for e in index if e["path"] == "['tg_curr']"
                     for s in e["shards"]])
    assert rows == [[[0, nlat // 2]], [[nlat // 2, nlat]]], rows
    loaded = dio.load_restart_sharded(tiledir, state, mesh)
    for k in host:
        assert torch.equal(loaded[k], state[k]), k
    total = mesh.all_reduce(loaded["tg_curr"].sum())
    np.testing.assert_allclose(float(total), host["tg_curr"].sum(), rtol=1e-12)
    dist.barrier(group)
    if mesh.rank == 0:
        out = os.path.join(outdir, "two_rank_combined.npz")
        dio.combine_restart_tiles(tiledir, out)
        with np.load(out) as data:
            for i, p in enumerate(json.loads(str(data["_paths"]))):
                np.testing.assert_array_equal(data[f"leaf_{i}"], host[p[2:-2]])
    w = dio.DiagTileWriter(os.path.join(outdir, "two_rank_diag"), mesh, nlat=nlat)
    w.write(0, {"temp": state["tg_curr"], "solar": state["time_seconds"]})
    dist.barrier(group)
    if mesh.rank == 0:
        fields = dio.combine_diag_tiles(os.path.join(outdir, "two_rank_diag"), 0)
        np.testing.assert_array_equal(fields["temp"], host["tg_curr"])
        assert float(fields["solar"]) == 86400.0
        open(os.path.join(outdir, "two_rank_ok"), "w").close()


def run_io(rank, outdir):
    """The tile IO of a sharded HS state on NRANKS CPU ranks, then the
    two-rank round trip. Expects isca_tpu's tile set in outdir/jax_tiles."""
    from isca_tpu_torch.io import distributed as dio

    mesh = make_mesh(NRANKS, device="cpu")
    model = io_model(mesh)
    nlat = model.core.T.nlat
    state = model.run(model.initial_state(), IO_STEPS)
    _write(mesh, outdir, "io_state", state, nlat)        # the gathered state
    tiles = os.path.join(outdir, "tiles")
    dio.save_restart_sharded(tiles, state, mesh, nlat=nlat)
    dist.barrier()
    # read back: from this tile set, and from a finer one
    if rank == 0:
        split_tiles(tiles, os.path.join(outdir, "tiles_split"))
    dist.barrier()
    template = model.initial_state()
    for name in ("tiles", "tiles_split"):
        loaded = dio.load_restart_sharded(os.path.join(outdir, name), template, mesh)
        for (path, a), (_, b) in zip(flatten_with_paths(state), flatten_with_paths(loaded)):
            assert a.dtype == b.dtype and torch.equal(a, b), (name, path)
    # isca_tpu's tile set of its 8-device mesh, into this mesh's blocks
    loaded = dio.load_restart_sharded(os.path.join(outdir, "jax_tiles"), template, mesh)
    _write(mesh, outdir, "io_from_jax", loaded, nlat)
    # diagnostic tiles: band-sharded fields and a whole one
    w = dio.DiagTileWriter(os.path.join(outdir, "diag"), mesh, nlat=nlat)
    w.write(0, {"temp": state.tg.curr, "ps": state.psg.curr, "pk": model.core.pk})
    _two_rank_roundtrip(outdir)
