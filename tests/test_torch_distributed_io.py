"""isca_tpu_torch's sharded restart and diagnostic IO (io/distributed.py)
against isca_tpu's, mirroring tests/test_distributed_io.py and
tests/test_multiprocess_io.py.

isca_tpu first writes the tile set of a Held-Suarez state (T21L8, float64,
3 steps) on the conftest's 8 virtual devices. Then one `spawn` of 4 gloo
ranks on the CPU (tests/torch_sharded_cases.py run_io) runs the same model
sharded, writes its tiles, reads them back (and from a finer tile set of 8
files), loads isca_tpu's tile set into its own blocks, writes diagnostic
tiles, and on a 2-rank subgroup runs tests/mp_io_worker.py's round trip.
The ranks check their round trips bit for bit themselves; this process
checks every rank's blocks again (loading with a Mesh built by hand: a
load takes no collective), the combines, and the interchange with
isca_tpu both ways.
"""

import glob
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_sharded_cases as cases
from isca_tpu.dycore.primitive import PrimitiveConfig as JPC
from isca_tpu.io import distributed as jdio
from isca_tpu.io import restart as jsingle
from isca_tpu.models.dry import HeldSuarezConfig as JHSC
from isca_tpu.models.dry import HeldSuarezModel as JHSM
from isca_tpu.parallel import mesh as jmesh
from isca_tpu_torch.io import distributed as dio
from isca_tpu_torch.io import restart as single
from isca_tpu_torch.parallel.mesh import Mesh, shard_pytree, spawn
from isca_tpu_torch.utils.tree import flatten_with_paths, unflatten


def read_restart(path):
    with np.load(path, allow_pickle=False) as data:
        paths = json.loads(str(data["_paths"]))
        return paths, [data[f"leaf_{i}"] for i in range(len(paths))]


@pytest.fixture(scope="module")
def io_run(tmp_path_factory):
    """isca_tpu's tile set, then the ranks' run; the output directory."""
    out = tmp_path_factory.mktemp("tiles")
    mesh = jmesh.make_mesh(8)
    model = JHSM(JHSC(core=JPC(dtype=jnp.float64, mesh=mesh, **cases.IO_CORE)))
    nlat = model.core.T.nlat
    state = jax.jit(lambda s: model.run(s, cases.IO_STEPS))(model.initial_state())
    state = jmesh.shard_pytree(mesh, state, nlat=nlat)
    jdio.save_restart_sharded(str(out / "jax_tiles"), state)
    jsingle.save_restart(str(out / "jax_state.npz"), state)
    spawn(cases.run_io, cases.NRANKS, "gloo", str(out / "init"), args=(str(out),),
          threads=1)
    return out


def rank_blocks(out, tile_dir):
    """Every rank's blocks loaded from a tile set, and from the gathered
    state, with a Mesh made by hand for each rank."""
    model = cases.io_model(device="cpu")
    like_whole = model.initial_state()
    paths, leaves = read_restart(out / "io_state.npz")
    whole = unflatten(like_whole, [torch.as_tensor(a) for a in leaves])
    nlat = model.core.T.nlat
    for r in range(cases.NRANKS):
        mesh = Mesh(group=None, rank=r, size=cases.NRANKS, backend="gloo",
                    device=torch.device("cpu"))
        like = shard_pytree(mesh, cases.io_model(device="cpu").initial_state(), nlat=nlat)
        yield (dio.load_restart_sharded(str(out / tile_dir), like, mesh),
               shard_pytree(mesh, whole, nlat=nlat))


@pytest.mark.parametrize("tile_dir,files", [("tiles", 4), ("tiles_split", 8)])
def test_roundtrip_bit_exact(io_run, tile_dir, files):
    """Each rank's blocks read back bit for bit, from the tile set the 4
    ranks wrote and from a finer one of 8 files (each block cut in two)."""
    assert len(glob.glob(str(io_run / tile_dir / "tile*.npz"))) == files
    for loaded, want in rank_blocks(io_run, tile_dir):
        for (path, a), (_, b) in zip(flatten_with_paths(loaded), flatten_with_paths(want)):
            assert a.dtype == b.dtype, path
            assert torch.equal(a, b), path


def test_each_tile_holds_only_its_rank_blocks(io_run):
    seen = []
    for r in range(cases.NRANKS):
        with np.load(io_run / "tiles" / f"tile{r:04d}.npz") as tile:
            index = json.loads(str(tile["_index"]))
        entry = next(e for e in index if e["path"] == ".tg.curr")
        assert entry["shape"] == [8, 32, 64] and len(entry["shards"]) == 1
        seen.append(entry["shards"][0]["slices"])
    assert seen == [[[0, None], [8 * r, 8 * (r + 1)], [0, None]] for r in range(4)]


def test_combine_matches_single_file(io_run, tmp_path):
    """combine_restart_tiles == the gathered state saved as one file
    (mppnccombine parity)."""
    combined = tmp_path / "combined.npz"
    dio.combine_restart_tiles(str(io_run / "tiles"), str(combined))
    ref_paths, ref = read_restart(io_run / "io_state.npz")
    got_paths, got = read_restart(combined)
    assert got_paths == ref_paths
    for p, a, b in zip(ref_paths, got, ref):
        assert a.dtype == b.dtype, p
        np.testing.assert_array_equal(a, b, err_msg=p)


def test_isca_tpu_combines_port_tiles(io_run, tmp_path):
    """isca_tpu's combine_restart_tiles on the port's 4-rank tile set gives
    the port's single-file restart of the same state."""
    combined = tmp_path / "combined_by_isca_tpu.npz"
    jdio.combine_restart_tiles(str(io_run / "tiles"), str(combined))
    ref_paths, ref = read_restart(io_run / "io_state.npz")
    got_paths, got = read_restart(combined)
    assert got_paths == ref_paths
    for p, a, b in zip(ref_paths, got, ref):
        np.testing.assert_array_equal(a, b, err_msg=p)


def test_port_loads_isca_tpu_tiles(io_run):
    """isca_tpu's tile set of its 8-device mesh (one file, 8 blocks per
    sharded leaf) loads into the port's 4 ranks bit-equal."""
    ref_paths, ref = read_restart(io_run / "jax_state.npz")
    got_paths, got = read_restart(io_run / "io_from_jax.npz")
    assert got_paths == ref_paths
    for p, a, b in zip(ref_paths, got, ref):
        assert a.dtype == b.dtype, p
        np.testing.assert_array_equal(a, b, err_msg=p)


def test_diag_tiles_combine(io_run):
    fields = dio.combine_diag_tiles(str(io_run / "diag"), 0)
    paths, leaves = read_restart(io_run / "io_state.npz")
    state = dict(zip(paths, leaves))
    np.testing.assert_array_equal(fields["temp"], state[".tg.curr"])
    np.testing.assert_array_equal(fields["ps"], state[".psg.curr"])
    np.testing.assert_array_equal(fields["pk"], cases.io_model(device="cpu").core.pk.numpy())
    # isca_tpu's combine reads the port's diagnostic tiles alike
    jfields = jdio.combine_diag_tiles(str(io_run / "diag"), 0)
    for k in fields:
        np.testing.assert_array_equal(jfields[k], fields[k])


def test_two_rank_restart_and_diag_roundtrip(io_run):
    """tests/mp_io_worker.py's checks on a 2-rank mesh (each rank's tile
    holds only its rows, the reload is bit-exact, a global sum matches, the
    combine and the diagnostic tiles give the host values)."""
    assert (io_run / "two_rank_ok").exists()
    assert sorted(p.name for p in (io_run / "two_rank_tiles").glob("tile*.npz")) == [
        "tile0000.npz", "tile0001.npz"]
