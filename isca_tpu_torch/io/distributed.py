"""Sharded restart and diagnostics IO: one tile file per rank.

Port of isca_tpu/io/distributed.py (reference: per-PE netCDF filesets and
their offline combine, `src/shared/mpp/mpp_io.F90` fileset_write and
`postprocessing/mppnccombine.c`, run per segment by experiment.py:304-327).
On a mesh (isca_tpu_torch.parallel.mesh) every rank holds only its blocks:

* `save_restart_sharded(dir, state, mesh)`: every rank writes one
  `tile{rank:04d}.npz` of its blocks and an `_index` in isca_tpu's layout
  (per leaf: its key path, global shape, dtype, and for each block its key
  and global [start, stop) per axis, stop null for a whole axis). No rank
  gathers the global state. Both leapfrog time levels ride along.
* `load_restart_sharded(dir, like, mesh)`: `like` is this rank's template
  blocks (a model's initial_state() on the mesh); each rank reads only the
  blocks that overlap its own, from a tile set of any layout whose blocks
  cover it (isca_tpu's one-file tile of 8 devices, say). Bit-exact.
* `combine_restart_tiles(dir, out_path)`: merges a tile set into the
  single-file layout of io/restart.py (the mppnccombine equivalent), float32
  blocks cut along axis 0 through the native combiner.
* `DiagTileWriter` / `combine_diag_tiles`: per-rank diagnostic tiles and
  their merge into global fields.

Tile sets interchange both ways with isca_tpu's. Which axis of a rank's
leaf is its block is read from the leaf's shape by shard_pytree's rules
(parallel.mesh.local_axis; `nlat` is the latitude hint, as for
shard_pytree).
"""

from __future__ import annotations

import glob
import json
import os

import numpy as np
import torch

from isca_tpu_torch.io import restart as single
from isca_tpu_torch.parallel.mesh import Mesh, local_sharding
from isca_tpu_torch.utils.tree import flatten_with_paths, unflatten


def _block_slices(mesh: Mesh, leaf, nlat):
    """(global shape, this rank's [[start, stop], ...]; stop None = whole axis)."""
    sh = local_sharding(mesh, leaf, nlat)
    slices = [[0, None] for _ in sh.shape]
    if sh.axis is not None:
        slices[sh.axis] = list(sh.blocks[mesh.rank])
    return sh.shape, slices


def _host(leaf) -> np.ndarray:
    return single._to_host(leaf) if torch.is_tensor(leaf) else np.asarray(leaf)


def save_restart_sharded(dirpath: str, state, mesh: Mesh, nlat: int | None = None) -> str:
    """Write this rank's tile of a sharded state; returns its path."""
    os.makedirs(dirpath, exist_ok=True)
    arrays: dict[str, np.ndarray] = {}
    index: list[dict] = []
    for i, (path, leaf) in enumerate(flatten_with_paths(state)):
        arr = _host(leaf)
        if torch.is_tensor(leaf):
            shape, slices = _block_slices(mesh, leaf, nlat)
        else:
            shape, slices = arr.shape, [[0, None] for _ in arr.shape]
        key = f"leaf{i}_s{mesh.rank}"
        arrays[key] = arr
        index.append({"path": path, "shape": list(shape), "dtype": str(arr.dtype),
                      "shards": [{"key": key, "slices": slices}]})
    out = os.path.join(dirpath, f"tile{mesh.rank:04d}.npz")
    np.savez_compressed(out, _index=json.dumps(index), **arrays)
    return out


def _read_tiles(dirpath: str):
    tiles = []
    for path in sorted(glob.glob(os.path.join(dirpath, "tile*.npz"))):
        data = np.load(path, allow_pickle=False)
        tiles.append((json.loads(str(data["_index"])), data))
    if not tiles:
        raise FileNotFoundError(f"no tile*.npz files in {dirpath}")
    return tiles


def _bounds(slices, shape):
    return [(s, shape[d] if e is None else e) for d, (s, e) in enumerate(slices)]


def _extract(blocks, target, shape, what):
    """The sub-array covering `target` ([(start, stop)] per axis) from saved
    (bounds, lazily read array) blocks: one block that holds it whole, or
    the pieces of every block that overlaps it."""
    out = None
    for src, read in blocks:
        if all(ts >= ss and te <= se for (ts, te), (ss, se) in zip(target, src)):
            cut = tuple(slice(ts - ss, te - ss) for (ts, te), (ss, _) in zip(target, src))
            # ascontiguousarray alone would promote a 0-d scalar to (1,)
            return np.ascontiguousarray(read()[cut]).reshape([te - ts for ts, te in target])
        if all(ts < se and te > ss for (ts, te), (ss, se) in zip(target, src)):
            arr = read()
            if out is None:
                out = np.zeros([te - ts for ts, te in target], arr.dtype)
            inter = [(max(ts, ss), min(te, se)) for (ts, te), (ss, se) in zip(target, src)]
            dst = tuple(slice(a - ts, b - ts) for (a, b), (ts, _) in zip(inter, target))
            cut = tuple(slice(a - ss, b - ss) for (a, b), (ss, _) in zip(inter, src))
            out[dst] = arr[cut]
    if out is None:
        raise ValueError(f"no saved block covers {target} of {what}")
    return out


def load_restart_sharded(dirpath: str, like, mesh: Mesh):
    """This rank's blocks of a tile set, in the structure of `like` (its own
    template blocks), each leaf in the template's dtype on its device. A
    template leaf whose shape is the saved global shape is replicated;
    otherwise it is the rank's block of the one axis where the two differ."""
    tiles = _read_tiles(dirpath)
    flat = flatten_with_paths(like)
    paths_like = [p for p, _ in flat]
    paths_saved = [e["path"] for e in tiles[0][0]]
    if paths_like != paths_saved:
        raise ValueError("restart structure mismatch:\n saved: %s\n model: %s"
                         % (paths_saved[:4], paths_like[:4]))
    leaves = []
    for i, (path, tmpl) in enumerate(flat):
        shape = tuple(tiles[0][0][i]["shape"])
        local = tuple(tmpl.shape)
        diff = [d for d in range(len(shape)) if len(local) == len(shape)
                and local[d] != shape[d]]
        if len(local) != len(shape) or len(diff) > 1 or (
                diff and shape[diff[0]] != local[diff[0]] * mesh.size):
            raise ValueError(f"restart resolution mismatch for {path}: saved "
                             f"{shape}, this rank's block {local} on {mesh.size} ranks")
        target = [(0, n) for n in shape]
        if diff:
            b = local[diff[0]]
            target[diff[0]] = (mesh.rank * b, (mesh.rank + 1) * b)
        blocks = [(_bounds(s["slices"], shape),
                   lambda data=data, key=s["key"]: data[key])
                  for index, data in tiles for s in index[i]["shards"]]
        leaves.append(single._like(_extract(blocks, target, shape, path), tmpl))
    return unflatten(like, leaves)


def combine_restart_tiles(dirpath: str, out_path: str) -> None:
    """Merge a tile set into one single-file restart (io/restart.py's
    layout): the mppnccombine equivalent. float32 blocks cut along axis 0
    only go through the native combine_tiles; everything else through numpy."""
    from isca_tpu_torch import native

    tiles = _read_tiles(dirpath)
    index0 = tiles[0][0]
    arrays = {}
    for i, entry in enumerate(index0):
        shape = tuple(entry["shape"])
        blocks = [(s["slices"], data[s["key"]])
                  for index, data in tiles for s in index[i]["shards"]]
        first = blocks[0][1]
        axis0_only = all(all(s == 0 and (e is None or e == shape[d])
                             for d, (s, e) in enumerate(bsl) if d != 0)
                         for bsl, _ in blocks)
        if axis0_only and first.dtype == np.float32 and len(shape) >= 1:
            out = native.combine_tiles([b for _, b in blocks],
                                       [bsl[0][0] for bsl, _ in blocks], shape[0])
        else:
            out = np.zeros(shape, first.dtype)
            for bsl, b in blocks:
                out[tuple(slice(s, e) for s, e in _bounds(bsl, shape))] = b
        arrays[f"leaf_{i}"] = out
    np.savez_compressed(out_path, _paths=json.dumps([e["path"] for e in index0]),
                        **arrays)


# ---------------------------------------------------------------------------
# Diagnostic tiles (per-rank diagnostic output and its combine)
# ---------------------------------------------------------------------------

class DiagTileWriter:
    """Writes finalized diagnostic records as per-rank tile files: each rank
    passes its own blocks (and whole fields, such as pk, as they are);
    `combine_diag_tiles` makes the global fields for the single-file writer."""

    def __init__(self, dirpath: str, mesh: Mesh, nlat: int | None = None):
        self.dir = dirpath
        self.mesh = mesh
        self.nlat = nlat
        os.makedirs(dirpath, exist_ok=True)

    def write(self, record_id: int, fields: dict) -> str:
        """fields: name -> this rank's block (a tensor) or a whole field."""
        arrays, meta = {}, []
        for name, v in fields.items():
            arr = _host(v)
            shape, slices = ((arr.shape, None) if not torch.is_tensor(v)
                             else _block_slices(self.mesh, v, self.nlat))
            if slices is not None and all(e is None for _, e in slices):
                slices = None          # the rank holds the whole field
            key = f"{name}__full" if slices is None else f"{name}__s{self.mesh.rank}"
            arrays[key] = arr
            meta.append({"name": name, "key": key, "slices": slices,
                         "shape": list(shape)})
        path = os.path.join(self.dir,
                            f"rec{record_id:06d}.tile{self.mesh.rank:04d}.npz")
        np.savez_compressed(path, _meta=json.dumps(meta), **arrays)
        return path


def combine_diag_tiles(dirpath: str, record_id: int) -> dict:
    """Merge one record's tiles from every rank into global numpy fields."""
    paths = sorted(glob.glob(os.path.join(dirpath, f"rec{record_id:06d}.tile*.npz")))
    if not paths:
        raise FileNotFoundError(f"no tiles for record {record_id} in {dirpath}")
    fields: dict[str, np.ndarray] = {}
    for p in paths:
        data = np.load(p, allow_pickle=False)
        for m in json.loads(str(data["_meta"])):
            name, arr = m["name"], data[m["key"]]
            if m["slices"] is None:
                fields[name] = arr
                continue
            if name not in fields:
                fields[name] = np.zeros(m["shape"], arr.dtype)
            fields[name][tuple(slice(s, e) for s, e in
                               _bounds(m["slices"], m["shape"]))] = arr
    return fields
