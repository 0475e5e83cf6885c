"""Checkpoint / restart: a full model state to a single compressed file.

Port of isca_tpu/io/restart.py (reference: per-PE netCDF restarts +
mppnccombine + tar.gz archiving, atmosphere.res.nc / spectral_dynamics.res.nc
etc., experiment.py:304-359). The complete state, BOTH leapfrog time levels
as the reference requires for bitwise continuation, is one host-side .npz
in isca_tpu's format: `_paths`, the JSON list of key paths
(utils/tree.py), and `leaf_{i}` for each leaf in that order, each in its own
dtype (complex leaves as complex). A restart written by either package loads
in the other, so a run spun up with isca_tpu continues here.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from isca_tpu_torch.utils.tree import flatten_with_paths, unflatten


def _to_host(v) -> np.ndarray:
    return v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


def _like(arr: np.ndarray, tmpl: torch.Tensor) -> torch.Tensor:
    """arr as a tensor of the template leaf's dtype on its device."""
    return torch.as_tensor(arr).to(device=tmpl.device, dtype=tmpl.dtype)


def save_restart(path: str, state) -> None:
    flat = flatten_with_paths(state)
    arrays = {f"leaf_{i}": _to_host(leaf) for i, (_, leaf) in enumerate(flat)}
    np.savez_compressed(path, _paths=json.dumps([p for p, _ in flat]), **arrays)


def load_restart(path: str, like):
    """Load into the structure of `like` (a template state), each leaf cast
    to the template leaf's dtype and placed on its device."""
    flat = flatten_with_paths(like)
    paths_like = [p for p, _ in flat]
    with np.load(path, allow_pickle=False) as data:
        paths_saved = json.loads(str(data["_paths"]))
        if paths_saved != paths_like:
            raise ValueError(
                "restart structure mismatch:\n saved: %s\n model: %s"
                % (paths_saved[:5], paths_like[:5])
            )
        leaves = []
        for i, (_, tmpl) in enumerate(flat):
            arr = data[f"leaf_{i}"]
            if tuple(arr.shape) != tuple(tmpl.shape):
                raise ValueError(
                    f"restart resolution mismatch for leaf {paths_like[i]}: "
                    f"{arr.shape} vs {tuple(tmpl.shape)}"
                )
            leaves.append(_like(arr, tmpl))
    return unflatten(like, leaves)


def change_resolution(state_old, T_old, T_new, state_new_template):
    """Map a restart state to a new horizontal resolution.

    The reference ships scripts/change_horizontal_resolution_of_restart_file
    to re-run a case at a different truncation from an existing restart.
    Here: complex spectral fields are zero-padded / truncated in (m, n)
    (exact); real grid fields are bilinearly regridded; shape-preserved
    leaves (scalars, level-profile arrays) pass through. Each leaf takes the
    dtype and device of its template leaf.

    Vertical level counts must match between the two templates.
    """
    from isca_tpu_torch.utils.input_files import regrid_bilinear

    lats_o = np.degrees(_to_host(T_old.lats))
    lons_o = np.degrees(_to_host(T_old.lons))
    lats_n = np.degrees(_to_host(T_new.lats))
    lons_n = np.degrees(_to_host(T_new.lons))
    go = (len(lats_o), len(lons_o))
    gn = (len(lats_n), len(lons_n))

    def regrid_stack(a, lat_axis):
        """Regrid with the (lat, lon) pair starting at `lat_axis`."""
        a = np.moveaxis(a, (lat_axis, lat_axis + 1), (-2, -1))
        lead = a.shape[:-2]
        out = np.stack([
            regrid_bilinear(lats_o, lons_o, f, lats_n, lons_n)
            for f in a.reshape((-1,) + a.shape[-2:])
        ])
        out = out.reshape(lead + gn)
        return np.moveaxis(out, (-2, -1), (lat_axis, lat_axis + 1))

    leaves = []
    for (path, old), (_, new) in zip(flatten_with_paths(state_old),
                                     flatten_with_paths(state_new_template)):
        a = _to_host(old)
        tgt_shape = tuple(new.shape)
        if a.shape == tgt_shape:
            leaves.append(_like(a, new))
            continue
        if np.iscomplexobj(a):
            # spectral (..., m, n): pad/truncate exactly
            out = np.zeros(tgt_shape, a.dtype)
            m = min(a.shape[-2], tgt_shape[-2])
            n = min(a.shape[-1], tgt_shape[-1])
            out[..., :m, :n] = a[..., :m, :n]
            leaves.append(_like(out, new))
            continue
        # find the (lat, lon) axis pair
        lat_axis = None
        for ax in range(a.ndim - 1):
            if (a.shape[ax], a.shape[ax + 1]) == go and \
               (tgt_shape[ax], tgt_shape[ax + 1]) == gn:
                lat_axis = ax
                break
        if lat_axis is None:
            raise ValueError(f"cannot convert leaf {path}: {a.shape} -> {tgt_shape}")
        leaves.append(_like(regrid_stack(a, lat_axis), new))
    return unflatten(state_new_template, leaves)
