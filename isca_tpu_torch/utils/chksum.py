"""Deterministic checksums for model state (mpp_chksum equivalent).

Port of isca_tpu/utils/chksum.py: the same digest of the same bytes, so a
checksum here equals isca_tpu's for the same array, and `tree_chksum` keys
its table by the same paths (utils/tree.py).

The reference uses `mpp_chksum` (src/shared/mpp/mpp.F90, used e.g. in the
transform debug blocks transforms.F90:433-439, 523-530) as its bitwise
reproducibility probe: a layout-independent integer digest of a distributed
field that must match across PE counts and across commits (the trip-test
contract, exp/test_cases/trip_test).

Here the digest is the unsigned 64-bit sum of the little-endian byte view of
the array, which is independent of sharding, device order, and summation
order (integer addition is associative/commutative) - the same property that
makes mpp_chksum layout-independent. A tensor is read on the host
(`.detach().cpu().numpy()`).
"""

from __future__ import annotations

import json

import numpy as np
import torch

from isca_tpu_torch.utils.tree import flatten_with_paths


def chksum(x) -> int:
    """Layout-independent uint64 digest of one array (mpp_chksum analogue)."""
    # contiguous first: a tensor may be a strided view (JAX arrays never are)
    a = np.ascontiguousarray(x.detach().cpu().numpy() if torch.is_tensor(x) else x)
    if a.dtype == object:
        raise TypeError("chksum needs a numeric array")
    # complex -> view as its real pair; bool -> uint8
    if np.iscomplexobj(a):
        a = a.view(np.float64 if a.dtype == np.complex128 else np.float32)
    b = np.ascontiguousarray(a).view(np.uint8).astype(np.uint64)
    return int(b.sum() % np.uint64(2**64 - 1))


def tree_chksum(tree) -> dict[str, int]:
    """Digest every leaf of a pytree, keyed by its key-path string."""
    return {path: chksum(leaf) for path, leaf in flatten_with_paths(tree)}


def combined_chksum(tree) -> int:
    """Single digest over a whole pytree (order-stable by key path)."""
    total = np.uint64(0)
    for k, v in sorted(tree_chksum(tree).items()):
        total = (total + np.uint64(v)) % np.uint64(2**64 - 1)
    return int(total)


def save_golden(path: str, tree) -> None:
    """Write the per-leaf digests as the golden reference."""
    with open(path, "w") as f:
        json.dump(tree_chksum(tree), f, indent=1, sort_keys=True)


def check_golden(path: str, tree) -> list[str]:
    """Compare a pytree against a saved golden; returns mismatched paths."""
    with open(path) as f:
        golden = json.load(f)
    now = tree_chksum(tree)
    bad = [k for k in golden if now.get(k) != golden[k]]
    bad += [k for k in now if k not in golden]
    return bad
