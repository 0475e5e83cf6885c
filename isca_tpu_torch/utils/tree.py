"""Key paths over a model state, spelled as isca_tpu's.

isca_tpu's restarts and checksums key every leaf of a state pytree by
`jax.tree_util.keystr` of its path. The port's states are plain dataclasses,
`TwoLevel` NamedTuples, dicts and tensors, and this module walks them in
JAX's order with JAX's spelling, so a restart or a checksum table written by
either package names the same leaves:

* a dataclass field or a NamedTuple field is `.name`, in field order (the
  port's dataclasses list their fields in the order of isca_tpu's
  `data_fields`);
* a dict entry is `['key']` (the key's repr), in sorted key order;
* a list or tuple entry is `[i]`;
* None holds no leaf; anything else is a leaf.

For example `.vors.prev`, `.tracers['sphum'].curr`, `.wg_full`.
"""

from __future__ import annotations

import dataclasses


def _children(x):
    """(key, child) pairs of a container, or None when x is a leaf."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return [(f".{f.name}", getattr(x, f.name)) for f in dataclasses.fields(x)]
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return [(f".{n}", getattr(x, n)) for n in x._fields]
    if isinstance(x, (tuple, list)):
        return [(f"[{i}]", c) for i, c in enumerate(x)]
    if isinstance(x, dict):
        return [(f"[{k!r}]", x[k]) for k in sorted(x)]
    return None


def _rebuild(x, children: list):
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(
            x, **{f.name: c for f, c in zip(dataclasses.fields(x), children)})
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*children)
    if isinstance(x, (tuple, list)):
        return type(x)(children)
    return dict(zip(sorted(x), children))


def flatten_with_paths(tree, prefix: str = "") -> list[tuple[str, object]]:
    """Every leaf of `tree` with its key path, in isca_tpu's order."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for key, child in kids:
        out += flatten_with_paths(child, prefix + key)
    return out


def unflatten(like, leaves):
    """A tree of the structure of `like` holding `leaves` in path order."""
    it = iter(leaves)

    def build(x):
        if x is None:
            return None
        kids = _children(x)
        if kids is None:
            return next(it)
        return _rebuild(x, [build(c) for _, c in kids])

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out
