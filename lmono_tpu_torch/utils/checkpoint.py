"""Checkpoint / resume of trees of tensors as one .npz.

Port of `lmono_tpu/utils/checkpoint.py` for the port's state trees: nested
`NamedTuple`s (`Pose` among them), dicts, tuples and lists whose leaves are
tensors or Python scalars.  Unlike the reference, which names
leaves by position (`leaf_0`, `leaf_1`, ...), every leaf is stored under
its tree path (`front/est/window/ex_q`, `graph/t`), so an added field
shifts nothing, and a mismatch raises `CheckpointMismatch` with the list of
paths rather than a message for callers to parse.  Arrays go to the host
on save and come back to the template's device and dtype on load.
"""

from __future__ import annotations

from typing import Any, Iterator, Optional

import numpy as np
import torch

EXTRA = "__extra__/"    # prefix of the variable-length extras


class CheckpointMismatch(ValueError):
    """The checkpoint does not fit the template.  `paths` lists every
    mismatched leaf as (path, saved shape, template shape); a shape is None
    where the leaf is missing on that side."""

    def __init__(self, paths: list[tuple[str, Optional[tuple], Optional[tuple]]]):
        self.paths = paths
        super().__init__("checkpoint mismatch: " + "; ".join(
            f"{p}: saved {s} != template {t}" for p, s, t in paths))


def _children(node) -> Optional[Iterator[tuple[str, Any]]]:
    """(key, child) pairs of an inner node, None for a leaf."""
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return zip(node._fields, node)
    if isinstance(node, dict):
        return ((str(k), v) for k, v in node.items())
    if isinstance(node, (tuple, list)):
        return ((str(i), v) for i, v in enumerate(node))
    return None


def tree_leaves(tree: Any, prefix: str = "") -> dict:
    """{path: leaf} in tree order; None subtrees hold no leaves."""
    out = {}
    kids = _children(tree)
    if kids is None:
        if tree is not None:
            out[prefix] = tree
        return out
    for k, v in kids:
        out.update(tree_leaves(v, f"{prefix}/{k}" if prefix else k))
    return out


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _restore(arr: np.ndarray, like):
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(np.array(arr)).to(device=like.device,
                                                  dtype=like.dtype)
    return type(like)(arr.item())


def _rebuild(node, leaves: dict, prefix: str = ""):
    kids = _children(node)
    if kids is None:
        return node if node is None else leaves[prefix]
    vals = [(k, _rebuild(v, leaves, f"{prefix}/{k}" if prefix else k))
            for k, v in kids]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*[v for _, v in vals])
    if isinstance(node, dict):
        return {k0: v for k0, (_, v) in zip(node, vals)}
    return type(node)(v for _, v in vals)


def save_state(path: str, state: Any, extra: Optional[dict] = None) -> int:
    """Serialize a tree to npz, each leaf under its tree path.  Returns the
    number of leaves.  `extra` holds variable-length arrays (histories whose
    leading axis grows with the run) restored with `load_extras`; they
    bypass the template's shape check."""
    arrays = {p: _host(v) for p, v in tree_leaves(state).items()}
    for k, v in (extra or {}).items():
        arrays[EXTRA + k] = _host(v)
    np.savez_compressed(path, **arrays)
    return len(arrays) - len(extra or {})


def load_state(path: str, template: Any) -> Any:
    """Restore a tree saved by `save_state`; `template` gives the structure,
    devices, dtypes and shapes.  Raises `CheckpointMismatch` listing every
    leaf whose shape differs, every template leaf the file lacks and every
    saved leaf the template lacks."""
    want = tree_leaves(template)
    with np.load(path) as data:
        saved = {k: data[k] for k in data.files if not k.startswith(EXTRA)}
    bad = []
    for p, leaf in want.items():
        shape = tuple(np.shape(leaf))
        if p not in saved:
            bad.append((p, None, shape))
        elif saved[p].shape != shape:
            bad.append((p, saved[p].shape, shape))
    bad += [(p, a.shape, None) for p, a in saved.items() if p not in want]
    if bad:
        raise CheckpointMismatch(bad)
    return _rebuild(template, {p: _restore(saved[p], leaf)
                               for p, leaf in want.items()})


def load_extras(path: str) -> dict:
    """The `extra` arrays saved with a checkpoint."""
    with np.load(path) as data:
        return {k[len(EXTRA):]: data[k] for k in data.files
                if k.startswith(EXTRA)}
