"""Checkpoint / resume of progressive renders and optimisation loops (port
of ``terra_tpu/checkpoint.py``).

A render's state is its film (acc and per-pixel samples), the seed and a
JSON ``meta`` string, in one ``.npz`` written to a temporary name and
renamed into place. A tree of tensors (nested dicts, tuples, lists and
NamedTuples; ``None`` holds no leaf) is saved as one ``leaf_{i}`` entry per
leaf, in the order ``jax.tree_util.tree_flatten`` gives the same structure:
dict keys sorted, sequence and NamedTuple items in order. A file written by
either package therefore loads in the other, given ``like``.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .film import Film

__all__ = ["save_render_state", "load_render_state", "save_pytree", "load_pytree",
           "tree_leaves", "tree_unflatten", "tree_map"]


def _savez_atomic(path: str, **arrays):
    """``np.savez_compressed`` to ``path + ".tmp"``, renamed onto ``path``."""
    tmp = path + ".tmp"
    np.savez_compressed(tmp, **arrays)
    os.replace(tmp if tmp.endswith(".npz") else tmp + ".npz", path)


def save_render_state(path: str, film: Film, seed: int, meta: Optional[Dict[str, Any]] = None):
    """Persist (acc, samples, seed, meta), atomically by rename."""
    _savez_atomic(path, acc=film.acc.detach().cpu().numpy(),
                  samples=film.samples.detach().cpu().numpy(), seed=np.int64(seed),
                  meta=json.dumps(meta or {}))


def load_render_state(path: str, device="cuda") -> Tuple[Film, int, Dict[str, Any]]:
    """(film on ``device``, seed, meta) of a file of :func:`save_render_state`."""
    with np.load(path, allow_pickle=False) as z:
        film = Film(acc=torch.as_tensor(z["acc"], device=device),
                    samples=torch.as_tensor(z["samples"], device=device))
        return film, int(z["seed"]), json.loads(str(z["meta"]))


def _children(tree):
    """The subtrees of a container node in leaf order, or None for a leaf."""
    if isinstance(tree, dict):
        return [tree[k] for k in sorted(tree)]
    if isinstance(tree, (tuple, list)):
        return list(tree)
    return None


def tree_leaves(tree) -> list:
    """Leaves of ``tree`` in ``jax.tree_util`` order (None holds none)."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [tree]
    return [leaf for kid in kids for leaf in tree_leaves(kid)]


def tree_unflatten(like, leaves):
    """A tree of ``like``'s structure holding ``leaves`` in leaf order."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            done = {k: build(node[k]) for k in sorted(node)}
            return {k: done[k] for k in node}
        if isinstance(node, (tuple, list)):
            items = [build(x) for x in node]
            if hasattr(node, "_fields"):  # NamedTuple
                return type(node)(*items)
            return type(node)(items)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return out


def tree_map(fn, tree):
    """``fn`` applied to every leaf of ``tree``, in its structure."""
    return tree_unflatten(tree, [fn(x) for x in tree_leaves(tree)])


def _structure(tree) -> str:
    """A readable description of the tree's structure (leaves as ``*``)."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_structure(tree[k])}" for k in sorted(tree)) + "}"
    if isinstance(tree, (tuple, list)):
        inner = ", ".join(_structure(x) for x in tree)
        return f"{type(tree).__name__}({inner})"
    return "*"


def save_pytree(path: str, tree):
    """Flat ``.npz`` of a tree of tensors or arrays (scene parameters,
    optimiser state), atomically by rename."""
    leaves = [x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
              for x in tree_leaves(tree)]
    _savez_atomic(path, treedef=_structure(tree),
                  **{f"leaf_{i}": leaf for i, leaf in enumerate(leaves)})


def load_pytree(path: str, like):
    """Restore a tree saved by :func:`save_pytree` (by this package or
    ``terra_tpu``) into the structure of ``like``; a tensor leaf of
    ``like`` gives the device of the loaded one, any other leaf loads as a
    NumPy array."""
    like_leaves = tree_leaves(like)
    with np.load(path, allow_pickle=False) as z:
        leaves = [torch.as_tensor(z[f"leaf_{i}"], device=ref.device)
                  if isinstance(ref, torch.Tensor) else z[f"leaf_{i}"]
                  for i, ref in enumerate(like_leaves)]
    return tree_unflatten(like, leaves)
