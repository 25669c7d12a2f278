"""Nested containers of tensors: the trees that the optimizer, the trainer
and the checkpoint manager walk (the role ``jax.tree`` plays in the JAX
package).

A tree is a dict, a list, a tuple or a namedtuple of trees, or a leaf
(anything else).  Dicts are walked in sorted key order, as ``jax.tree``
walks them, so two trees of one structure give their leaves in the same
order.  A leaf's path is the tuple of keys from the root: a ``str`` for a
dict key or a namedtuple field, an ``int`` for a list or tuple index.
"""
from __future__ import annotations

from typing import Any, Callable, List, Sequence, Tuple

import numpy as np
import torch

Path = Tuple[Any, ...]


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree) -> List[Tuple[Any, Any]]:
    """(key, child) pairs of a container, or None for a leaf."""
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return list(zip(tree._fields, tree))
    if isinstance(tree, (list, tuple)):
        return list(enumerate(tree))
    return None


def flatten(tree) -> Tuple[List[Path], List[Any]]:
    """(paths, leaves) of ``tree``, in the order :func:`leaves` gives."""
    paths: List[Path] = []
    out: List[Any] = []

    def walk(node, path):
        kids = _children(node)
        if kids is None:
            paths.append(path)
            out.append(node)
            return
        for k, child in kids:
            walk(child, path + (k,))

    walk(tree, ())
    return paths, out


def leaves(tree) -> List[Any]:
    return flatten(tree)[1]


def unflatten(paths: Sequence[Sequence[Any]], values: Sequence[Any]):
    """Rebuild a tree from the paths :func:`flatten` gave: a ``str`` key
    makes a dict, an ``int`` key a list (namedtuples and tuples therefore
    come back as dicts and lists)."""
    if len(paths) == 1 and len(paths[0]) == 0:
        return values[0]
    root: Any = None

    def container(key):
        return {} if isinstance(key, str) else []

    for path, value in zip(paths, values):
        path = list(path)
        if root is None:
            root = container(path[0])
        node = root
        for key, nxt in zip(path[:-1], path[1:]):
            if isinstance(node, list):
                while len(node) <= key:
                    node.append(None)
                if node[key] is None:
                    node[key] = container(nxt)
                node = node[key]
            else:
                node = node.setdefault(key, container(nxt))
        last = path[-1]
        if isinstance(node, list):
            while len(node) <= last:
                node.append(None)
        node[last] = value
    return root


def tree_map(fn: Callable, tree, *rest):
    """``fn`` applied leaf by leaf to trees of one structure; the result
    has ``tree``'s containers (namedtuples and tuples kept)."""
    kids = _children(tree)
    if kids is None:
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    mapped = [tree_map(fn, child, *(r[i] for r in rest))
              for i, (_, child) in enumerate(kids)]
    if _is_namedtuple(tree):
        return type(tree)(*mapped)
    return type(tree)(mapped)


def keystr(path: Path) -> str:
    """A leaf's path as ``jax.tree_util.keystr`` renders it: ``['key']``
    for a dict key or field, ``[i]`` for a list or tuple index."""
    return "".join(f"[{k!r}]" for k in path)


def tree_map_with_path(fn: Callable, tree, path: Path = ()):
    """``fn(path, leaf)`` leaf by leaf; the result has ``tree``'s
    containers, as :func:`tree_map` keeps them."""
    kids = _children(tree)
    if kids is None:
        return fn(path, tree)
    mapped = [tree_map_with_path(fn, child, path + (k,)) for k, child in kids]
    if isinstance(tree, dict):
        return dict(zip((k for k, _ in kids), mapped))
    if _is_namedtuple(tree):
        return type(tree)(*mapped)
    return type(tree)(mapped)


def tensor_from_numpy(x, device) -> torch.Tensor:
    """A copy of the array ``x`` as a tensor on ``device``, value for
    value: an ml_dtypes bfloat16 array (which torch cannot take) goes
    through f32, which holds every bf16 value exactly."""
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def from_numpy(tree, device):
    """``tree`` (e.g. ``jax.tree.map(np.asarray, params)``) with every
    leaf as a tensor on ``device`` (:func:`tensor_from_numpy`)."""
    return tree_map(lambda x: tensor_from_numpy(x, device), tree)
