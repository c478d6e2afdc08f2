"""Walks over nested containers of tensors: dicts, lists, tuples,
namedtuples (such as ``PCAState``) and dataclasses, the structures the
JAX package treats as pytrees."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator, Tuple

import torch

__all__ = ["tree_leaves_with_path", "tree_map"]


def tree_leaves_with_path(tree: Any, path: str = "") -> Iterator[Tuple[str, Any]]:
    """(key, leaf) for every leaf of a nested structure, in
    ``jax.tree_util.tree_leaves_with_path`` order and with
    ``jax.tree_util.keystr``'s keys: a dict's entries by sorted key as
    ``['key']``, list and tuple items as ``[i]``, a namedtuple's fields as
    ``.name``, a dataclass's fields as ``[<flat index i>]`` (a registered
    node's, such as ``PCAState``). ``None`` holds no leaf."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from tree_leaves_with_path(tree[key], f"{path}[{key!r}]")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name, value in zip(tree._fields, tree):
            yield from tree_leaves_with_path(value, f"{path}.{name}")
    elif isinstance(tree, (list, tuple)):
        for i, value in enumerate(tree):
            yield from tree_leaves_with_path(value, f"{path}[{i}]")
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for i, field in enumerate(dataclasses.fields(tree)):
            yield from tree_leaves_with_path(getattr(tree, field.name), f"{path}[<flat index {i}>]")
    else:
        yield path, tree


def tree_map(fn: Callable, tree: Any) -> Any:
    """``fn`` applied to every tensor of a nested dict / list / tuple
    (namedtuples kept), the structure kept and other leaves as they are."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {key: tree_map(fn, value) for key, value in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, value) for value in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, value) for value in tree)
    return tree
