"""Pytree helpers with the reference's leaf order.

`jax.tree.leaves` flattens dicts in SORTED-KEY order; `torch.utils._pytree`
uses insertion order. The packed whole-state fingerprint and an
`InjectionSpec.leaf_idx` both index leaves in flatten order, so the port
flattens exactly as JAX does: dicts by sorted key, lists/tuples in order,
`None` as an empty subtree, anything else (tensor, array, Python scalar) as
a leaf.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _children(node) -> List[Tuple[str, Any]]:
    if isinstance(node, dict):
        return [(f"[{k!r}]", node[k]) for k in sorted(node)]
    return [(f"[{i}]", c) for i, c in enumerate(node)]


def _is_container(node) -> bool:
    return isinstance(node, (dict, list, tuple))


def flatten_with_path(tree) -> List[Tuple[str, Any]]:
    """[(keystr path, leaf)] in JAX flatten order (path spelled like
    `jax.tree_util.keystr`, e.g. "['layers']['attn']['bk']")."""
    out: List[Tuple[str, Any]] = []

    def walk(node, path):
        if node is None:
            return
        if _is_container(node):
            for k, c in _children(node):
                walk(c, path + k)
        else:
            out.append((path, node))

    walk(tree, "")
    return out


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in flatten_with_path(tree)]


def tree_map(fn: Callable[[Any], Any], tree):
    """Apply `fn` to every leaf, keeping the container structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, c) for c in tree)
    return fn(tree)


def replace_leaf(tree, leaf_idx: int, new_leaf):
    """Copy of `tree` with leaf `leaf_idx` (flatten order) replaced. Only
    the containers on the leaf's path are copied; every other leaf is the
    same object as before."""
    counter = [0]

    def walk(node):
        if node is None:
            return None
        if _is_container(node):
            if isinstance(node, dict):
                new = dict(node)
                for k in sorted(node):
                    new[k] = walk(node[k])
                return new
            return type(node)(walk(c) for c in node)
        i = counter[0]
        counter[0] += 1
        return new_leaf if i == leaf_idx else node

    out = walk(tree)
    if leaf_idx >= counter[0]:
        raise IndexError(f"leaf_idx {leaf_idx} out of range "
                         f"({counter[0]} leaves)")
    return out
