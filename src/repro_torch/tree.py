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

# The walks below recurse through module-level functions. A nested function
# that calls itself is a reference cycle (function -> closure cell ->
# function), which would keep every leaf it saw, a training step's states
# and grads among them, alive until the cyclic garbage collector runs.


def _children(node) -> List[Tuple[str, Any]]:
    if isinstance(node, dict):
        return [(f"[{k!r}]", node[k]) for k in sorted(node)]
    return [(f"[{i}]", c) for i, c in enumerate(node)]


def _is_container(node) -> bool:
    return isinstance(node, (dict, list, tuple))


def _walk_paths(node, path: str, out: List[Tuple[str, Any]]) -> None:
    if node is None:
        return
    if _is_container(node):
        for k, c in _children(node):
            _walk_paths(c, path + k, out)
    else:
        out.append((path, node))


def flatten_with_path(tree) -> List[Tuple[str, Any]]:
    """[(keystr path, leaf)] in JAX flatten order (path spelled like
    `jax.tree_util.keystr`, e.g. "['layers']['attn']['bk']")."""
    out: List[Tuple[str, Any]] = []
    _walk_paths(tree, "", out)
    return out


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in flatten_with_path(tree)]


def tree_map(fn: Callable[..., Any], tree, *rest):
    """Apply `fn` to every leaf, keeping the container structure. With
    further trees of the same structure, `fn` gets the matching leaf of
    each as its further arguments."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *[r[k] for r in rest])
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, c, *[r[i] for r in rest])
                          for i, c in enumerate(tree))
    return fn(tree, *rest)


def _rebuild(node, fn: Callable[[Any], Any]):
    """`node`'s structure with each leaf replaced by fn(leaf), in flatten
    order."""
    if node is None:
        return None
    if isinstance(node, dict):
        new = dict(node)
        for k in sorted(node):
            new[k] = _rebuild(node[k], fn)
        return new
    if _is_container(node):
        return type(node)(_rebuild(c, fn) for c in node)
    return fn(node)


def unflatten_like(template, new_leaves):
    """A tree of `template`'s structure whose leaves, in flatten order, are
    `new_leaves` (the counterpart of `jax.tree_util.tree_unflatten`)."""
    new_leaves = list(new_leaves)
    used = [0]

    def take(_):
        used[0] += 1
        return new_leaves[used[0] - 1] if used[0] <= len(new_leaves) \
            else None

    out = _rebuild(template, take)
    if used[0] != len(new_leaves):
        raise ValueError(f"{len(new_leaves)} leaves for a template of "
                         f"{used[0]}")
    return out


def replace_leaf(tree, leaf_idx: int, new_leaf):
    """Copy of `tree` with leaf `leaf_idx` (flatten order) replaced. Only
    the containers on the leaf's path are copied; every other leaf is the
    same object as before."""
    counter = [0]

    def pick(leaf):
        counter[0] += 1
        return new_leaf if counter[0] - 1 == leaf_idx else leaf

    out = _rebuild(tree, pick)
    if leaf_idx >= counter[0]:
        raise IndexError(f"leaf_idx {leaf_idx} out of range "
                         f"({counter[0]} leaves)")
    return out
