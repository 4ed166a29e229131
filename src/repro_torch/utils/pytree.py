"""Tree utilities for the port's parameter and state containers.

Parameters are flat dicts `{dotted name: tensor}` ("stem.conv",
"stages.1.0.gn1.scale", "head.w"); optimizer states nest such dicts
(`{"mu": {...}, "count": tensor}`). `tree_map` walks dicts, lists and
tuples of tensors.

`leaf_order` reproduces the reference's jax leaf order on the dotted
names (dict keys sorted, list entries by index), so `tree_flatten_vector`
lays a header out exactly as `repro.utils.pytree.tree_flatten_vector`
does — that order is what the Eq. 7 cosine compares.

`tree_paths` names and orders the leaves of any tree (dicts, lists,
tuples, NamedTuples) as the reference's `repro.utils.pytree.tree_paths`
does: '/'-joined keys, dict keys sorted, list indices as digits,
NamedTuple fields by name. A tree both packages hold in the same layout
(the LLM families' parameters) gets the same paths in the same order.
"""
from __future__ import annotations

import torch


def tree_map(fn, tree, *rest):
    """Apply `fn` leaf-wise over matching dict/list/tuple structures; None
    is an empty tree, as in jax (a state without a peer store)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_paths(tree) -> list:
    """[(path, leaf)] in the reference's jax flatten order; None is an
    empty tree, as in jax."""
    out = []

    def walk(node, path):
        if node is None:
            return
        if isinstance(node, dict):
            items = [(str(k), node[k]) for k in sorted(node)]
        elif _is_namedtuple(node):
            items = [(f, getattr(node, f)) for f in node._fields]
        elif isinstance(node, (list, tuple)):
            items = [(str(i), v) for i, v in enumerate(node)]
        else:
            out.append(("/".join(path), node))
            return
        for k, v in items:
            walk(v, path + [k])

    walk(tree, [])
    return out


def tree_unflatten_paths(like, leaf_of):
    """A tree shaped as `like` whose leaf at each path is
    `leaf_of(path, leaf)` (`tree_paths`' paths); None stays None."""

    def walk(node, path):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: walk(v, path + [str(k)]) for k, v in node.items()}
        if _is_namedtuple(node):
            return type(node)(*(walk(getattr(node, f), path + [f])
                                for f in node._fields))
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, path + [str(i)])
                              for i, v in enumerate(node))
        return leaf_of("/".join(path), node)

    return walk(like, [])


def ordered_leaves(tree) -> list:
    """The tensors of a tree of dicts of dotted names in the reference's
    leaf order (nested dict keys sorted, numeric name parts by value),
    the order the reference's tree reductions sum in."""
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            name = f"{prefix}{k}"
            if isinstance(v, dict):
                walk(v, name + ".")
            else:
                flat[name] = v

    walk(tree, "")
    return [flat[n] for n in leaf_order(flat)]


def tree_leaves(tree) -> list:
    """The tensors of a dict/list/tuple tree, in container order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_size(tree) -> int:
    """Total number of scalar elements in a tree of tensors."""
    return sum(leaf.numel() for leaf in tree_leaves(tree))


def tree_bytes(tree) -> int:
    """Total bytes of a tree of tensors (numel × element size)."""
    return sum(leaf.numel() * leaf.element_size()
               for leaf in tree_leaves(tree))


def _path_key(name: str):
    return tuple(int(p) if p.isdigit() else p for p in name.split("."))


def leaf_order(names) -> list:
    """Dotted names in the reference's jax tree-flatten order."""
    return sorted(names, key=_path_key)


def tree_flatten_vector(tree: dict) -> torch.Tensor:
    """Flatten a dict of tensors into one 1-D float32 vector, in the
    reference's leaf order (`repro.utils.pytree.tree_flatten_vector`)."""
    return torch.cat([tree[n].reshape(-1).float()
                      for n in leaf_order(tree)])
