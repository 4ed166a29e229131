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


def tree_map(fn, tree, *rest, is_leaf=None):
    """Apply `fn` leaf-wise over matching dict/list/tuple structures; None
    is an empty tree, as in jax (a state without a peer store). is_leaf:
    an optional predicate that stops the descent (as jax's)."""
    if tree is None:
        return None
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest),
                                   is_leaf=is_leaf)
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


# The recursive walkers below are module-level functions: a nested
# function that calls itself is a reference cycle (the function and its
# closure cell), which would keep the leaves it reached alive until the
# garbage collector runs, gigabytes for an LLM's gradients.

def _walk_paths(node, path, out):
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
        _walk_paths(v, path + [k], out)


def tree_paths(tree) -> list:
    """[(path, leaf)] in the reference's jax flatten order; None is an
    empty tree, as in jax."""
    out = []
    _walk_paths(tree, [], out)
    return out


def _rebuild(node, path, leaf_of):
    if node is None:
        return None
    if isinstance(node, dict):
        return {k: _rebuild(v, path + [str(k)], leaf_of)
                for k, v in node.items()}
    if _is_namedtuple(node):
        return type(node)(*(_rebuild(getattr(node, f), path + [f], leaf_of)
                            for f in node._fields))
    if isinstance(node, (list, tuple)):
        return type(node)(_rebuild(v, path + [str(i)], leaf_of)
                          for i, v in enumerate(node))
    return leaf_of("/".join(path), node)


def tree_unflatten_paths(like, leaf_of):
    """A tree shaped as `like` whose leaf at each path is
    `leaf_of(path, leaf)` (`tree_paths`' paths); None stays None."""
    return _rebuild(like, [], leaf_of)


def _walk_dotted(node, prefix, flat):
    for k, v in node.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            _walk_dotted(v, name + ".", flat)
        else:
            flat[name] = v


def ordered_leaves(tree) -> list:
    """The tensors of a tree of dicts of dotted names in the reference's
    leaf order (nested dict keys sorted, numeric name parts by value),
    the order the reference's tree reductions sum in."""
    flat = {}
    _walk_dotted(tree, "", flat)
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


def named_leaves(tree) -> list:
    """[(name, leaf)] in the reference's leaf order: a flat dict of
    dotted names (the cnn's parameters) by `leaf_order`, any other tree
    by `tree_paths` ('/'-joined names). `tree_unflatten_paths(tree,
    lambda name, _: new[name])` rebuilds a tree from these names."""
    if isinstance(tree, dict) and all(isinstance(v, torch.Tensor)
                                      for v in tree.values()):
        return [(n, tree[n]) for n in leaf_order(tree)]
    return tree_paths(tree)


def tree_flatten_vector(tree: dict) -> torch.Tensor:
    """Flatten a dict of tensors into one 1-D float32 vector, in the
    reference's leaf order (`repro.utils.pytree.tree_flatten_vector`)."""
    return torch.cat([tree[n].reshape(-1).float()
                      for n in leaf_order(tree)])
