"""Minimal optimizer core (reference `repro.optim.base`).

``opt.init(params) -> state``; ``opt.update(grads, state, params) ->
(updates, new_state)``; ``apply_updates(params, updates)``. Parameters are
trees of tensors (the cnn's flat dict of dotted names, an LLM's nested
dicts and lists); these functions allocate new tensors and leave their
inputs untouched. Every optimizer here updates leaf by leaf: a leaf's
update reads only that leaf's gradient, state and parameter, and the
step count.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from repro_torch.utils.pytree import tree_map


@dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable  # (grads, state, params) -> (updates, new_state)


def apply_updates(params, updates):
    """p + u, with the update cast to the parameter's dtype first."""
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)


def resolve_lr(lr, count):
    """lr may be a float or a schedule fn(step) -> float32 (a schedule is
    called with the 0-d int32 step count; a float passes through)."""
    if callable(lr):
        return lr(count)
    return lr
