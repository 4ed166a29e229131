"""Minimal optimizer core (reference `repro.optim.base`).

``opt.init(params) -> state``; ``opt.update(grads, state, params) ->
(updates, new_state)``; ``apply_updates(params, updates)``. Parameters are
flat dicts of tensors; these functions allocate new tensors and leave
their inputs untouched.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable


@dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable  # (grads, state, params) -> (updates, new_state)


def apply_updates(params: dict, updates: dict) -> dict:
    """p + u, with the update cast to the parameter's dtype first."""
    return {n: p + updates[n].to(p.dtype) for n, p in params.items()}
