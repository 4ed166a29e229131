"""SGD with momentum and weight decay — the paper's optimizer (§III-A:
lr 0.1, momentum 0.9, decay 0.005), reference `repro.optim.sgd`.

The order of operations is the reference's, which `torch.optim.SGD` does
not follow: the gradient is cast to float32, weight decay is added to it
before the momentum, the momentum buffer is float32 even for bf16
parameters, and the update -lr·m is cast to the parameter's dtype by
`apply_updates`. lr may be a schedule (`optim.schedules`, through
`resolve_lr`).
"""
from __future__ import annotations

import torch

from repro_torch.optim.base import Optimizer, resolve_lr
from repro_torch.utils.pytree import tree_leaves, tree_map


def sgd(lr=0.1, momentum: float = 0.9, weight_decay: float = 0.0,
        nesterov: bool = False) -> Optimizer:
    def init(params):
        p0 = tree_leaves(params)[0]
        return {
            "mu": tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params),
            "count": torch.zeros((), dtype=torch.int32, device=p0.device),
        }

    def update(grads, state, params):
        step_lr = resolve_lr(lr, state["count"])

        def upd(g, m, p):
            gf = g.float()
            if weight_decay:
                gf = gf + weight_decay * p.float()
            m_new = momentum * m + gf
            d = gf + momentum * m_new if nesterov else m_new
            return -step_lr * d, m_new

        pairs = tree_map(upd, grads, state["mu"], params)
        return (tree_map(lambda t: t[0], pairs, is_leaf=_is_pair),
                {"mu": tree_map(lambda t: t[1], pairs, is_leaf=_is_pair),
                 "count": state["count"] + 1})

    return Optimizer(init=init, update=update)


def _is_pair(x) -> bool:
    return isinstance(x, tuple) and not hasattr(x, "_fields")
