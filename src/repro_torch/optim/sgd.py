"""SGD with momentum and weight decay — the paper's optimizer (§III-A:
lr 0.1, momentum 0.9, decay 0.005), reference `repro.optim.sgd`.

The order of operations is the reference's, which `torch.optim.SGD` does
not follow: the gradient is cast to float32, weight decay is added to it
before the momentum, the momentum buffer is float32 even for bf16
parameters, and the update -lr·m is cast to the parameter's dtype by
`apply_updates`.
"""
from __future__ import annotations

import torch

from repro_torch.optim.base import Optimizer


def sgd(lr: float = 0.1, momentum: float = 0.9,
        weight_decay: float = 0.0) -> Optimizer:
    def init(params: dict):
        p0 = next(iter(params.values()))
        return {
            "mu": {n: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
                   for n, p in params.items()},
            "count": torch.zeros((), dtype=torch.int32, device=p0.device),
        }

    def update(grads: dict, state: dict, params: dict):
        updates, mu = {}, {}
        for n, g in grads.items():
            gf = g.float()
            if weight_decay:
                gf = gf + weight_decay * params[n].float()
            mu[n] = momentum * state["mu"][n] + gf
            updates[n] = -lr * mu[n]
        return updates, {"mu": mu, "count": state["count"] + 1}

    return Optimizer(init=init, update=update)
