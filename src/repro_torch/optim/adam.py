"""AdamW (decoupled weight decay) with float32 moments, reference
`repro.optim.adam`: bias-corrected m̂ / (√v̂ + eps), plus weight_decay·p,
times the (scheduled) lr; the update is cast to the parameter's dtype by
`apply_updates`."""
from __future__ import annotations

import torch

from repro_torch.optim.base import Optimizer, resolve_lr
from repro_torch.optim.sgd import _is_pair
from repro_torch.utils.pytree import tree_leaves, tree_map


def adamw(lr=3e-4, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        p0 = tree_leaves(params)[0]

        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "count": torch.zeros((), dtype=torch.int32,
                                     device=p0.device)}

    def update(grads, state, params):
        c = state["count"] + 1
        step_lr = resolve_lr(lr, state["count"])
        bc1 = 1.0 - b1 ** c.float()
        bc2 = 1.0 - b2 ** c.float()

        def upd(g, m, v, p):
            gf = g.float()
            m_new = b1 * m + (1 - b1) * gf
            v_new = b2 * v + (1 - b2) * gf.square()
            step = (m_new / bc1) / ((v_new / bc2).sqrt() + eps)
            if weight_decay:
                step = step + weight_decay * p.float()
            return -step_lr * step, m_new, v_new

        trip = tree_map(upd, grads, state["m"], state["v"], params)
        pick = (lambda i: tree_map(lambda t: t[i], trip, is_leaf=_is_pair))
        return pick(0), {"m": pick(1), "v": pick(2), "count": c}

    return Optimizer(init=init, update=update)
