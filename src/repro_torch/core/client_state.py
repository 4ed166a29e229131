"""Population state — stacked tensors over the M clients, reference
`repro.core.client_state`.

`last_selected` and `loss_matrix` are the two context arrays Algorithm 1
keeps per client (the peer recency array t and the loss array l).
`round` is a 0-d int32 tensor kept on the CPU, so reading it never waits
for the device.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.models import model as model_mod
from repro_torch.models.split import split_params
from repro_torch.optim.base import Optimizer


class PopulationState(NamedTuple):
    extractor: Any       # dict of (M, ...) tensors
    header: Any          # dict of (M, ...) tensors
    opt_e: Any           # per-client phase-e optimizer state (stacked)
    opt_h: Any           # per-client phase-h optimizer state (stacked)
    loss_matrix: Any     # (M, M) f32 — loss array l (Eq. 6 cache)
    last_selected: Any   # (M, M) int32 — recency array t (−1 = never)
    round: Any           # () int32, on the CPU
    # pfeddst_async's versioned peer store (fl.hetero.PeerStore); None for
    # every other strategy
    store: Any = None


def stack_trees(trees: list):
    """List of per-client states (dicts/tensors) → one stacked state."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: stack_trees([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def init_population(cfg, generator: torch.Generator, num_clients: int,
                    opt_e: Optimizer, opt_h: Optimizer,
                    device) -> PopulationState:
    """Independent random init per client; `generator` lives on `device`."""
    extractors, headers = [], []
    for _ in range(num_clients):
        e, h = split_params(cfg, model_mod.init_params(cfg, generator,
                                                       device))
        extractors.append(e)
        headers.append(h)
    m = num_clients
    return PopulationState(
        extractor=stack_trees(extractors),
        header=stack_trees(headers),
        opt_e=stack_trees([opt_e.init(e) for e in extractors]),
        opt_h=stack_trees([opt_h.init(h) for h in headers]),
        loss_matrix=torch.zeros((m, m), dtype=torch.float32, device=device),
        last_selected=torch.full((m, m), -1, dtype=torch.int32,
                                 device=device),
        round=torch.zeros((), dtype=torch.int32),
    )
