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
from repro_torch.utils.pytree import tree_map


def client_rows(tree, i: int):
    """Client i's entries of a stacked tree (views, no copies)."""
    return tree_map(lambda x: x[i], tree)


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
    """List of per-client states (dicts, lists, tensors) → one stacked
    state."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: stack_trees([t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(stack_trees([t[i] for t in trees])
                           for i in range(len(first)))
    return torch.stack(trees)


def stack_built(make, m: int):
    """The stacked tree of make(0), …, make(m − 1), called in that order:
    each client's tree is copied into the (M, …) buffers allocated from
    the first and then dropped, so at most one client's tree is alive
    beside the stack (an LLM population leaves no room for M separate
    copies). Equal to `stack_trees([make(i) for i in range(m)])`."""
    first = make(0)
    out = tree_map(lambda t: t.new_empty((m,) + tuple(t.shape)), first)
    tree_map(lambda o, t: o[0].copy_(t), out, first)
    del first
    for i in range(1, m):
        tree_map(lambda o, t: o[i].copy_(t), out, make(i))
    return out


def init_population(cfg, generator: torch.Generator, num_clients: int,
                    opt_e: Optimizer, opt_h: Optimizer,
                    device) -> PopulationState:
    """Independent random init per client, drawn in client order from
    `generator` (on `device`); each client's optimizer states from its
    own partitions."""
    m = num_clients
    params = stack_built(
        lambda i: model_mod.init_params(cfg, generator, device), m)
    extractor, header = split_params(cfg, params)
    del params
    return PopulationState(
        extractor=extractor,
        header=header,
        opt_e=stack_built(lambda i: opt_e.init(client_rows(extractor, i)),
                          m),
        opt_h=stack_built(lambda i: opt_h.init(client_rows(header, i)), m),
        loss_matrix=torch.zeros((m, m), dtype=torch.float32, device=device),
        last_selected=torch.full((m, m), -1, dtype=torch.int32,
                                 device=device),
        round=torch.zeros((), dtype=torch.int32),
    )
