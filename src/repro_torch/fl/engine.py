"""Round engine for decentralized FL — the synchronous, fabric-less part
of reference `repro.fl.engine`.

A round is an ordered tuple of stages `(state, ctx) -> state` run by
`run_round`, which owns participation (client sampling), the named
random streams and the metrics contract (`active`, `comm_edges`).

Randomness: `named_streams` turns a round key (a tuple of ints, e.g.
`(seed, round)`) into one CPU `torch.Generator` per named stream, in the
strategy's stream layout. The reference draws with jax's threefry, which
torch cannot reproduce, so every draw also has a hook: `draws`, a dict
keyed by stream name, replaces that stream's choices —

    "act"    (n,)            sampled participant ids
    "probe"  (M, probe)      Eq. 6 probe indices per client
    "e"      (n_e, n, B)     phase-e batch indices, sampled rows in order
    "h"      (n_h, n, B)     phase-h batch indices
    "rand"   (M, M)          the pfeddst_random uniform plane

— through which the parity tests inject the reference's draws.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.data.pipeline import (
    as_index_tensor,
    sample_client_indices,
    take_client_batches,
)
from repro_torch.utils.pytree import tree_map


def named_streams(key, streams: tuple) -> dict:
    """One CPU torch.Generator per stream name, seeded from the round key
    and the stream's position (the position is part of the layout)."""
    out = {}
    for i, name in enumerate(streams):
        seed = np.random.SeedSequence([*key, i]).generate_state(1, np.uint64)
        out[name] = torch.Generator().manual_seed(int(seed[0]))
    return out


def sample_participants(generator: torch.Generator, m: int, ratio: float,
                        idx=None, device=None):
    """→ (idx, active): the round's sampled clients — the static-size
    (max(1, round(m·ratio)),) prefix of a random permutation, and the
    (M,) bool mask over the same set. `idx` replaces the draw."""
    n = max(1, int(round(m * ratio)))
    if idx is None:
        idx = torch.randperm(m, generator=generator)[:n]
    idx = as_index_tensor(idx, device)
    if idx.shape != (n,):
        raise ValueError(f"participants must have shape ({n},), "
                         f"got {tuple(idx.shape)}")
    active = torch.zeros(m, dtype=torch.bool, device=device)
    active[idx] = True
    return idx, active


def where_tree(mask_m, new, old):
    """Per-client select: mask (M,) bool over the leading axis of each
    leaf."""
    def sel(n, o):
        return torch.where(mask_m.reshape((-1,) + (1,) * (n.dim() - 1)), n, o)

    return tree_map(sel, new, old)


def gather_rows(tree, idx):
    """Gather the leading-M axis of every leaf at `idx`."""
    return tree_map(lambda x: x[idx], tree)


def scatter_rows(tree, idx, sub):
    """Scatter subset leaves back into the full population at `idx`
    (returns new tensors; `tree` is left as it was)."""
    def put(x, s):
        out = x.clone()
        out[idx] = s
        return out

    return tree_map(put, tree, sub)


def scan_train(apply, carry, data, generator, n_steps: int, batch_size: int,
               *, rows=None, total: int | None = None, idx=None):
    """n_steps of `apply(carry, stacked_batch) -> (carry, loss)` with a
    fresh batch per client each step; → (carry, (n_steps, M') losses).

    rows/total: `carry`/`data` hold only the gathered `rows` of a
    `total`-client population, and each step's batch indices are drawn
    positionally in the full population (see
    pipeline.sample_client_indices). idx (n_steps, M', B) replaces the
    draws."""
    first = next(iter(data.values()))
    losses = []
    for s in range(n_steps):
        step_idx = idx[s] if idx is not None else sample_client_indices(
            generator, first.shape[0], first.shape[1], batch_size,
            rows=rows, total=total)
        carry, loss = apply(carry, take_client_batches(data, step_idx))
        losses.append(loss)
    return carry, torch.stack(losses)


@dataclass
class ExchangePlan:
    """Who exchanges what with whom this round."""
    pattern: str                            # "p2p" (the PFedDST plan)
    active: Any                             # (M,) bool participants
    edges: Optional[Any] = None             # (M, M) bool, i pulls j
    weights: Optional[Any] = None           # (M, M) row-stochastic mixing


@dataclass
class RoundContext:
    """Mutable per-round scratchpad threaded through the stages.

    m            population size
    data         stacked client dataset dict — (M, N, ...) tensors
    streams      named CPU torch.Generators (the strategy's stream layout)
    draws        injected draws by stream name (see module docstring)
    active       (M,) bool — the clients sampled this round
    sampled_idx  (n,) int64 sampled client ids
    plan         the ExchangePlan (set by the plan stage)
    aux          stage-to-stage scratch values
    metrics      round metrics
    """
    m: int
    data: Any
    streams: dict
    active: Any
    sampled_idx: Any
    draws: dict = field(default_factory=dict)
    plan: Optional[ExchangePlan] = None
    aux: dict = field(default_factory=dict)
    metrics: dict = field(default_factory=dict)

    def record(self, name: str, value):
        """Telemetry channel: a named scalar (or array) into the round's
        metrics; scalars reach History.extra by name."""
        self.metrics[name] = value

    def draw(self, stream: str):
        """The injected draw for `stream`, or None."""
        return self.draws.get(stream)


def run_round(stages, state, data, key, *, m: int, ratio: float,
              key_streams: tuple, draws: dict | None = None):
    """Execute one round's stages under the engine's participate step
    (the "act" stream samples the participants).

    key: the round key (tuple of ints) the named streams derive from;
    draws: optional injected draws by stream name."""
    device = next(iter(data.values())).device
    streams = named_streams(key, key_streams)
    draws = dict(draws or {})
    idx, active = sample_participants(streams["act"], m, ratio,
                                      idx=draws.get("act"), device=device)
    ctx = RoundContext(m=m, data=data, streams=streams, draws=draws,
                       active=active, sampled_idx=idx)
    for stage in stages:
        state = stage(state, ctx)
    metrics = ctx.metrics
    metrics.setdefault("active", ctx.active)
    if (ctx.plan is not None and ctx.plan.pattern == "p2p"
            and ctx.plan.edges is not None):
        metrics.setdefault("comm_edges", ctx.plan.edges)
    return state, metrics
