"""Communication-graph generators — who can talk to whom; the port's
copy of `repro.comms.topology`.

The canonical static form is the CSR `SparseTopology` (`comms.sparse`):
`make_sparse_topology` builds it by name, and the constant-degree
families (ring, torus, hier_ring, geo_cell) construct CSR directly at
O(M·deg). `make_topology` derives the dense boolean (M, M) adjacency from
CSR on demand — the small-M oracle the dense fabric reads. The dense
generator functions below are the parity oracles of the CSR builds. All
of this is numpy, seeded by `np.random.default_rng(graph_seed)`, and
bitwise equal to the reference.

The sampled families (erdos_renyi, small_world) run dense
rejection/rewiring samplers and pack the result to CSR (an O(M²) build;
at large M use the constant-degree families). The score-driven
`dynamic_topk` graph is torch, resampled every round from the round's
network generator, and has no static CSR. Its draws come from a
`torch.Generator`, which cannot reproduce the reference's jax draws, so
only its structure (and, for well-separated affinities without
exploration, its graph) matches the reference.

Adjacency convention: adj[i, j] = True ⇔ client i can pull from peer j.
All static graphs here are undirected (adj == adj.T).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.comms.sparse import (
    SparseTopology,
    full_csr,
    geo_cell_csr,
    hier_ring_csr,
    ring_csr,
    torus_csr,
)
from repro_torch.core.selection import select_peers

TOPOLOGIES = (
    "full", "ring", "torus", "erdos_renyi", "small_world",
    "hier_ring", "geo_cell", "dynamic",
)


def _no_self(adj: np.ndarray) -> np.ndarray:
    np.fill_diagonal(adj, False)
    return adj


def fully_connected(m: int) -> np.ndarray:
    return _no_self(np.ones((m, m), dtype=bool))


def ring(m: int, hops: int = 1) -> np.ndarray:
    """Circulant graph: each client linked to its ±1..hops ring neighbors."""
    adj = np.zeros((m, m), dtype=bool)
    idx = np.arange(m)
    for h in range(1, min(hops, (m - 1) // 2 + 1) + 1):
        adj[idx, (idx + h) % m] = True
        adj[idx, (idx - h) % m] = True
    return _no_self(adj)


def torus(m: int) -> np.ndarray:
    """2-D torus on an r×c grid (r = largest divisor of m ≤ √m).

    Prime m degenerates to a 1×m grid — i.e. a ring.
    """
    r = max(d for d in range(1, int(np.sqrt(m)) + 1) if m % d == 0)
    c = m // r
    adj = np.zeros((m, m), dtype=bool)
    for i in range(m):
        ri, ci = divmod(i, c)
        for rj, cj in (
            ((ri + 1) % r, ci), ((ri - 1) % r, ci),
            (ri, (ci + 1) % c), (ri, (ci - 1) % c),
        ):
            adj[i, rj * c + cj] = True
    adj |= adj.T
    return _no_self(adj)


def erdos_renyi(m: int, p: float, rng: np.random.Generator) -> np.ndarray:
    """G(m, p): each undirected edge present iid with probability p.

    Isolated clients are re-attached to one uniform peer so every client
    stays reachable (biases the degree of small graphs slightly upward).
    """
    upper = rng.random((m, m)) < p
    adj = np.triu(upper, 1)
    adj = adj | adj.T
    for i in np.flatnonzero(~adj.any(axis=1)):
        j = (i + 1 + rng.integers(m - 1)) % m
        adj[i, j] = adj[j, i] = True
    return _no_self(adj)


def small_world(
    m: int, k: int, beta: float, rng: np.random.Generator
) -> np.ndarray:
    """Watts–Strogatz: ring lattice of degree k, each edge rewired w.p. β."""
    k = max(2, min(k - (k % 2), m - 1))
    adj = ring(m, hops=k // 2)
    for i in range(m):
        for h in range(1, k // 2 + 1):
            j = (i + h) % m
            if rng.random() < beta and adj[i, j]:
                free = np.flatnonzero(~adj[i])
                free = free[free != i]
                if free.size:
                    t = int(rng.choice(free))
                    adj[i, j] = adj[j, i] = False
                    adj[i, t] = adj[t, i] = True
    return _no_self(adj)


def dynamic_topk(affinity, degree: int, generator: torch.Generator, *,
                 explore: int = 0):
    """Score-driven dynamic graph: each client keeps edges to its `degree`
    highest-affinity peers (e.g. the previous round's loss-disparity row)
    plus `explore` uniformly random exploration edges; the union is
    symmetrized. Ties (the all-zero affinity of round 0) are broken by
    uniform noise of scale 1e-6. Both planes are drawn, in that order,
    from `generator` (a CPU generator) and moved to the affinity's
    device. → (M, M) bool, no self."""
    m = affinity.shape[0]
    dev = affinity.device
    no_self = ~torch.eye(m, dtype=torch.bool, device=dev)
    noise = torch.rand((m, m), generator=generator).to(dev) * 1e-6
    adj = select_peers(affinity.float() + noise, k=degree,
                       candidate_mask=no_self)
    if explore > 0:
        plane = torch.rand((m, m), generator=generator).to(dev)
        adj = adj | select_peers(plane, k=explore, candidate_mask=no_self)
    return (adj | adj.T) & no_self


def topology_degree_bound(cfg, m: int):
    """Max row degree of a CommsConfig's STATIC topology, or None when
    no useful static bound exists (no comms model, dynamic topology).

    Network events only REMOVE edges (comms.events.apply_events /
    apply_events_sparse: link drops, offline rows/columns, stale-column
    drops all AND into the adjacency), so the static graph's max degree
    bounds every round's candidate row degree — the bound the packed
    gossip_mix kernel needs to engage for undirected `mask | mask.T`
    plans (kernels.gossip_mix.gossip_degree_bound). Computed from the
    CSR degree array — O(M·deg), no dense matrix. Ring/torus/hier_ring/
    geo_cell have small constant degree; ER/small-world's bound is the
    sampled graph's actual max (static, seeded). "full" returns m − 1 —
    valid but useless, and the 2·D ≤ M packing condition rejects it.

    CONTRACT: the bound covers candidate masks DERIVED FROM this static
    graph only. The dynamic topology rewires per round (a row's
    in-degree under `dynamic_topk` symmetrization is not bounded by
    `dyn_degree`), so it returns None here — and a caller-supplied
    candidate mask is likewise unbounded. The engine tracks this with
    `RoundContext.cand_bounded`: stage_plan_gossip packs neighbor lists
    only when the round's candidates provably came from a static fabric
    graph, never merely because a candidate mask exists.
    """
    if cfg is None or m <= 0:
        return None
    topo = make_sparse_topology(cfg.topology, m, cfg=cfg,
                                seed=cfg.graph_seed)
    if topo is None:         # dynamic: resampled per round, no static bound
        return None
    return topo.max_degree


def make_sparse_topology(name: str, m: int, *, cfg=None, seed: int = 0):
    """Canonical static topology by name, as CSR. `dynamic` has no
    static graph (→ None); callers resample it per round via
    `dynamic_topk`. Constant-degree families build CSR directly
    (O(M·deg)); the sampled families run the dense samplers
    (identical RNG stream → identical graphs) and pack the result."""
    rng = np.random.default_rng(seed)
    if name == "full":
        return full_csr(m)
    if name == "ring":
        return ring_csr(m, hops=cfg.ring_hops if cfg else 1)
    if name == "torus":
        return torus_csr(m)
    if name == "hier_ring":
        return hier_ring_csr(m, cfg.hier_cluster if cfg else 16)
    if name == "geo_cell":
        return geo_cell_csr(m, cfg.geo_cells if cfg else 4, rng)
    if name == "erdos_renyi":
        return SparseTopology.from_dense(
            erdos_renyi(m, cfg.er_p if cfg else 0.3, rng)
        )
    if name == "small_world":
        return SparseTopology.from_dense(small_world(
            m, cfg.ws_k if cfg else 4, cfg.ws_beta if cfg else 0.2, rng
        ))
    if name == "dynamic":
        return None
    raise KeyError(f"unknown topology {name!r}; available: {TOPOLOGIES}")


def make_topology(name: str, m: int, *, cfg=None, seed: int = 0):
    """Dense (M, M) boolean adjacency by name — the small-M oracle view,
    derived from the canonical CSR (`make_sparse_topology`). `dynamic`
    has no static graph (→ None)."""
    topo = make_sparse_topology(name, m, cfg=cfg, seed=seed)
    return None if topo is None else topo.dense()
