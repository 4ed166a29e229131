"""Network events — participation, link dropouts, staleness; the port's
copy of `repro.comms.events`, on explicit `torch.Generator`s.

A client is absent because it is offline (`availability`), an edge is
absent because its link dropped this round (`p_link_drop`), and a peer is
unselectable because its update would miss the round's deadline
(`p_stale`: its parameters are still on the network, but not fresh
enough to pull).

The reference draws with jax's threefry, which torch cannot reproduce, so
these give the same distributions, not the same bits. The structure that
matters is kept:
  * link dropout is symmetric: both directions of an undirected edge
    drop together (the dense grid's upper triangle, or one pair-keyed
    uniform per edge on the CSR path);
  * a stale peer loses its candidate column only;
  * nothing drawn is used when a probability is 0 (nothing is drawn).

Each event draws from its own generator (`streams["drop"]`,
`streams["avail"]`, `streams["stale"]`, CPU generators), so the (M,)
availability and staleness draws are the same on the dense and the CSR
path. The draws are moved to the adjacency's device.
"""
from __future__ import annotations

import torch

_MASK32 = 0xFFFFFFFF


def availability_mask(generator: torch.Generator, m: int,
                      p_available: float, device=None):
    """(M,) bool — client online this round (iid Bernoulli)."""
    if p_available >= 1.0:
        return torch.ones(m, dtype=torch.bool, device=device)
    return (torch.rand(m, generator=generator) < p_available).to(device)


def drop_links(generator: torch.Generator, adj, p_drop: float):
    """Symmetric iid edge dropout on a dense (M, M) adjacency: each
    undirected link fails with probability p (upper-triangle draws)."""
    if p_drop <= 0.0:
        return adj
    m = adj.shape[0]
    u = torch.rand((m, m), generator=generator).to(adj.device)
    fail = torch.triu(u < p_drop, diagonal=1)
    return adj & ~(fail | fail.T)


def staleness_rounds(generator: torch.Generator, m: int, p_stale: float,
                     max_staleness: int, device=None):
    """(M,) int32 — rounds by which each client's published update lags
    (0 = fresh): stale w.p. p_stale, lag uniform in [1, max_staleness]."""
    if p_stale <= 0.0:
        return torch.zeros(m, dtype=torch.int32, device=device)
    stale = torch.rand(m, generator=generator) < p_stale
    lag = torch.randint(1, max(max_staleness, 1) + 1, (m,),
                        generator=generator)
    return torch.where(stale, lag, 0).to(device, torch.int32)


def _mul32(h, c: int):
    """(h · c) mod 2^32 for int64 tensors holding values < 2^32, in 16-bit
    halves of c so no product leaves the int64 range."""
    lo, hi = c & 0xFFFF, c >> 16
    return (h * lo + (((h * hi) & 0xFFFF) << 16)) & _MASK32


def _fmix32(h):
    """murmur3's 32-bit finalizer on int64 tensors holding uint32 values."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def edge_pair_uniform(seed: int, rows, cols):
    """(E,) float32 uniforms in [0, 1) keyed by the canonical endpoint
    pair (min, max) and `seed`: a counter-based hash, so both directed
    slots of an undirected edge draw the same value, at O(E) and with no
    (M, M) grid. Integer arithmetic only: the same values on any device.
    `drop_links_pairfold` draws the same value at every grid position."""
    rows, cols = rows.long(), cols.long()
    lo, hi = torch.minimum(rows, cols), torch.maximum(rows, cols)
    h = _fmix32(_mul32(lo, 0x9E3779B1) ^ (seed & _MASK32))
    h = _fmix32(h ^ _mul32(hi, 0x85EBCA77))
    return (h >> 8).float() * (1.0 / (1 << 24))


def _pair_seed(generator: torch.Generator) -> int:
    return int(torch.randint(0, 1 << 32, (), generator=generator))


def drop_edges(generator: torch.Generator, rows, cols, p_drop: float):
    """(E,) bool keep mask — the CSR form of symmetric dropout, pair-keyed
    (`edge_pair_uniform` under one seed drawn from `generator`). The dense
    `drop_links` draws a grid instead: the same key gives other failures
    on the two paths, from the same distribution; with p_drop = 0 both
    are the identity."""
    if p_drop <= 0.0:
        return torch.ones(rows.shape, dtype=torch.bool, device=rows.device)
    return edge_pair_uniform(_pair_seed(generator), rows, cols) >= p_drop


def drop_links_pairfold(generator: torch.Generator, adj, p_drop: float):
    """Dense oracle of `drop_edges`: the same pair-keyed uniforms at every
    (i, j) grid position — O(M²), for parity tests only."""
    if p_drop <= 0.0:
        return adj
    m = adj.shape[0]
    i = torch.arange(m, device=adj.device)
    u = edge_pair_uniform(_pair_seed(generator), i.repeat_interleave(m),
                          i.repeat(m))
    return adj & (u.reshape(m, m) >= p_drop)


def apply_events_sparse(streams: dict, rows, cols, m: int, cfg):
    """`apply_events` on a CSR edge list → (edge_keep (E,), available
    (M,), staleness (M,)). The (M,) draws equal the dense path's for the
    same streams; dropout is pair-keyed (`drop_edges`). `edge_keep`
    already folds in both endpoints' availability and, under
    stale_mode="drop", the stale target columns."""
    keep = drop_edges(streams["drop"], rows, cols, cfg.p_link_drop)
    avail = availability_mask(streams["avail"], m, cfg.availability,
                              rows.device)
    stale = staleness_rounds(streams["stale"], m, cfg.p_stale,
                             cfg.max_staleness, rows.device)
    rows, cols = rows.long(), cols.long()
    keep = keep & avail[rows] & avail[cols]
    if cfg.stale_mode != "serve":
        keep = keep & (stale == 0)[cols]
    return keep, avail, stale


def apply_events(streams: dict, adj, cfg):
    """(candidate_mask (M, M), available (M,), staleness (M,)) for one
    round: the adjacency after link dropouts, minus offline rows and
    columns, and under stale_mode="drop" minus the stale columns."""
    m = adj.shape[0]
    cand = drop_links(streams["drop"], adj, cfg.p_link_drop)
    avail = availability_mask(streams["avail"], m, cfg.availability,
                              adj.device)
    stale = staleness_rounds(streams["stale"], m, cfg.p_stale,
                             cfg.max_staleness, adj.device)
    cand = cand & avail[:, None] & avail[None, :]
    if cfg.stale_mode != "serve":
        cand = cand & (stale == 0)[None, :]
    return cand, avail, stale
