"""Round engine for decentralized FL — reference `repro.fl.engine`.

A strategy is data, a `StrategySpec` (init, ordered stages, stream
layout, exchange metadata); `make_round` turns it into one round function
and `make_multi_round` into a chunk of rounds with stacked metrics. A
round is the spec's stages `(state, ctx) -> state` run by
`run_round`, which owns participation (client sampling × the comms
fabric's availability), the named random streams, the network hooks
(candidate mask, Eq. 9 cost matrix, the packed neighbour view of a
`SparseFabric`) and the metrics contract (`active`, `stale`,
`comm_edges`; the semi-async stages add `round_wall_s` and
`straggler_wall_s` (the deadline gate, under a DeviceProfile) and
`eff_lag_mean`, `eff_lag_max`, `serve_age_mean` (versioned pulls)). The
stage library below (plans, training, server averaging, gossip mixing)
is what the baselines of `fl.strategies` compose. Each stage's name (its
`stage_name` attribute, else its function name) labels its span in a
profile and its row of the stage profile (`obs.timers`).

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
    "train"  (n_steps, n, B) baseline local-training batch indices
    "nbr"    (M, M)          the gossip plans' uniform plane
    "grow"   {leaf: bool}    dispfl's regrow planes, by the port's leaf name
    "net"    (cand (M, M), available (M,), stale (M,)) the fabric's round
             masks; on a packed fabric (slot_mask (M, D), available,
             stale)
    "churn"  (u_leave (M,), u_join (M,)) the open world's membership
             uniforms (`openworld.lifecycle.stage_churn`)
    "byz"    {leaf: noise} the gaussian attack's standard normals, by the
             port's leaf name (`utils.pytree.tree_paths` of the attacked
             parameter view; `openworld.attacks.stage_byzantine`)

— through which the parity tests inject the reference's draws. The
regrow planes and the attack noise are as large as the model, so without
injection they are drawn on the data's device (`device_generator`), not
on the CPU. The fabric and the open world draw from generators of their
own (`salted_streams`: the round key and a salt; `net_streams` is the
fabric's), keyed apart from the strategy's streams, so adding a fabric,
churn or an attack changes no other stream's draws.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.core.aggregation import (
    F32_BLOCK_COLUMNS,
    aggregate_extractors,
    mean_over_active,
    selection_to_weights,
)
from repro_torch.core.client_state import client_rows, stack_trees
from repro_torch.core.partial_freeze import make_full_step
from repro_torch.core.selection import select_peers
from repro_torch.data.pipeline import (
    as_index_tensor,
    sample_client_indices,
    take_client_batches,
)
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.gossip_mix import (
    gossip_degree_bound,
    weights_to_neighbors,
)
from repro_torch.models.split import merge_params, split_params
from repro_torch.obs.timers import annotate, stage_name
from repro_torch.utils.pytree import tree_leaves, tree_map

# keys the network generators apart from the strategy's streams (whose
# positions 0, 1, ... end each stream's seed): the reference's net_key salt
NET_SALT = 0x636F6D


def named_streams(key, streams: tuple) -> dict:
    """One CPU torch.Generator per stream name, seeded from the round key
    and the stream's position (the position is part of the layout)."""
    out = {}
    for i, name in enumerate(streams):
        seed = np.random.SeedSequence([*key, i]).generate_state(1, np.uint64)
        out[name] = torch.Generator().manual_seed(int(seed[0]))
    return out


def salted_streams(key, salt: int, streams: tuple) -> dict:
    """Generators keyed by the round key and `salt`: independent of every
    strategy stream (whose positions end each stream's seed) and of the
    streams of another salt."""
    return named_streams((*key, salt), streams)


def net_streams(key) -> dict:
    """The round's network generators (`comms.fabric.NET_STREAMS`), keyed
    by the round key and NET_SALT, independent of every strategy stream."""
    from repro_torch.comms.fabric import NET_STREAMS

    return salted_streams(key, NET_SALT, NET_STREAMS)


def device_generator(generator: torch.Generator, device) -> torch.Generator:
    """A generator on `device` seeded by one draw of `generator` (for
    planes too large to draw on the CPU)."""
    seed = int(torch.randint(0, 2 ** 62, (), generator=generator))
    return torch.Generator(device=device).manual_seed(seed)


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


def keep_if_none_active(active, new, old):
    """`old` where no client is active this round (stops an all-zero
    server average from being broadcast), `new` otherwise."""
    any_active = active.any()
    return tree_map(lambda n, o: torch.where(any_active, n, o), new, old)


def scatter_rows(tree, idx, sub):
    """Scatter subset leaves back into the full population at `idx`
    (returns new tensors; `tree` is left as it was)."""
    def put(x, s):
        out = x.clone()
        out[idx] = s
        return out

    return tree_map(put, tree, sub)


def trains_in_place(cfg) -> bool:
    """Whether a population of `cfg` trains, mixes and masks in place
    (`train_rows`, `mix_tree(rows=)`, `ops.mask_evolve_leaves(in_place=)`):
    the LLM families do, at every size, so the route the card takes at
    full width is the one the CPU tests hold to the reference at reduced
    width. One copy of an LLM population is as large as the card
    (qwen2-1.5b at M = 4 holds 14.2 GB of bf16 parameters and 28.4 GB of
    f32 momenta), so their stages write the population's tensors row by
    row and a round consumes its input state (rebind it). The cnn keeps
    the functional stages. Both routes run the same operations on the
    same values."""
    return cfg.family != "cnn"


def where_rows_(mask_m, new, old):
    """`where_tree(mask_m, new, old)` written into `new` (a tree the
    caller owns): rows outside the (M,) mask take `old`'s. → new."""
    keep = ~mask_m

    def put(n, o):
        n[keep] = o[keep]

    tree_map(put, new, old)
    return new


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


def train_sampled(ctx, step, trained, frozen, opt_state, stream: str,
                  n_steps: int, batch_size: int):
    """n_steps of `step(trained_i, frozen_i, opt_i, batch_i) -> (trained_i,
    opt_i, metrics)` on each sampled client, one client at a time. The
    trees hold the gathered sampled rows; the batches are drawn from
    `stream` positionally in the full population (or injected as
    `ctx.draws[stream]`). → (trained, opt_state, losses (n_steps, n))."""
    data_sub = gather_rows(ctx.data, ctx.sampled_idx)

    def apply(carry, batch):
        tr, os_ = carry
        outs = [step(client_rows(tr, i), client_rows(frozen, i),
                     client_rows(os_, i), client_rows(batch, i))
                for i in range(ctx.sampled_idx.shape[0])]
        return ((stack_trees([o[0] for o in outs]),
                 stack_trees([o[1] for o in outs])),
                torch.stack([o[2]["loss"] for o in outs]))

    (new, opt), losses = scan_train(
        apply, (trained, opt_state), data_sub, ctx.streams[stream],
        n_steps, batch_size, rows=ctx.sampled_rows(), total=ctx.m,
        idx=ctx.draw(stream))
    return new, opt, losses


def _train_rows_in_place(ctx, step, trained, frozen, opt_state,
                         stream: str, n_steps: int, batch_size: int):
    """`train_rows`' in-place route: the batches are drawn as
    `train_sampled` draws them (positionally for the sampled rows, or
    injected). A sampled client that is active has its rows of `trained`
    and `opt_state` written after each step (`step(..., in_place=True)`);
    a sampled client that is not trains on copies that are dropped, as
    the functional route discards its rows. → losses (n_steps, n)."""
    rows = ctx.sampled_rows().tolist()
    act = ctx.active[ctx.sampled_idx].cpu().tolist()
    first = next(iter(ctx.data.values()))
    drawn = ctx.draw(stream)
    carries, losses = {}, []
    for s in range(n_steps):
        idx = drawn[s] if drawn is not None else sample_client_indices(
            ctx.streams[stream], len(rows), first.shape[1], batch_size,
            rows=torch.as_tensor(rows), total=ctx.m)
        idx = as_index_tensor(idx, first.device)
        step_losses = []
        for j, i in enumerate(rows):
            batch = {k: v[i][idx[j]] for k, v in ctx.data.items()}
            fro = client_rows(frozen, i)
            if act[j]:
                _, _, met = step(client_rows(trained, i), fro,
                                 client_rows(opt_state, i), batch,
                                 in_place=True)
            else:
                tr, os_ = carries.get(j, (client_rows(trained, i),
                                          client_rows(opt_state, i)))
                tr, os_, met = step(tr, fro, os_, batch)
                carries[j] = (tr, os_)
            step_losses.append(met["loss"])
        losses.append(torch.stack(step_losses))
    return torch.stack(losses)


def train_rows(ctx, step, trained, frozen, opt_state, stream: str,
               n_steps: int, batch_size: int, *, in_place: bool):
    """Local training of a round's active clients: n_steps of `step` (the
    `train_sampled` contract, plus `in_place=`) on each sampled row of
    the population's (M, …) trees `trained` / `frozen` / `opt_state`;
    the rows of clients that are not active keep their values.
    → (trained, opt_state, losses (n_steps, n)).

    in_place (`trains_in_place`): the active rows are written into
    `trained`'s and `opt_state`'s own tensors, which are returned, so the
    caller's input state is consumed. Otherwise the sampled rows are
    gathered, trained and scattered into new trees. Both routes run the
    same operations on the same values: bit for bit equal wherever the
    step's kernels are deterministic (on one CPU thread; the CPU's
    embedding backward sums in thread order)."""
    if in_place:
        losses = _train_rows_in_place(ctx, step, trained, frozen, opt_state,
                                      stream, n_steps, batch_size)
        return trained, opt_state, losses
    idx = ctx.sampled_idx
    t_sub, f_sub, o_sub = gather_rows((trained, frozen, opt_state), idx)
    new_t, new_o, losses = train_sampled(ctx, step, t_sub, f_sub, o_sub,
                                         stream, n_steps, batch_size)
    act_sub = ctx.active[idx]
    return (scatter_rows(trained, idx, where_tree(act_sub, new_t, t_sub)),
            scatter_rows(opt_state, idx, where_tree(act_sub, new_o, o_sub)),
            losses)


def gossip_edges(uniform, k: int, *, directed: bool, cand=None):
    """Random k-neighbour selection mask (no self) from an (M, M) uniform
    plane, restricted to the fabric's candidates `cand` where given.
    Undirected plans are symmetrized (`mask | mask.T`) and cut to `cand`
    again: it is not symmetric under staleness (a stale peer loses its
    column only), and `.T` must not bring back an edge the network
    excluded."""
    m = uniform.shape[0]
    no_self = ~torch.eye(m, dtype=torch.bool, device=uniform.device)
    cand = no_self if cand is None else cand & no_self
    mask = select_peers(uniform, k=k, candidate_mask=cand)
    if not directed:
        mask = (mask | mask.T) & cand
    return mask


@dataclass
class ExchangePlan:
    """Who exchanges what with whom this round. nbr_idx/nbr_w are the
    packed form of `weights` (`weights_to_neighbors`), attached by the
    gossip plan when it routes through the `gossip_mix` kernel; `mix_tree`
    uses them iff present."""
    pattern: str                            # "star" | "p2p"
    active: Any                             # (M,) bool participants
    edges: Optional[Any] = None             # (M, M) bool, i pulls j
    weights: Optional[Any] = None           # (M, M) row-stochastic mixing
    nbr_idx: Optional[Any] = None           # (M, D) int32 packed neighbours
    nbr_w: Optional[Any] = None             # (M, D) f32 packed weights


@dataclass
class RoundContext:
    """Mutable per-round scratchpad threaded through the stages.

    m            population size
    data         stacked client dataset dict — (M, N, ...) tensors
    key          the round key (tuple of ints) the streams derive from;
                 stages that draw apart from the strategy's streams key
                 their own by it (`salted_streams`)
    streams      named CPU torch.Generators (the strategy's stream layout)
    draws        injected draws by stream name (see module docstring)
    active       (M,) bool — the clients sampled and online this round
    sampled_idx  (n,) int64 sampled client ids, on the data's device
    sampled_host the same ids on the CPU (None when a caller built the
                 context without them): the draw is made on the host, so
                 reading it back needs no copy from the device
    cand         (M, M) bool reachable peers from the comms fabric (None
                 without a network model)
    cand_bounded True only when `cand` is cut from a fabric's static graph,
                 the one case a build-time `topology_degree_bound` covers
                 (events only remove edges); a caller's mask or a dynamic
                 fabric leaves it False, so `stage_plan_gossip` never packs
                 against a bound the round's mask does not obey
                 (`weights_to_neighbors` would drop the overflow silently)
    nbr          the packed neighbour view of a SparseFabric round (None on
                 the dense path): {"idx": (M, D) int32 ascending ids,
                 "valid": (M, D) bool slots live this round, "cost": (M, D)
                 per-slot Eq. 9 c}; `score_select` then scores through
                 `score_topk_sparse`
    cost         (M, M) Eq. 9 c matrix from the fabric (None → the scalar
                 FLConfig.comm_cost)
    stale        (M,) int32 per-peer staleness lag (zeros without a
                 fabric); under `CommsConfig.stale_mode="serve"` a
                 versioned strategy picks the ring slot each peer serves
                 by it
    alive        (M,) bool population membership (`openworld.lifecycle`;
                 None on closed populations): the churn stage sets it and
                 intersects `active` and `cand` with it
    threat       the `openworld.attacks.ThreatState` (None on honest
                 populations), set by the threat stage; the PFedDST
                 `score_select` stage calls its `game_scores` hook
    plan         the ExchangePlan (set by the plan stage)
    store        the `fl.hetero.PeerStore` a versioned strategy serves
                 peers from this round (None otherwise); an exposure for
                 custom stages, the library stages read the state's store
    devices      the `fl.hetero.DeviceVectors` (set by the deadline gate,
                 None otherwise)
    aux          stage-to-stage scratch values
    metrics      round metrics

    A stage may refine `active` (the deadline gate intersects it with the
    round's completers); later stages and `metrics["active"]` see the
    refined mask.
    """
    m: int
    data: Any
    streams: dict
    active: Any
    sampled_idx: Any
    draws: dict = field(default_factory=dict)
    key: tuple = ()
    sampled_host: Any = None
    cand: Any = None
    cand_bounded: bool = False
    nbr: Any = None
    cost: Any = None
    stale: Any = None
    alive: Any = None
    threat: Any = None
    plan: Optional[ExchangePlan] = None
    store: Any = None
    devices: Any = None
    aux: dict = field(default_factory=dict)
    metrics: dict = field(default_factory=dict)

    def record(self, name: str, value):
        """Telemetry channel: a named scalar (or array) into the round's
        metrics; scalars reach History.extra by name."""
        self.metrics[name] = value

    def sampled_rows(self):
        """The sampled ids on the CPU: the host copy where run_round kept
        one, else copied back from the device."""
        if self.sampled_host is not None:
            return self.sampled_host
        return self.sampled_idx.cpu()

    def draw(self, stream: str):
        """The injected draw for `stream`, or None."""
        return self.draws.get(stream)

    def uniform(self, stream: str, shape, device):
        """The injected (or else freshly drawn, on the CPU) uniform plane
        of `stream`, as float32 on `device`."""
        u = self.draw(stream)
        if u is None:
            u = torch.rand(shape, generator=self.streams[stream])
        if not isinstance(u, torch.Tensor):
            u = torch.from_numpy(np.array(u))
        return u.to(device, torch.float32)


@dataclass(frozen=True)
class StrategySpec:
    """A strategy as data: init + ordered stages + exchange metadata.

    A new strategy should be writable from this docstring alone (the
    reference's docs/architecture.md, "Writing a strategy", works one
    example).

    init : (seed: int) -> state
        Builds the strategy state on the strategy's device. Where the
        reference takes a jax PRNG key, the port takes an int seed and
        draws from torch.Generators seeded by it. Per-client leaves carry
        a leading (M, ...) client axis; other leaves (round counters, a
        `fl.hetero.PeerStore` with (V, M, ...) leaves) pass through.

    stages : tuple of (state, ctx: RoundContext) -> state
        Run in order by `run_round`. Contract:
        - exactly one stage sets `ctx.plan` (the ExchangePlan), before any
          stage that reads it;
        - training stages guard updates with `ctx.active` (`where_tree`),
          so inactive clients keep params AND optimizer state bit for
          bit;
        - stages pass values forward through `ctx.aux` and record
          scalars/arrays into `ctx.metrics` (every key containing "loss"
          is averaged into History.train_loss by the simulator);
        - stages draw only from `ctx.streams[<stream>]` (or the injected
          `ctx.draw(<stream>)`), never from a stream another stage also
          uses; draws apart from the layout key their own generators by
          `ctx.key` and a salt (`salted_streams`).

    params_for_eval : (state) -> leading-M params dict
        The merged per-client model the simulator evaluates.

    key_streams : tuple of stream names, the layout `named_streams`
        seeds from the round key. ORDER IS PART OF THE SPEC: a stream's
        seed is its position, so adding or reordering streams changes
        every stream's draws.

    sample_stream : the stream that samples the participants ("act").
    comm_pattern : "p2p" | "star" — how `CommsFabric.account_round`
        prices the round ("p2p" needs edges in the metrics, see below).
    payload_kind : "extractor" | "model" — what one message carries.
    payload_fraction : fraction of the payload actually sent (sparse
        payloads, e.g. DisPFL masks).
    needs_head_finetune : the simulator fine-tunes a throwaway header
        copy at eval time (FedBABU semantics).
    affinity : optional (state) -> (M, M) float steering matrix for the
        fabric's dynamic topology (higher → keep/rewire toward the edge).
    versioned : the strategy carries a `fl.hetero.PeerStore` and honours
        staleness lags by serving published snapshots. Without it,
        CommsConfig.stale_mode="serve" keeps stale peers selectable but
        they serve LIVE parameters (make_strategy warns).

    Metrics contract — `run_round` guarantees these keys after the
    stages ran (stages may set them first):
      active      (M,) bool  participants (after any deadline gate)
      stale       (M,) int32 network staleness lag (zeros, no fabric)
      comm_edges  (M, M) bool p2p pulls — echoed from `ctx.plan.edges`
                  for p2p plans; selection strategies emit `select_mask`
                  instead (account_round accepts either).
    The semi-async stages add round_wall_s, straggler_wall_s (the
    deadline gate) and eff_lag_mean / eff_lag_max / serve_age_mean
    (versioned pulls).
    """
    name: str
    init: Callable                          # (seed) -> state
    stages: tuple                           # ordered (state, ctx) -> state
    params_for_eval: Callable               # (state) -> leading-M params
    key_streams: tuple                      # named stream layout
    sample_stream: str = "act"              # stream sampling participants
    comm_pattern: str = "p2p"               # "p2p" | "star"
    payload_kind: str = "extractor"         # "extractor" | "model"
    payload_fraction: float = 1.0           # sparse payloads (DisPFL masks)
    needs_head_finetune: bool = False
    affinity: Optional[Callable] = None     # (state)->(M,M) fabric steering
    versioned: bool = False                 # carries a hetero PeerStore


def _on(x, device, dtype=None):
    """An injected draw (numpy or tensor) as a tensor on `device`."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x))
    return x.to(device, dtype)


def run_round(stages, state, data, key, *, m: int, ratio: float,
              key_streams: tuple, sample_stream: str = "act",
              draws: dict | None = None, fabric=None, affinity=None,
              candidate_mask=None, comm_cost=None, available=None):
    """Execute one round's stages under the engine's participate step
    (the `sample_stream` stream samples the participants, or
    draws["act"] replaces them; a client trains iff it is sampled and
    online).

    key: the round key (tuple of ints) the named streams derive from;
    draws: optional injected draws by stream name. fabric: a CommsFabric
    or SparseFabric, which draws the round's candidates, availability and
    staleness from `net_streams(key)` (or takes draws["net"]) and sets the
    Eq. 9 cost matrix; affinity: the dynamic topology's (M, M) steering
    matrix. candidate_mask / comm_cost / available are the direct network
    hooks of fabric-less callers; a fabric overrides the first two."""
    device = next(iter(data.values())).device
    streams = named_streams(key, key_streams)
    draws = dict(draws or {})
    cand = None if candidate_mask is None else _on(candidate_mask, device,
                                                  torch.bool)
    cost = comm_cost
    cand_bounded, nbr = False, None
    stale = torch.zeros(m, dtype=torch.int32, device=device)
    if available is not None:
        available = _on(available, device, torch.bool)
    if fabric is not None:
        packed = hasattr(fabric, "round_slots")
        net = draws.get("net")
        if net is not None:
            first, avail, stale = (_on(net[0], device, torch.bool),
                                   _on(net[1], device, torch.bool),
                                   _on(net[2], device, torch.int32))
        elif packed:
            first, avail, stale = fabric.round_slots(net_streams(key))
        else:
            first, avail, stale = fabric.round_masks(net_streams(key),
                                                     affinity=affinity)
        if packed:
            nbr = {"idx": fabric.nbr_idx, "valid": first,
                   "cost": fabric.slot_cost}
            cand = fabric.cand_dense(first)
        else:
            cand = first
        cost = fabric.cost
        cand_bounded = not fabric.is_dynamic
        available = avail if available is None else available & avail
    # the draw stays on the host as well (ctx.sampled_host)
    host_idx, _ = sample_participants(streams[sample_stream], m, ratio,
                                      idx=draws.get("act"))
    idx, active = sample_participants(None, m, ratio, idx=host_idx,
                                      device=device)
    if available is not None:
        active = active & available
    ctx = RoundContext(m=m, data=data, streams=streams, draws=draws,
                       key=tuple(key), active=active, sampled_idx=idx,
                       sampled_host=host_idx, cand=cand,
                       cand_bounded=cand_bounded, nbr=nbr, cost=cost,
                       stale=stale)
    for stage in stages:
        # a profiler span per stage (torch.profiler groups ops by it)
        with annotate(f"stage:{stage_name(stage)}"):
            state = stage(state, ctx)
    metrics = ctx.metrics
    metrics.setdefault("active", ctx.active)
    metrics.setdefault("stale", stale)
    if (ctx.plan is not None and ctx.plan.pattern == "p2p"
            and ctx.plan.edges is not None):
        metrics.setdefault("comm_edges", ctx.plan.edges)
    return state, metrics


def make_round(spec: StrategySpec, fl, fabric=None):
    """A StrategySpec as one round function

        (state, data, key, draws=None) -> (state, metrics)

    `run_round` over the spec's stages, its stream layout and sample
    stream, with the fabric (if any) and the spec's affinity of the
    incoming state under it. key: the round key (tuple of ints, the
    simulator's `(seed, round)`); draws: injected draws (module
    docstring).

    The reference's `jit=` and `client_axis=` have no counterpart here:
    the port runs eagerly on one device, so there is no round to compile
    and no client axis to shard. A round consumes its input state where a
    stage writes in place (the pfeddst_async peer store): rebind the
    returned state."""
    m = fl.num_clients

    def round_fn(state, data, key, draws=None):
        aff = (spec.affinity(state)
               if fabric is not None and spec.affinity is not None else None)
        return run_round(spec.stages, state, data, key, m=m,
                         ratio=fl.client_sample_ratio,
                         key_streams=spec.key_streams,
                         sample_stream=spec.sample_stream, draws=draws,
                         fabric=fabric, affinity=aff)

    return round_fn


def make_multi_round(spec: StrategySpec, fl, fabric=None, *,
                     chunk_rounds: int):
    """A StrategySpec as a chunk of rounds

        (state, data, seed, start) -> (state, stacked_metrics)

    running rounds start … start + chunk_rounds − 1, round r keyed
    `(seed, r)`, exactly as the simulator keys its per-round loop:
    `chain_rounds` over `make_round`'s round function, so a chunk equals
    chunk_rounds `make_round` calls bit for bit, state and every metric.

    Not a CUDA graph: each round's generators are seeded on the host from
    its round key (`named_streams`) and its draws copied to the device,
    so a captured graph would replay one round's draws."""
    return chain_rounds(make_round(spec, fl, fabric), chunk_rounds)


def chain_rounds(round_fn, chunk_rounds: int):
    """`chunk_rounds` calls of a round function
    `(state, data, key, draws=None) -> (state, metrics)` as one chunk
    `(state, data, seed, start) -> (state, stacked_metrics)`, round r
    keyed `(seed, r)`. The simulator chains `Strategy.round` itself, so
    the per-round and the chunked loop run the same round function.

    Each metric comes back stacked on a leading (R,) axis: a tensor
    metric as one (R, ...) tensor on its device (each round's value
    copied into it when the round ends, so a later round writing in place
    cannot reach it), any other value as a list of R. The chunk adds no
    host synchronisation between its rounds: it fences nothing and reads
    no metric; `metrics_to_host` brings the stack over in one copy.
    Stages that synchronise inside a round still do (ROADMAP lists them)."""

    def multi_fn(state, data, seed: int, start: int):
        stacked = None
        for i in range(chunk_rounds):
            state, metrics = round_fn(state, data, (seed, int(start) + i))
            if stacked is None:
                stacked = _alloc_stack(metrics, chunk_rounds)
            _put_round(stacked, i, metrics)
        return state, stacked

    return multi_fn


def _alloc_stack(metrics: dict, n: int) -> dict:
    """Empty (n, ...) buffers for a round's tensor metrics, lists for the
    rest."""
    return {k: (torch.empty((n,) + tuple(v.shape), dtype=v.dtype,
                            device=v.device)
                if isinstance(v, torch.Tensor) else [])
            for k, v in metrics.items()}


def _put_round(stacked: dict, i: int, metrics: dict):
    if metrics.keys() != stacked.keys():
        raise ValueError(f"round {i} of the chunk emitted metrics "
                         f"{sorted(metrics)}, the first round "
                         f"{sorted(stacked)}")
    for k, v in metrics.items():
        if isinstance(v, torch.Tensor):
            stacked[k][i].copy_(v)
        else:
            stacked[k].append(v)


def metrics_to_host(tree: dict) -> dict:
    """A metrics dict with every device tensor moved to the CPU in one
    copy (their bytes packed into one buffer on the device); CPU tensors
    and other values pass through."""
    moved = [k for k, v in tree.items()
             if isinstance(v, torch.Tensor) and v.device.type != "cpu"]
    if not moved:
        return dict(tree)
    flat = [tree[k].contiguous().reshape(-1).view(torch.uint8)
            for k in moved]
    host = torch.cat(flat).cpu()
    out, off = dict(tree), 0
    for k, f in zip(moved, flat):
        v = tree[k]
        out[k] = host[off:off + f.numel()].clone().view(v.dtype).reshape(
            v.shape)
        off += f.numel()
    return out


def unstack_metrics(stacked: dict, n: int) -> list:
    """The n per-round metric dicts of a stacked chunk (`make_multi_round`)."""
    return [{k: v[i] for k, v in stacked.items()} for i in range(n)]


def gather_neighbors(tree, nbr_idx, m: int):
    """Per-neighbourhood view of a leading-M client tree: every (M, ...)
    leaf becomes (M, D, ...), row i holding `leaf[nbr_idx[i]]` (padding
    slots hold whatever client the fill id names — mask with the round's
    valid slots before reducing). Other leaves pass through."""
    idx = nbr_idx.long()

    def g(x):
        if isinstance(x, torch.Tensor) and x.dim() >= 1 and x.shape[0] == m:
            return x[idx]
        return x

    return tree_map(g, tree)


# ---------------------------------------------------------------------------
# stage library — the reusable stages the baselines compose
# ---------------------------------------------------------------------------

def stage_plan_star():
    """Exchange plan of the centralized baselines: every active client
    uploads to and downloads from the server."""

    def plan_star(state, ctx):
        ctx.plan = ExchangePlan("star", active=ctx.active)
        return state

    return plan_star


def stage_plan_gossip(fl, *, directed: bool, stream: str = "nbr",
                      topo_degree: int | None = None):
    """Random k-neighbour gossip plan restricted to the round's candidates;
    only active clients pull. When the plan's degree bound D is at most
    M/2 — directed plans: k + 1; undirected `mask | mask.T` plans: the
    static topology's degree + 1 (`topo_degree`, from
    `comms.topology.topology_degree_bound`), used only when the round's
    candidates are cut from that graph (`ctx.cand_bounded`) — and the
    device packs plans (`kernels.ops.packs_gossip_plans`: always on CUDA),
    the weights are also packed into neighbour lists, so `stage_mix` runs
    the O(M·D·F) `gossip_mix` kernel instead of the dense (M, M) mix."""

    def plan_gossip(state, ctx):
        device = ctx.active.device
        uniform = ctx.uniform(stream, (ctx.m, ctx.m), device)
        nbr = gossip_edges(uniform, fl.peers_per_round, directed=directed,
                           cand=ctx.cand)
        nbr = nbr & ctx.active[:, None]
        weights = selection_to_weights(nbr, include_self=True)
        nbr_idx = nbr_w = None
        topo = topo_degree if ctx.cand_bounded else None
        d_max = gossip_degree_bound(fl.peers_per_round, ctx.m,
                                    directed=directed, topo_degree=topo)
        if kernel_ops.packs_gossip_plans(ctx.m, device) \
                and 2 * d_max <= ctx.m:
            nbr_idx, nbr_w = weights_to_neighbors(weights, d_max)
        ctx.plan = ExchangePlan("p2p", active=ctx.active, edges=nbr,
                                weights=weights, nbr_idx=nbr_idx,
                                nbr_w=nbr_w)
        return state

    return plan_gossip


def stage_train_full(cfg, fl, opt, n_steps: int, *, stream: str = "train"):
    """Full-model local SGD on dict states ({"params", "opt", ...}): only
    the sampled rows train, one client at a time; inactive clients keep
    params and optimizer state (`train_rows`, in place where
    `trains_in_place`). `train_loss` is the mean last-step loss over the
    sampled rows."""
    step = make_full_step(cfg, opt)
    in_place = trains_in_place(cfg)

    def full_step(params, _frozen, opt_state, batch, **kw):
        return step(params, opt_state, batch, **kw)

    def local_train(state, ctx):
        params, opt_state, losses = train_rows(
            ctx, full_step, state["params"], {}, state["opt"], stream,
            n_steps, fl.batch_size, in_place=in_place)
        ctx.metrics["train_loss"] = losses[-1].mean()
        return {**state, "params": params, "opt": opt_state}

    return local_train


def stage_star_average(cfg, *, share: str, reducer=None):
    """Server step: average the shared partition ("model" or "extractor")
    over the plan's active clients and broadcast it back; keep the old
    population when nobody participated.

    reducer: a drop-in replacement for `mean_over_active` with its
    `(tree, active) -> broadcast tree` contract, the hook the robust
    aggregators of `openworld.defense` plug into. None keeps the plain
    mean bit for bit."""
    reduce = mean_over_active if reducer is None else reducer

    def aggregate_star(state, ctx):
        params, active = state["params"], ctx.plan.active
        if share == "model":
            new = reduce(params, active)
        else:
            shared, headers = split_params(cfg, params)
            new = merge_params(reduce(shared, active), headers)
        return {**state,
                "params": keep_if_none_active(active, new, params)}

    return aggregate_star


def mix_blocks(widths, budget: int) -> list:
    """Cut leaves of `widths` columns (in order) into blocks of at most
    `budget` columns: each block a list of (leaf, first column, end
    column) segments; a leaf wider than the budget spans blocks."""
    blocks, cur, used = [], [], 0
    for li, width in enumerate(widths):
        c0 = 0
        while c0 < width:
            take = min(width - c0, budget - used)
            cur.append((li, c0, c0 + take))
            used += take
            c0 += take
            if used == budget:
                blocks.append(cur)
                cur, used = [], 0
    if cur:
        blocks.append(cur)
    return blocks


def mix_tree(tree, plan: ExchangePlan, m: int, *, rows=None):
    """Row-stochastic mixing of a leading-M tree by an ExchangePlan. With
    the plan's neighbour lists: the leaves packed as (M, P) f32 columns,
    one `gossip_mix` call per block of at most F32_BLOCK_COLUMNS columns
    (`mix_blocks`; an output column depends only on its own column's
    inputs, in slot order, so the blocks' result is bitwise the whole
    packed call's). Else the dense per-leaf mix.

    rows: None → a new tree. An (M,) bool mask → the mixed rows of those
    clients written into `tree`'s own tensors (the in-place path of
    `trains_in_place`; every block is read whole before it is written),
    and `tree` returned."""
    leaves = tree_leaves(tree)
    if plan.nbr_idx is None:
        mixed = aggregate_extractors(tree, plan.weights)
        return mixed if rows is None else where_rows_(~rows, tree, mixed)
    outs = leaves if rows is not None else [torch.empty_like(x)
                                            for x in leaves]
    src = [x.reshape(m, -1) for x in leaves]
    dst = [x.reshape(m, -1) for x in outs]
    for block in mix_blocks([x.shape[1] for x in src], F32_BLOCK_COLUMNS):
        packed = torch.cat([src[li][:, c0:c1].float()
                            for li, c0, c1 in block], dim=1)
        mixed = kernel_ops.gossip_mix(packed, plan.nbr_idx, plan.nbr_w)
        del packed
        off = 0
        for li, c0, c1 in block:
            part = mixed[:, off:off + c1 - c0].to(outs[li].dtype)
            if rows is None:
                dst[li][:, c0:c1] = part
            else:
                dst[li][rows, c0:c1] = part[rows]
            off += c1 - c0
    it = iter(outs)
    return tree_map(lambda _: next(it), tree)


def stage_mix(cfg, *, share: str, mixer=None):
    """Gossip step: mix the shared partition ("model" or "extractor") by
    the plan (`mix_tree`; in place where `trains_in_place`); inactive
    clients keep their model.

    mixer: a drop-in replacement for `mix_tree` with its `(tree, plan, m)
    -> tree` contract, the hook the robust per-row aggregators of
    `openworld.defense` plug into (they read the plan's dense `edges` and
    `weights`, so a packed plan's lists go unused). None keeps the plain
    mix bit for bit."""
    mix = mix_tree if mixer is None else mixer
    in_place = mixer is None and trains_in_place(cfg)

    def aggregate_mix(state, ctx):
        params, active = state["params"], ctx.plan.active
        part, rest = ((params, {}) if share == "model"
                      else split_params(cfg, params))
        if in_place:
            mixed = mix_tree(part, ctx.plan, ctx.m, rows=active)
        else:
            mixed = where_tree(active, mix(part, ctx.plan, ctx.m), part)
        return {**state, "params": merge_params(mixed, rest)}

    return aggregate_mix


def stage_bump_round():
    def bump_round(state, ctx):
        return {**state, "round": state["round"] + 1}

    return bump_round
