"""The paper's baselines and PFedDST as engine specs — reference
`repro.fl.strategies`.

`make_spec(name, cfg, fl)` returns the declarative `engine.StrategySpec`;
`make_strategy` adds the comms fabric and the round function
(`engine.make_round`):

    init(seed)                      -> state (leading-M stacked)
    round(state, data, key, draws)  -> (state, metrics)
    params_for_eval(state)          -> merged per-client params (leading M)

All local training uses the paper's §III-A recipe (SGD momentum 0.9,
weight decay 0.005, lr 0.1).

Baselines (paper §III-B), dict states {"params", "opt", "round"[, "mask"]}:
  fedavg    star plan → full-step train → server-average the model.
  fedper    star plan → full-step train → server-average the extractor;
            personal headers ride along.
  fedbabu   the header frozen at init (never trained or averaged); the
            extractor trained and averaged. Evaluation fine-tunes a
            throwaway header copy (`fl.simulator._finetune_heads`).
  dfedavgm  undirected random-gossip plan → full-step train → mix the
            whole model.
  dispfl    personal magnitude masks (fl.dispfl_sparsity) applied →
            gossip plan → train → mix the extractor → mask evolution
            (magnitude prune + random regrow at fl.dispfl_regrow, through
            the `mask_evolve` kernel).
  dfedpgp   directed gossip plan; the extractor mixed (through the
            `gossip_mix` kernel on a card), the header personal.
PFedDST (`core.rounds.make_pfeddst_stages`) over a PopulationState:
  pfeddst        the paper's method;
  pfeddst_random ablation, selection="random";
  pfeddst_async  semi-async rounds (`fl.hetero`): the deadline gate,
                 peers served from a versioned peer store
                 (`PopulationState.store`, written in place: a round
                 consumes its input state's store), staleness-weighted
                 aggregation. With a uniform profile and
                 `deadline_s=inf` it is pfeddst bit for bit.

A `FLConfig.device_profile` scales the fabric's links and Eq. 9 cost by
the sampled channel rates (the dense fabric only; the packed one
refuses them). Stale serving (`CommsConfig.stale_mode="serve"` with
`p_stale > 0`) needs a versioned strategy: the others warn, as the
reference does, that stale peers serve live parameters, and that a
finite `deadline_s` is ignored.

The open world (`fl.threat`, `fl.churn`; `repro_torch.openworld`) wraps
any strategy: `make_spec` passes its spec through
`openworld.make_open_spec` (churn, the threat cast, the byzantine
corruption, isolation telemetry; the state becomes `{"inner", "alive"}`),
and a `ThreatConfig.defense` is wired into the aggregation when the
stages are built (`reducer=` of the star average, `mixer=` of the gossip
mix, the PFedDST aggregate stage). Inert or absent configs leave the
spec the very same object.

Every strategy carries the comms fabric of `fl.comms` (`Strategy.fabric`,
on the strategy's device; None with `comms=None`): the engine composes
its availability with the client sampling, cuts every plan to the
round's candidates and echoes the plan into the metrics (`active`,
`comm_edges` / `select_mask`), so `fabric.account_round` prices a round's
bytes, simulated network time and energy with no per-strategy branch.
"""
from __future__ import annotations

import dataclasses
import math
import warnings
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from repro_torch.comms.fabric import make_fabric
from repro_torch.comms.topology import topology_degree_bound
from repro_torch.core.client_state import (client_rows, init_population,
                                          stack_built)
from repro_torch.core.partial_freeze import make_phase_steps
from repro_torch.core.rounds import PFEDDST_STREAMS, make_pfeddst_stages
from repro_torch.device import resolve_device
from repro_torch.fl.hetero import (
    init_peer_store,
    make_hetero_runtime,
    sample_device_vectors,
)
from repro_torch.fl.engine import (
    StrategySpec,
    device_generator,
    make_round,
    named_streams,
    stage_bump_round,
    stage_mix,
    stage_plan_gossip,
    stage_plan_star,
    stage_star_average,
    stage_train_full,
    train_rows,
    trains_in_place,
)
from repro_torch.kernels import ops
from repro_torch.models import model as model_mod
from repro_torch.models.split import merge_params, split_params
from repro_torch.openworld import make_open_spec, robust_mixer, star_reducer
from repro_torch.optim.sgd import sgd
from repro_torch.utils.pytree import (named_leaves, tree_map,
                                      tree_unflatten_paths)

CENTRAL = ("fedavg", "fedper", "fedbabu")
GOSSIP = ("dfedavgm", "dispfl", "dfedpgp")
STRATEGIES = CENTRAL + GOSSIP + ("pfeddst", "pfeddst_random",
                                  "pfeddst_async")

# FLConfig fields of layers not ported yet, and their ROADMAP queue 1 item
# (every layer of FLConfig is ported)
NOT_PORTED_FIELDS = {}

CENTRAL_STREAMS = ("act", "train")
GOSSIP_STREAMS = ("act", "train", "nbr", "grow")
# dispfl's initial masks draw from their own stream, keyed (seed, 7) as
# the reference folds 7 into its init key
MASK_SEED_SALT = 7


def _opt(fl):
    return sgd(fl.lr, momentum=fl.momentum, weight_decay=fl.weight_decay)


def local_train_steps(name: str, fl, steps_per_epoch: int) -> int:
    """Local SGD steps one client runs in one round of strategy `name`:
    K_e + K_h epochs for the PFedDST family, K_e epochs of the full or
    extractor-only step for every other strategy."""
    epochs = fl.epochs_extractor
    if name.startswith("pfeddst"):
        epochs += fl.epochs_header
    return epochs * steps_per_epoch


@dataclass
class Strategy:
    """The external surface around a StrategySpec: its fields, the
    fabric, and the round function `engine.make_round` builds. The
    simulator runs `round` on both its loops (per round and chunked), so
    a caller may replace it; the copied spec fields do not define the
    round."""
    name: str
    init: Callable             # (seed) -> state
    round: Callable            # (state, data, key, draws=None) -> (state, metrics)
    params_for_eval: Callable  # (state) -> leading-M params
    needs_head_finetune: bool = False
    comm_pattern: str = "p2p"         # "p2p" | "star" (client↔server)
    payload_kind: str = "extractor"   # "extractor" | "model" per message
    payload_fraction: float = 1.0     # share of the payload sent (dispfl)
    fabric: object = None             # comms fabric (None: scalar path)
    stages: tuple = ()                # the round's stages, in order
    key_streams: tuple = ()           # the round's stream layout
    affinity: Callable = None         # (state) -> (M, M) dynamic steering
    versioned: bool = False           # carries a fl.hetero PeerStore
    spec: StrategySpec = None         # the declarative round definition


# ---------------------------------------------------------------------------
# shared init
# ---------------------------------------------------------------------------

def _init_clients(cfg, seed: int, m: int, device):
    """M independent random inits, drawn in order from one generator,
    stacked."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return stack_built(lambda i: model_mod.init_params(cfg, gen, device), m)


def _init_opt(opt, params, m: int):
    """Per-client optimizer states of stacked params, stacked."""
    return stack_built(lambda i: opt.init(client_rows(params, i)), m)


# ---------------------------------------------------------------------------
# centralized family (fedavg / fedper / fedbabu)
# ---------------------------------------------------------------------------

def _init_broadcast(cfg, seed: int, m: int, device) -> dict:
    """One global init (client 0's), broadcast to all M rows — headers
    included; fedper's diverge through local training."""
    first = model_mod.init_params(
        cfg, torch.Generator(device=device).manual_seed(seed), device)
    return tree_map(lambda t: t.expand((m,) + t.shape).clone(), first)


def stage_train_babu(cfg, fl, opt, n_steps: int, *, stream: str = "train"):
    """FedBABU local training: phase-e steps (header frozen) on the
    sampled rows; the optimizer state covers the extractor only."""
    phase = make_phase_steps(cfg, opt)
    in_place = trains_in_place(cfg)

    def local_train_babu(state, ctx):
        e, h = split_params(cfg, state["params"])
        new_e, opt_e, losses = train_rows(
            ctx, phase.phase_e, e, h, state["opt"]["e"], stream, n_steps,
            fl.batch_size, in_place=in_place)
        ctx.metrics["train_loss"] = losses[-1].mean()
        return {**state, "params": merge_params(new_e, h),
                "opt": {"e": opt_e}}

    return local_train_babu


def _central_spec(cfg, fl, steps_per_epoch: int, kind: str, device):
    opt = _opt(fl)
    n_steps = fl.epochs_extractor * steps_per_epoch

    def init(seed: int):
        params = _init_broadcast(cfg, seed, fl.num_clients, device)
        rnd = torch.zeros((), dtype=torch.int32)
        if kind == "fedbabu":   # extractor-only optimizer state
            e, _ = split_params(cfg, params)
            return {"params": params,
                    "opt": {"e": _init_opt(opt, e, fl.num_clients)},
                    "round": rnd}
        return {"params": params,
                "opt": _init_opt(opt, params, fl.num_clients), "round": rnd}

    if kind == "fedbabu":
        train = stage_train_babu(cfg, fl, opt, n_steps)
    else:
        train = stage_train_full(cfg, fl, opt, n_steps)
    share = "model" if kind == "fedavg" else "extractor"
    stages = (stage_plan_star(), train,
              stage_star_average(cfg, share=share,
                                 reducer=star_reducer(fl.threat)),
              stage_bump_round())
    return StrategySpec(
        name=kind, init=init, stages=stages, params_for_eval=_dict_params,
        key_streams=CENTRAL_STREAMS, comm_pattern="star",
        payload_kind=share, needs_head_finetune=(kind == "fedbabu"))


# ---------------------------------------------------------------------------
# decentralized gossip family (dfedavgm / dfedpgp / dispfl)
# ---------------------------------------------------------------------------

def stage_apply_masks(*, in_place: bool = False):
    """DisPFL: project each client's params onto its sparse mask before
    local training (into the params' own tensors with `in_place`)."""

    def apply_masks(state, ctx):
        if in_place:
            tree_map(lambda p, mk: p.mul_(mk.to(p.dtype)), state["params"],
                     state["mask"])
            return state
        params = tree_map(lambda p, mk: p * mk.to(p.dtype), state["params"],
                          state["mask"])
        return {**state, "params": params}

    return apply_masks


def stage_evolve_masks(fl, *, stream: str = "grow", in_place: bool = False):
    """DisPFL mask evolution of every leaf in one `kernels.ops.
    mask_evolve_leaves` call: prune each stacked (M, …) leaf back to its
    `keep` largest magnitudes — one threshold over all M clients' copies,
    as in the reference — regrow where the leaf's bool plane is set
    (uniform > 1 − fl.dispfl_regrow), re-project. The planes come from
    `ctx.draws[stream]` by leaf name (`utils.pytree.named_leaves`), or
    else from a generator on the leaves' device, all drawn first, in the
    reference's leaf order. in_place: the evolved leaves are written into
    the params' tensors and the masks into the planes."""
    sparsity, regrow = fl.dispfl_sparsity, fl.dispfl_regrow

    def evolve_masks(state, ctx):
        params = state["params"]
        items = named_leaves(params)
        planes = ctx.draw(stream)
        gen = None
        if planes is None:
            gen = device_generator(ctx.streams[stream], items[0][1].device)
        grows = []
        for name, leaf in items:
            if gen is None:
                grown = planes[name]
                if not isinstance(grown, torch.Tensor):
                    grown = torch.from_numpy(np.array(grown))
                grows.append(grown.to(leaf.device, torch.bool))
            else:
                grows.append(torch.rand(leaf.shape, generator=gen,
                                        device=leaf.device)
                             > (1.0 - regrow))
        keeps = [max(int(leaf.numel() * (1 - sparsity)), 1)
                 for _, leaf in items]
        done = dict(zip((n for n, _ in items), ops.mask_evolve_leaves(
            [leaf for _, leaf in items], grows, keeps, in_place=in_place)))
        return {**state,
                "params": tree_unflatten_paths(params,
                                               lambda n, _: done[n][0]),
                "mask": tree_unflatten_paths(params,
                                             lambda n, _: done[n][1])}

    return evolve_masks


def _gossip_spec(cfg, fl, steps_per_epoch: int, kind: str, device):
    # a static comms graph (ring, torus, ...) bounds every undirected
    # plan's row degree, so the plan can be packed for the gossip_mix
    # kernel (None without a fabric or under the dynamic topology)
    topo_degree = topology_degree_bound(fl.comms, fl.num_clients)
    opt = _opt(fl)
    n_steps = fl.epochs_extractor * steps_per_epoch

    def init(seed: int):
        params = _init_clients(cfg, seed, fl.num_clients, device)
        state = {"params": params,
                 "opt": _init_opt(opt, params, fl.num_clients),
                 "round": torch.zeros((), dtype=torch.int32)}
        if kind == "dispfl":
            gen = device_generator(named_streams(
                (seed, MASK_SEED_SALT), ("mask",))["mask"], device)
            masks = {n: torch.rand(leaf.shape, generator=gen,
                                   device=device) > fl.dispfl_sparsity
                     for n, leaf in named_leaves(params)}
            state["mask"] = tree_unflatten_paths(params,
                                                 lambda n, _: masks[n])
        return state

    share = "model" if kind == "dfedavgm" else "extractor"
    stages = (stage_plan_gossip(fl, directed=(kind == "dfedpgp"),
                                topo_degree=topo_degree),
              stage_train_full(cfg, fl, opt, n_steps),
              stage_mix(cfg, share=share, mixer=robust_mixer(fl.threat)))
    if kind == "dispfl":
        in_place = trains_in_place(cfg)
        stages = ((stage_apply_masks(in_place=in_place),) + stages
                  + (stage_evolve_masks(fl, in_place=in_place),))
    return StrategySpec(
        name=kind, init=init, stages=stages + (stage_bump_round(),),
        params_for_eval=_dict_params, key_streams=GOSSIP_STREAMS,
        payload_kind=share,
        payload_fraction=(1.0 - fl.dispfl_sparsity if kind == "dispfl"
                          else 1.0))


# ---------------------------------------------------------------------------
# PFedDST (+ random-selection ablation)
# ---------------------------------------------------------------------------

def _pfeddst_spec(cfg, fl, steps_per_epoch: int, name: str, device):
    opt = _opt(fl)
    hetero = None
    if name == "pfeddst_random":
        fl = dataclasses.replace(fl, selection="random")
    elif name == "pfeddst_async":
        hetero = make_hetero_runtime(
            fl, fl.num_clients, local_train_steps(name, fl, steps_per_epoch))
    stages = make_pfeddst_stages(
        cfg, fl, make_phase_steps(cfg, opt), steps_per_epoch=steps_per_epoch,
        probe_size=fl.probe_size, use_score_kernel=fl.use_score_kernel,
        hetero=hetero)

    def init(seed: int):
        gen = torch.Generator(device=device).manual_seed(seed)
        state = init_population(cfg, gen, fl.num_clients, opt, opt, device)
        if hetero is not None:
            state = state._replace(store=init_peer_store(
                {"e": state.extractor, "h": state.header}, hetero.depth))
        return state

    # a dynamic topology steers toward the peers the loss array l marked
    # informative last round (Algorithm 1's context)
    return StrategySpec(
        name=name, init=init, stages=stages,
        params_for_eval=_pfeddst_params, key_streams=PFEDDST_STREAMS,
        affinity=lambda state: state.loss_matrix,
        versioned=hetero is not None)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

def make_spec(name: str, cfg, fl, steps_per_epoch: int = 2, *,
              device="cuda") -> StrategySpec:
    """The declarative spec of a registered strategy (the engine's input),
    its init building the state on `device` (default CUDA; raises without
    it).

    With fl.threat / fl.churn configured, the spec is wrapped by
    `openworld.make_open_spec` (churn, byzantine and score-gaming
    adversaries, isolation telemetry); inert or absent configs return the
    unwrapped spec object itself."""
    if name not in STRATEGIES:
        raise KeyError(f"unknown strategy {name!r}; available: {STRATEGIES}")
    for field, item in NOT_PORTED_FIELDS.items():
        if getattr(fl, field) is not None:
            raise NotImplementedError(
                f"FLConfig.{field} is not ported yet (ROADMAP queue 1 item "
                f"{item})")
    device = resolve_device(device)
    build = (_central_spec if name in CENTRAL else
             _gossip_spec if name in GOSSIP else _pfeddst_spec)
    return make_open_spec(build(cfg, fl, steps_per_epoch, name, device), fl,
                          device=device)


def make_strategy(name: str, cfg, fl, steps_per_epoch: int = 2, *,
                  device="cuda") -> Strategy:
    """The strategy `name` on `device` (default CUDA; raises without it):
    `make_spec`, the comms fabric of `fl.comms` on the same device (its
    links scaled by a `device_profile`'s channel rates) and
    `engine.make_round` over both."""
    device = resolve_device(device)
    spec = make_spec(name, cfg, fl, steps_per_epoch, device=device)
    # deterministic in (profile, M): the hetero runtime and the simulator
    # derive the same vectors from the same inputs
    rates = (None if fl.device_profile is None else
             sample_device_vectors(fl.device_profile,
                                   fl.num_clients).channel_rate)
    fabric = make_fabric(fl.comms, fl.num_clients, cost_scale=fl.comm_cost,
                         channel_rate=rates, device=device)
    if hasattr(fabric, "round_slots") and spec.comm_pattern != "p2p":
        raise ValueError(
            f"CommsConfig(sparse=True) models peer-to-peer links only; "
            f"strategy {name!r} uses comm_pattern={spec.comm_pattern!r}. "
            "Centralized baselines need the dense fabric (sparse=False) "
            "for star accounting.")
    if not spec.versioned:
        # the reference's warnings: only a versioned strategy honours a
        # staleness lag, and only pfeddst_async runs the deadline gate
        if (fl.comms is not None and fl.comms.stale_mode == "serve"
                and fl.comms.p_stale > 0):
            warnings.warn(
                f"CommsConfig(stale_mode='serve', p_stale="
                f"{fl.comms.p_stale}) with non-versioned strategy "
                f"{name!r}: stale peers stay selectable but serve their "
                "LIVE parameters (no peer store); staleness events will "
                "not affect the optimization. Use 'pfeddst_async' or "
                "stale_mode='drop' for real staleness semantics.",
                stacklevel=2)
        if 0 < fl.deadline_s < math.inf:
            warnings.warn(
                f"FLConfig(deadline_s={fl.deadline_s}) is ignored by "
                f"non-versioned strategy {name!r}: only 'pfeddst_async' "
                "runs the semi-async deadline gate; this strategy runs "
                "fully synchronous rounds.",
                stacklevel=2)
    return Strategy(
        name=spec.name, init=spec.init, round=make_round(spec, fl, fabric),
        params_for_eval=spec.params_for_eval,
        needs_head_finetune=spec.needs_head_finetune,
        comm_pattern=spec.comm_pattern, payload_kind=spec.payload_kind,
        payload_fraction=spec.payload_fraction, fabric=fabric,
        stages=spec.stages, key_streams=spec.key_streams,
        affinity=spec.affinity, versioned=spec.versioned, spec=spec)


def _dict_params(state):
    return state["params"]


def _pfeddst_params(state):
    return merge_params(state.extractor, state.header)
