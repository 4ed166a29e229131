"""make_open_spec — wrap any StrategySpec with churn and adversaries,
reference `repro.openworld.compose`.

The open world composes onto a strategy's spec (`fl.engine.StrategySpec`,
built by `fl.strategies.make_spec`) without the strategy knowing: the
wrapped state is
`{"inner": <strategy state>, "alive": (M,) bool}`, every stage is lifted
to act on `state["inner"]` (keeping its `stage_name`, so stage profiles
and the byzantine insertion point see the original names), and the
open-world stages slot around them:

    ow_churn        membership update + newcomer bootstrap (lifecycle)
    ow_threat       publish the ThreatState into ctx.threat (attacks)
    ow_snapshot     record the pre-round parameters (byzantine only)
    <inner stages>  with ow_byzantine right after the last train-like
                    stage (attacks.TRAIN_STAGE_NAMES)
    ow_metrics      attacker-isolation telemetry from the round's plan

THE IDENTITY GUARANTEE: with neither churn nor an adversary cast (configs
absent, or present but inert) `make_open_spec` returns the very spec
object it was given (same init, same stages), so every closed run stays
bit for bit what it was. The wrapper adds no stream to the spec's
layout: churn and the gaussian attack key their own generators by the
round key and a salt (`fl.engine.salted_streams`).
Defenses do not wrap: they are wired when the stages are built, through
the engine's reducer/mixer hooks and the PFedDST aggregate stage.
"""
from __future__ import annotations

from dataclasses import replace

import torch

from repro_torch.device import resolve_device
from repro_torch.obs.timers import stage_name
from repro_torch.openworld.attacks import (
    TRAIN_STAGE_NAMES,
    ThreatState,
    adversary_mask,
    stage_byzantine,
    stage_snapshot,
    stage_threat,
)
from repro_torch.openworld.lifecycle import (
    init_alive,
    population_params,
    stage_churn,
    with_population_params,
)
from repro_torch.openworld.metrics import stage_openworld_metrics
from repro_torch.utils.pytree import tree_leaves


def _lift(stage):
    """Run an inner-state stage against the wrapper's "inner" entry."""

    def lifted(state, ctx):
        return {**state, "inner": stage(state["inner"], ctx)}

    lifted.stage_name = stage_name(stage)
    return lifted


def _casts(threat) -> bool:
    """Whether `threat` has an adversary cast with something to do."""
    return not (threat is None or threat.adversary_fraction <= 0.0
                or (threat.attack == "none" and threat.score_game == "none"))


def threat_state(threat, m: int, device="cuda"):
    """ThreatConfig → ThreatState with the cast on `device` (default CUDA;
    raises without it), or None when there is no adversary cast (zero
    fraction, or nothing for it to do)."""
    if not _casts(threat):
        return None
    return ThreatState(
        adversaries=torch.from_numpy(adversary_mask(
            m, threat.adversary_fraction, threat.seed)).to(
                resolve_device(device)),
        attack=threat.attack, attack_scale=threat.attack_scale,
        noise_std=threat.noise_std, score_game=threat.score_game,
        cost_gain=threat.cost_gain)


def _state_device(state):
    """The device of a strategy state's tensors (its first leaf)."""
    return tree_leaves(state)[0].device


def make_open_spec(spec, fl, *, device=None):
    """Wrap `spec` per `fl.threat` / `fl.churn` → a StrategySpec. Returns
    `spec` itself, not a copy, when there is nothing to do; else a spec
    with a wrapped init (`{"inner", "alive"}`, alive on the inner state's
    device), the lifted stages, and a `params_for_eval` and `affinity`
    that unwrap the state. The adversary cast lives on `device`; None
    means the card (`resolve_device`: raises without one), as every entry
    point of the port defaults to it (`strategies.make_spec` passes its
    own device)."""
    churn = fl.churn if fl.churn is not None and not fl.churn.inert \
        else None
    if churn is None and not _casts(fl.threat):
        return spec
    device = resolve_device("cuda" if device is None else device)
    tstate = threat_state(fl.threat, fl.num_clients, device)

    stages = spec.stages
    lifted = [_lift(s) for s in stages]
    if tstate is not None and tstate.attack != "none":
        train_at = [i for i, s in enumerate(stages)
                    if stage_name(s) in TRAIN_STAGE_NAMES]
        if not train_at:
            raise ValueError(f"spec {spec.name!r} has no train-like stage "
                             f"({TRAIN_STAGE_NAMES}) to corrupt after")
        lifted.insert(train_at[-1] + 1, _lift(stage_byzantine(
            tstate, population_params, with_population_params)))
        lifted.insert(0, _lift(stage_snapshot(population_params)))
    if tstate is not None:
        lifted.insert(0, stage_threat(tstate))
        lifted.append(stage_openworld_metrics(tstate))
    if churn is not None:
        lifted.insert(0, stage_churn(churn))

    inner_init = spec.init
    inner_eval = spec.params_for_eval
    inner_affinity = spec.affinity
    alive0 = init_alive(fl.num_clients, churn)

    def open_init(seed):
        inner = inner_init(seed)
        return {"inner": inner,
                "alive": torch.from_numpy(alive0).to(_state_device(inner))}

    kwargs = dict(init=open_init, stages=tuple(lifted),
                  params_for_eval=lambda state: inner_eval(state["inner"]))
    if inner_affinity is not None:
        kwargs["affinity"] = lambda state: inner_affinity(state["inner"])
    return replace(spec, **kwargs)
