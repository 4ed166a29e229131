"""make_open_spec — wrap a strategy's stages with churn and adversaries,
reference `repro.openworld.compose`.

The port has no StrategySpec: a strategy is the `(init, stages, streams,
meta)` its spec builder returns (`fl.strategies`), with `meta` carrying
`params_for_eval` and, where there is one, `affinity`. The open world
composes onto it without the strategy knowing: the wrapped state is
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
absent, or present but inert) `make_open_spec` returns the very objects
it was given, so every closed run stays bit for bit what it was.
Defenses do not wrap: they are wired when the stages are built, through
the engine's reducer/mixer hooks and the PFedDST aggregate stage.
"""
from __future__ import annotations

import torch

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


def _lift(stage):
    """Run an inner-state stage against the wrapper's "inner" entry."""

    def lifted(state, ctx):
        return {**state, "inner": stage(state["inner"], ctx)}

    lifted.stage_name = stage_name(stage)
    return lifted


def threat_state(threat, m: int, device="cpu"):
    """ThreatConfig → ThreatState with the cast on `device`, or None when
    there is no adversary cast (zero fraction, or nothing for it to do)."""
    if threat is None or threat.adversary_fraction <= 0.0:
        return None
    if threat.attack == "none" and threat.score_game == "none":
        return None
    return ThreatState(
        adversaries=torch.from_numpy(adversary_mask(
            m, threat.adversary_fraction, threat.seed)).to(device),
        attack=threat.attack, attack_scale=threat.attack_scale,
        noise_std=threat.noise_std, score_game=threat.score_game,
        cost_gain=threat.cost_gain)


def make_open_spec(init, stages, meta, fl, *, device="cpu"):
    """Wrap a strategy per `fl.threat` / `fl.churn` → (init, stages,
    meta). Returns the given objects themselves when there is nothing to
    do; else a wrapped init (`{"inner", "alive"}` on `device`), the
    lifted stages and a new meta whose `params_for_eval` and `affinity`
    unwrap the state."""
    churn = fl.churn if fl.churn is not None and not fl.churn.inert \
        else None
    tstate = threat_state(fl.threat, fl.num_clients, device)
    if churn is None and tstate is None:
        return init, stages, meta

    lifted = [_lift(s) for s in stages]
    if tstate is not None and tstate.attack != "none":
        train_at = [i for i, s in enumerate(stages)
                    if stage_name(s) in TRAIN_STAGE_NAMES]
        if not train_at:
            raise ValueError(f"the stages {[stage_name(s) for s in stages]}"
                             f" have no train-like stage "
                             f"({TRAIN_STAGE_NAMES}) to corrupt after")
        lifted.insert(train_at[-1] + 1, _lift(stage_byzantine(
            tstate, population_params, with_population_params)))
        lifted.insert(0, _lift(stage_snapshot(population_params)))
    if tstate is not None:
        lifted.insert(0, stage_threat(tstate))
        lifted.append(stage_openworld_metrics(tstate))
    if churn is not None:
        lifted.insert(0, stage_churn(churn))

    alive0 = init_alive(fl.num_clients, churn)

    def open_init(seed):
        return {"inner": init(seed),
                "alive": torch.from_numpy(alive0).to(device)}

    inner_eval = meta["params_for_eval"]
    meta = {**meta, "params_for_eval": lambda state: inner_eval(
        state["inner"])}
    inner_affinity = meta.get("affinity")
    if inner_affinity is not None:
        meta["affinity"] = lambda state: inner_affinity(state["inner"])
    return open_init, tuple(lifted), meta
