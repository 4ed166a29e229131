"""Attacker-isolation telemetry — does selection route around
adversaries? Reference `repro.openworld.metrics`.

    adv_edge_frac   fraction of HONEST ACTIVE clients' selected edges
                    that point at an adversary this round
    adv_base_frac   the same clients' CANDIDATE peers that are
                    adversaries (what uniform selection would hit)
    adv_isolation   1 − adv_edge_frac / adv_base_frac: 1 → adversaries
                    shunned; 0 → no better than random; < 0 → preferred

Adversary rows are excluded on both sides, and star plans have no
selection to judge: the stage records nothing for them. The scalars stay
on the device (`ctx.record`) until the simulator reads them.
"""
from __future__ import annotations

import torch


def isolation_metrics(edges, cand, adversaries, active, m: int) -> dict:
    """→ the three isolation scalars (f32 0-d tensors).

    edges  (M, M) bool selected pulls (row i pulls column j)
    cand   (M, M) bool reachable-peer mask (None → all but self)"""
    if cand is None:
        cand = ~torch.eye(m, dtype=torch.bool, device=edges.device)
    honest_rows = (~adversaries) & active
    sel = edges & honest_rows[:, None]
    n_sel = sel.sum().float()
    frac = (sel & adversaries[None, :]).sum() / n_sel.clamp_min(1.0)
    reach = cand & honest_rows[:, None]
    n_reach = reach.sum().float()
    base = (reach & adversaries[None, :]).sum() / n_reach.clamp_min(1.0)
    isolation = torch.where(base > 0.0,
                            1.0 - frac / base.clamp_min(1e-8), 0.0)
    return {"adv_edge_frac": frac.float(),
            "adv_base_frac": base.float(),
            "adv_isolation": isolation.float()}


def stage_openworld_metrics(tstate):
    """Record the isolation scalars from the round's plan (the last
    wrapped stage). No-op on star plans."""
    adv = tstate.adversaries

    def ow_metrics(state, ctx):
        plan = ctx.plan
        if plan is None or plan.pattern != "p2p" or plan.edges is None:
            return state
        for name, val in isolation_metrics(plan.edges, ctx.cand, adv,
                                           ctx.active, ctx.m).items():
            ctx.record(name, val)
        return state

    return ow_metrics
