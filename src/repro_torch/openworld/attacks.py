"""Adversary models — byzantine updates and score-integrity gaming,
reference `repro.openworld.attacks`.

Both families are keyed to a static per-client adversary mask
(`adversary_mask`, drawn once from ThreatConfig.seed with numpy, bitwise
the reference's cast):

* BYZANTINE UPDATE CORRUPTION — `stage_snapshot` records the round-start
  parameters into `ctx.aux["ow_pre"]`, and `stage_byzantine` (placed right
  after the last train-like stage, so corruption hits what peers
  aggregate) replaces each active adversary's update `delta = post − pre`
  with

      sign_flip   pre − scale·delta
      scale       pre + scale·delta
      gaussian    post + noise_std·N(0, I)

  The corrupted parameters persist in the adversary's own row, as in the
  reference.

* SCORE GAMING — `ThreatState.game_scores`, which the PFedDST scorer
  (`core.rounds.score_select`) applies to the header view and the cost
  before Eq. 7–9: an adversary publishes the anti-aligned header
  −mean(honest headers) (Eq. 9 subtracts the similarity) and claims the
  best link cost in the fleet × cost_gain as its column of c.

Randomness: the gaussian noise is model-sized, so it is drawn on the
parameters' device from a generator keyed by the round key and
`BYZ_SALT` (`fl.engine.salted_streams`), apart from every strategy
stream; `ctx.draws["byz"]` ({leaf: noise}, by `tree_paths` name)
replaces it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from repro_torch.fl.engine import (
    device_generator,
    salted_streams,
    where_tree,
)
from repro_torch.utils.pytree import tree_paths, tree_unflatten_paths

ATTACKS = ("none", "sign_flip", "gaussian", "scale")
SCORE_GAMES = ("none", "header", "cost", "both")

# stages whose output is a finished local update: the byzantine
# corruption point is after the last of these in the wrapped stages
TRAIN_STAGE_NAMES = ("local_train", "local_train_babu", "phase_h")

BYZ_SALT = 0x627A                        # 'bz', the reference's salt


def adversary_mask(m: int, fraction: float, seed: int = 0) -> np.ndarray:
    """(M,) bool — round(fraction·M) adversaries at uniform positions
    (numpy `default_rng(seed).permutation`, the reference's draw)."""
    k = int(round(m * max(0.0, min(1.0, fraction))))
    mask = np.zeros((m,), dtype=bool)
    if k > 0:
        rng = np.random.default_rng(seed)
        mask[rng.permutation(m)[:k]] = True
    return mask


@dataclass(frozen=True)
class ThreatState:
    """The run's threat cast: who is adversarial and how they lie.
    `adversaries` is the (M,) bool tensor of `adversary_mask`, on the
    round's device."""
    adversaries: Any
    attack: str = "none"
    attack_scale: float = 1.0
    noise_std: float = 1.0
    score_game: str = "none"
    cost_gain: float = 1.0

    def game_scores(self, flat, cost, m: int):
        """Spoof the scorer's inputs → (flat', cost').

        flat  (M, P) flattened header view (before normalisation: the
              fused and the dense routes both normalise downstream).
        cost  scalar or (M, M) Eq. 9 c. Untouched (the same object)
              unless cost gaming is on; then materialised as an f32
              (M, M) with the adversary columns at max(c)·cost_gain."""
        adv = self.adversaries
        if self.score_game in ("header", "both"):
            honest = ~adv
            n_h = honest.sum().clamp_min(1)
            mean_h = torch.where(honest[:, None], flat.float(),
                                 0.0).sum(dim=0) / n_h
            spoof = (-mean_h).to(flat.dtype)
            flat = torch.where(adv[:, None], spoof[None], flat)
        if self.score_game in ("cost", "both"):
            if isinstance(cost, torch.Tensor):
                cmat = cost.to(adv.device, torch.float32).expand(m, m)
            else:
                cmat = torch.full((m, m), float(cost), dtype=torch.float32,
                                  device=adv.device)
            best = cmat.max()
            cost = torch.where(adv[None, :], best * self.cost_gain, cmat)
        return flat, cost


def stage_threat(tstate: ThreatState):
    """Publish the threat cast into the round context (before the inner
    stages) and record how many adversaries are active this round."""

    def ow_threat(state, ctx):
        ctx.threat = tstate
        ctx.record("adv_active_n",
                   (tstate.adversaries & ctx.active).sum().to(torch.int32))
        return state

    return ow_threat


def stage_snapshot(get_params):
    """Record the round-start parameter view into `ctx.aux["ow_pre"]`,
    the `pre` of the byzantine delta. The view holds the live parameter
    tensors, which the stages up to the corruption replace and never
    write in place (`scatter_rows` returns new tensors; the peer store's
    in-place publish writes the store's own slots)."""

    def ow_snapshot(state, ctx):
        ctx.aux["ow_pre"] = get_params(state)
        return state

    return ow_snapshot


def gaussian_noise(ctx, post):
    """{leaf path: standard normal of the leaf's shape, f32, on its
    device}: `ctx.draws["byz"]`, else drawn in `tree_paths` order from a
    device generator keyed by the round key and BYZ_SALT."""
    leaves = tree_paths(post)
    injected = ctx.draw("byz")
    if injected is not None:
        return {p: torch.as_tensor(np.array(injected[p])).to(
            x.device, torch.float32) for p, x in leaves}
    device = leaves[0][1].device
    gen = device_generator(
        salted_streams(ctx.key, BYZ_SALT, ("byz",))["byz"], device)
    return {p: torch.randn(x.shape, generator=gen, device=device)
            for p, x in leaves}


def stage_byzantine(tstate: ThreatState, get_params, set_params):
    """Corrupt each ACTIVE adversary's finished local update (see the
    module docstring). Honest rows and inactive adversaries pass through
    bit for bit."""
    attack = tstate.attack
    if attack not in ATTACKS or attack == "none":
        raise ValueError(f"stage_byzantine needs an attack in "
                         f"{ATTACKS[1:]}, got {attack!r}")

    def ow_byzantine(state, ctx):
        pre = ctx.aux.pop("ow_pre")
        post = get_params(state)
        if attack == "gaussian":
            noise = gaussian_noise(ctx, post)
            corrupted = tree_unflatten_paths(
                post, lambda p, x: x + (tstate.noise_std
                                        * noise[p]).to(x.dtype))
        else:
            sgn = (-tstate.attack_scale if attack == "sign_flip"
                   else tstate.attack_scale)
            pre_of = dict(tree_paths(pre))

            def corrupt(p, q):
                pf = pre_of[p].float()
                return (pf + sgn * (q.float() - pf)).to(q.dtype)

            corrupted = tree_unflatten_paths(post, corrupt)
        mask = tstate.adversaries & ctx.active
        return set_params(state, where_tree(mask, corrupted, post))

    return ow_byzantine
