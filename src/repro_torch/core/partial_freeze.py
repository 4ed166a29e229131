"""Two-phase partial-freeze training (paper Eq. 3–4, Algorithm 1 lines
8–16), reference `repro.core.partial_freeze`.

Phase e: header frozen, extractor trained   (Eq. 3)
Phase h: extractor frozen, header trained   (Eq. 4)

`make_full_step` is the conventional step of the baselines: the whole
model trained.

Freezing is structural, as in the reference: the frozen partition enters
the loss detached, so autograd builds no backward for it, and only the
trained partition is passed to `torch.autograd.grad`. Each phase keeps
its own optimizer state.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.models import model as model_mod
from repro_torch.models.split import merge_params
from repro_torch.optim.base import Optimizer, apply_updates


class PhaseSteps(NamedTuple):
    phase_e: Callable  # (extractor, header, opt_e, batch) -> (e, opt_e, metrics)
    phase_h: Callable  # (extractor, header, opt_h, batch) -> (h, opt_h, metrics)


def _train_step(cfg, opt: Optimizer, trained: dict, frozen: dict, opt_state,
                batch):
    live = {n: t.detach().requires_grad_(True) for n, t in trained.items()}
    fixed = {n: t.detach() for n, t in frozen.items()}
    with torch.enable_grad():
        _, metrics = model_mod.loss_fn(cfg, merge_params(live, fixed), batch)
        grads = torch.autograd.grad(metrics["loss"], list(live.values()))
    updates, opt_state = opt.update(dict(zip(live, grads)), opt_state,
                                    trained)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return apply_updates(trained, updates), opt_state, metrics


def make_phase_steps(cfg, opt_e: Optimizer,
                     opt_h: Optimizer | None = None) -> PhaseSteps:
    """One client's phase-e / phase-h SGD step (unstacked parameters)."""
    opt_h = opt_h or opt_e

    def phase_e(extractor, header, opt_state, batch):
        return _train_step(cfg, opt_e, extractor, header, opt_state, batch)

    def phase_h(extractor, header, opt_state, batch):
        return _train_step(cfg, opt_h, header, extractor, opt_state, batch)

    return PhaseSteps(phase_e=phase_e, phase_h=phase_h)


def make_full_step(cfg, opt: Optimizer) -> Callable:
    """One client's conventional (non-frozen) SGD step, the FedAvg-family
    and gossip baselines' local training: (params, opt_state, batch) ->
    (params, opt_state, metrics), unstacked parameters."""

    def step(params, opt_state, batch):
        return _train_step(cfg, opt, params, {}, opt_state, batch)

    return step
