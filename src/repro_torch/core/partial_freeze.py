"""Two-phase partial-freeze training (paper Eq. 3–4, Algorithm 1 lines
8–16), reference `repro.core.partial_freeze`.

Phase e: header frozen, extractor trained   (Eq. 3)
Phase h: extractor frozen, header trained   (Eq. 4)

`make_full_step` is the conventional step of the baselines: the whole
model trained.

Freezing is structural, as in the reference: the frozen partition enters
the loss detached, so autograd builds no backward for it, and only the
trained partition is passed to `torch.autograd.grad`. The gradient is
that of `loss_fn`'s total (the task loss plus the MoE aux terms, as the
reference's `value_and_grad(..., has_aux=True)`); a leaf the loss does
not reach (`vision_proj` without a prefix) gets a zero gradient, as in
jax. Each phase keeps its own optimizer state.

A step called with `in_place=True` writes the trained partition and the
optimizer state into the tensors it was given (typically views of one
client's rows of the population), leaf by leaf, and returns those same
trees: the values are bitwise the functional step's, but only one
leaf's update is alive at a time. That is how a population of LLMs too
large to copy trains (`fl.engine.train_rows`).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.models import model as model_mod
from repro_torch.models.split import merge_params
from repro_torch.optim.base import Optimizer, apply_updates
from repro_torch.utils.pytree import tree_leaves, tree_map, tree_paths


class PhaseSteps(NamedTuple):
    phase_e: Callable  # (extractor, header, opt_e, batch) -> (e, opt_e, metrics)
    phase_h: Callable  # (extractor, header, opt_h, batch) -> (h, opt_h, metrics)


def _grads(cfg, trained, frozen, batch, backend, remat):
    """→ (grads shaped as `trained`, detached metrics)."""
    live = tree_map(lambda t: t.detach().requires_grad_(True), trained)
    fixed = tree_map(lambda t: t.detach(), frozen)
    leaves = tree_leaves(live)
    with torch.enable_grad():
        total, metrics = model_mod.loss_fn(cfg, merge_params(live, fixed),
                                           batch, backend=backend,
                                           remat=remat)
        grads = torch.autograd.grad(total, leaves, allow_unused=True,
                                    materialize_grads=True)
    it = iter(grads)
    return (tree_map(lambda _: next(it), live),
            {k: v.detach() for k, v in metrics.items()})


def _update_in_place(opt: Optimizer, grads, opt_state, trained):
    """`opt.update` + `apply_updates` leaf by leaf, each result copied into
    `trained`'s and `opt_state`'s tensors."""
    tensors = {k: v for k, v in opt_state.items()
               if isinstance(v, torch.Tensor)}
    trees = {k: dict(tree_paths(v)) for k, v in opt_state.items()
             if k not in tensors}
    params = dict(tree_paths(trained))
    new_tensors = None
    for path, g in tree_paths(grads):
        p = params[path]
        sub = {k: {"x": t[path]} for k, t in trees.items()}
        sub.update(tensors)
        upd, new = opt.update({"x": g}, sub, {"x": p})
        p.copy_(p + upd["x"].to(p.dtype))
        for k, t in trees.items():
            t[path].copy_(new[k]["x"])
        new_tensors = {k: new[k] for k in tensors}
        del upd, new, sub
    for k, t in (new_tensors or {}).items():
        tensors[k].copy_(t)
    return trained, opt_state


def _train_step(cfg, opt: Optimizer, trained, frozen, opt_state, batch, *,
                backend="auto", remat=False, in_place=False):
    grads, metrics = _grads(cfg, trained, frozen, batch, backend, remat)
    if in_place:
        trained, opt_state = _update_in_place(opt, grads, opt_state, trained)
        return trained, opt_state, metrics
    updates, opt_state = opt.update(grads, opt_state, trained)
    return apply_updates(trained, updates), opt_state, metrics


def make_phase_steps(cfg, opt_e: Optimizer, opt_h: Optimizer | None = None,
                     *, backend: str = "auto",
                     remat: bool = False) -> PhaseSteps:
    """One client's phase-e / phase-h step (unstacked parameters); each
    takes `in_place=` (module docstring)."""
    opt_h = opt_h or opt_e
    kw = dict(backend=backend, remat=remat)

    def phase_e(extractor, header, opt_state, batch, *, in_place=False):
        return _train_step(cfg, opt_e, extractor, header, opt_state, batch,
                           in_place=in_place, **kw)

    def phase_h(extractor, header, opt_state, batch, *, in_place=False):
        return _train_step(cfg, opt_h, header, extractor, opt_state, batch,
                           in_place=in_place, **kw)

    return PhaseSteps(phase_e=phase_e, phase_h=phase_h)


def make_full_step(cfg, opt: Optimizer, *, backend: str = "auto",
                   remat: bool = False) -> Callable:
    """One client's conventional (non-frozen) step, the FedAvg-family and
    gossip baselines' local training: (params, opt_state, batch, *,
    in_place=False) -> (params, opt_state, metrics), unstacked
    parameters."""

    def step(params, opt_state, batch, *, in_place=False):
        return _train_step(cfg, opt, params, {}, opt_state, batch,
                           backend=backend, remat=remat, in_place=in_place)

    return step
