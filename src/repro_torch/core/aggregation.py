"""Extractor aggregation across the client axis (Algorithm 1 line 6),
reference `repro.core.aggregation`:

    e_i ← Σ_{j ∈ M_i ∪ {i}} w_ij · e_j,   w row-stochastic,

the semi-async rounds' staleness-discounted weights (`staleness_weights`)
and the centralized baselines' server mean (`mean_over_active`).
"""
from __future__ import annotations

import torch


def selection_to_weights(select_mask, *, include_self: bool = True,
                         data_fractions=None, column_scale=None):
    """bool (M, M) → row-stochastic float32 (M, M) weights (simple
    average over the selected peers and, by default, the client itself).

    data_fractions: optional (M,) n_j weights (Eq. 5). column_scale:
    optional (M,) per-column scale applied before the row normalisation
    that exempts the diagonal (a client's own contribution is never
    scaled): the hook `staleness_weights` discounts stale peers through.
    Both None leave the arithmetic that of the unscaled path."""
    m = select_mask.shape[0]
    w = select_mask.float()
    if include_self:
        w = torch.maximum(w, torch.eye(m, device=w.device))
    if column_scale is not None:
        eye = torch.eye(m, dtype=torch.bool, device=w.device)
        w = w * torch.where(eye, 1.0, column_scale[None, :].float())
    if data_fractions is not None:
        w = w * data_fractions[None, :]
    return w / w.sum(dim=1, keepdim=True).clamp_min(1e-12)


def staleness_weights(select_mask, lag, *, alpha: float,
                      include_self: bool = True, data_fractions=None):
    """Row-stochastic mixing weights with the polynomial staleness
    discount of semi-async aggregation (`fl.hetero`): column j scaled by
    `(1 + lag_j)^(−alpha)` before the row normalisation, the diagonal
    never. With lag 0 everywhere the discount is exactly 1.0 and the
    result is bit for bit `selection_to_weights(mask, include_self=True)`,
    which pfeddst_async's synchronous equivalence rests on."""
    discount = torch.pow(1.0 + lag.float(), -alpha)
    return selection_to_weights(select_mask, include_self=include_self,
                                data_fractions=data_fractions,
                                column_scale=discount)


def aggregate_extractors(stacked_extractor: dict, weights) -> dict:
    """e_i ← Σ_j w_ij e_j per leaf, in float32, cast back to the leaf's
    dtype. stacked_extractor: dict of (M, ...) tensors."""
    wf = weights.float()
    out = {}
    for name, leaf in stacked_extractor.items():
        mixed = wf @ leaf.reshape(leaf.shape[0], -1).float()
        out[name] = mixed.reshape(leaf.shape).to(leaf.dtype)
    return out


def mean_over_active(tree: dict, active) -> dict:
    """Server step of the FedAvg family: the uniform f32 average of the
    active clients' leaves, cast back to each leaf's dtype and broadcast
    to all M rows. All-zero when no client is active; callers guard with
    `fl.engine.keep_if_none_active`."""
    w = active.float()
    w = w / w.sum().clamp_min(1.0)
    out = {}
    for name, leaf in tree.items():
        avg = (w @ leaf.reshape(leaf.shape[0], -1).float()).to(leaf.dtype)
        out[name] = avg.reshape(leaf.shape[1:]).expand(leaf.shape).clone()
    return out
