"""Extractor aggregation across the client axis (Algorithm 1 line 6),
reference `repro.core.aggregation`:

    e_i ← Σ_{j ∈ M_i ∪ {i}} w_ij · e_j,   w row-stochastic,

the semi-async rounds' staleness-discounted weights (`staleness_weights`)
and the centralized baselines' server mean (`mean_over_active`).
"""
from __future__ import annotations

import torch

from repro_torch.utils.pytree import tree_map


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


# columns of an (M, ·) float32 copy made at once, by the extractor mix
# here and by `fl.engine.mix_tree`'s packed gossip_mix blocks: every cnn
# leaf and a cnn's whole packed tree (11.2 M columns for ResNet-18) in one
# piece; an LLM's (1.5e9 columns for qwen2-1.5b's extractor, a 24.7 GB f32
# copy at M = 4) in pieces of 1.07 GB each at M = 4
F32_BLOCK_COLUMNS = 1 << 26


def aggregate_extractors(stacked_extractor, weights):
    """e_i ← Σ_j w_ij e_j per leaf, in float32, cast back to the leaf's
    dtype (a leaf wider than F32_BLOCK_COLUMNS a column slice at a time).
    stacked_extractor: a tree of (M, ...) tensors."""
    wf = weights.float()

    def mix(leaf):
        flat = leaf.reshape(leaf.shape[0], -1)
        if flat.shape[1] <= F32_BLOCK_COLUMNS:
            return (wf @ flat.float()).reshape(leaf.shape).to(leaf.dtype)
        out = torch.empty_like(flat)
        for c0 in range(0, flat.shape[1], F32_BLOCK_COLUMNS):
            c1 = c0 + F32_BLOCK_COLUMNS
            out[:, c0:c1] = (wf @ flat[:, c0:c1].float()).to(leaf.dtype)
        return out.reshape(leaf.shape)

    return tree_map(mix, stacked_extractor)


def mean_over_active(tree, active):
    """Server step of the FedAvg family: the uniform f32 average of the
    active clients' leaves, cast back to each leaf's dtype and broadcast
    to all M rows. All-zero when no client is active; callers guard with
    `fl.engine.keep_if_none_active`."""
    w = active.float()
    w = w / w.sum().clamp_min(1.0)

    def avg(leaf):
        a = (w @ leaf.reshape(leaf.shape[0], -1).float()).to(leaf.dtype)
        return a.reshape(leaf.shape[1:]).expand(leaf.shape).clone()

    return tree_map(avg, tree)
