"""Extractor aggregation across the client axis (Algorithm 1 line 6),
reference `repro.core.aggregation`:

    e_i ← Σ_{j ∈ M_i ∪ {i}} w_ij · e_j,   w row-stochastic.
"""
from __future__ import annotations

import torch


def selection_to_weights(select_mask, *, include_self: bool = True):
    """bool (M, M) → row-stochastic float32 (M, M) weights (simple
    average over the selected peers and, by default, the client itself)."""
    m = select_mask.shape[0]
    w = select_mask.float()
    if include_self:
        w = torch.maximum(w, torch.eye(m, device=w.device))
    return w / w.sum(dim=1, keepdim=True).clamp_min(1e-12)


def aggregate_extractors(stacked_extractor: dict, weights) -> dict:
    """e_i ← Σ_j w_ij e_j per leaf, in float32, cast back to the leaf's
    dtype. stacked_extractor: dict of (M, ...) tensors."""
    wf = weights.float()
    out = {}
    for name, leaf in stacked_extractor.items():
        mixed = wf @ leaf.reshape(leaf.shape[0], -1).float()
        out[name] = mixed.reshape(leaf.shape).to(leaf.dtype)
    return out
