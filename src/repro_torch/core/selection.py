"""Eq. 9 score combination + strategic peer selection (paper §II-B/C),
reference `repro.core.selection`.

    S = s_p · (α·s_l − s_d + c)
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ref import stable_topk

NEG = -1e30


def as_cost_matrix(comm_cost, m: int, device=None):
    """The Eq. 9 `c` term as an (M, M) float32 matrix: the paper's scalar
    or a per-link (M, M) matrix."""
    c = torch.as_tensor(comm_cost, dtype=torch.float32, device=device)
    if c.dim() == 0:
        return c.expand(m, m)
    if tuple(c.shape) != (m, m):
        raise ValueError(f"comm_cost must be a scalar or ({m}, {m}) matrix, "
                         f"got shape {tuple(c.shape)}")
    return c


def combined_scores(s_l, s_d, s_p, *, alpha: float, comm_cost):
    """(M, M) overall scores; the diagonal (self) is masked to NEG."""
    m = s_l.shape[0]
    s = s_p * (alpha * s_l - s_d + as_cost_matrix(comm_cost, m, s_l.device))
    eye = torch.eye(m, dtype=torch.bool, device=s_l.device)
    return torch.where(eye, NEG, s)


def select_peers(scores, *, k: int = 0, threshold: float | None = None,
                 candidate_mask=None):
    """→ bool (M, M) selection mask, row i = M_i.

    k > 0 → top-k per row (ties to the lowest column); threshold →
    Algorithm 1 line 5, {S_ij > s*}; candidate_mask: optional bool (M, M)
    of reachable peers. k = 0 without a threshold is the explicit empty
    selection."""
    if candidate_mask is not None:
        scores = torch.where(candidate_mask, scores, NEG)
    if threshold is not None and not k:
        return scores > threshold
    m = scores.shape[-1]
    k = min(k, m - 1)
    if k <= 0:
        return torch.zeros(scores.shape, dtype=torch.bool,
                           device=scores.device)
    vals, idx = stable_topk(scores, k)
    return topk_to_mask(idx, vals, m)


def topk_to_mask(indices, values, m: int):
    """(M, k) top-k indices/values → bool (M, M) mask. Picks at the
    masked-score floor (≤ NEG/2: fewer than k real candidates) are
    dropped, as in the dense `select_peers`."""
    rows = torch.arange(indices.shape[0], device=indices.device)[:, None]
    mask = torch.zeros((indices.shape[0], m), dtype=torch.bool,
                       device=indices.device)
    mask[rows, indices.long()] = values > NEG / 2
    return mask


def update_recency(last_selected, select_mask, t):
    """t0[i, j] ← t where i selected j this round."""
    return torch.where(select_mask, torch.as_tensor(t).to(last_selected),
                       last_selected)
