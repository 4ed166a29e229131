"""PFedDST scoring — the three peer-evaluation signals (paper §II-B),
reference `repro.core.scoring`.

* loss disparity  s_l (Eq. 6): loss of client i's model on peer j's probe.
* header distance s_d (Eq. 7): cosine similarity of header weight vectors.
* peer recency    s_p (Eq. 8): exponential CDF of rounds since selection.

Population entry points take client-stacked dicts (leading M axis) and
return (M, M) matrices: row i = client i scoring peer j.
"""
from __future__ import annotations

import torch

from repro_torch.core.selection import NEG
from repro_torch.kernels import ops
from repro_torch.kernels.peer_score import gram_to_cosine
from repro_torch.kernels.ref import inverse_norms, recency, stable_topk
from repro_torch.core.client_state import client_rows
from repro_torch.models import model as model_mod
from repro_torch.utils.pytree import leaf_order, tree_leaves


# ---------------------------------------------------------------------------
# Eq. 6 — loss disparity
# ---------------------------------------------------------------------------

@torch.no_grad()
def loss_disparity_rows(cfg, stacked_params_rows, probe_batches: dict, *,
                        rows=None):
    """L[r, j] = eval-loss of row-client r's model on client j's probe.

    stacked_params_rows: a tree of (R, ...) tensors (typically the
    round's sampled clients); probe_batches: dict of (M, B, ...) tensors.
    rows: optional ids of the row clients within a whole population's
    tree (views, no gathered copy). Each row model scores the M probes by
    `model.eval_loss_probes` (all M in one forward, one forward a probe
    for the MoE). → (R, M) f32."""
    if rows is None:
        rows = range(tree_leaves(stacked_params_rows)[0].shape[0])
    return torch.stack([
        model_mod.eval_loss_probes(
            cfg, client_rows(stacked_params_rows, int(i)), probe_batches)
        for i in rows])


# ---------------------------------------------------------------------------
# Eq. 7 — header cosine similarity
# ---------------------------------------------------------------------------

def flatten_headers(stacked_header: dict):
    """Client-stacked header dict → (M, P) float32, in the reference's
    leaf order."""
    return torch.cat([stacked_header[n].reshape(
        stacked_header[n].shape[0], -1).float()
        for n in leaf_order(stacked_header)], dim=1)


def header_gram_tree(stacked_header):
    """Eq. 7's cosine Gram accumulated leaf by leaf, without the
    flattened (M, P) matrix: Σ_leaf x_leaf·x_leafᵀ over the reference's
    leaf order, then `gram_to_cosine`. → (M, M) f32."""
    raw = None
    for name in leaf_order(stacked_header):
        leaf = stacked_header[name]
        x = leaf.reshape(leaf.shape[0], -1).float()
        raw = x @ x.T if raw is None else raw + x @ x.T
    return gram_to_cosine(raw)


def header_distance_matrix(headers_flat, *, use_kernel: bool = False):
    """S_d[i, j] = cos(h_i, h_j) ∈ [-1, 1]. headers_flat: (M, P).

    use_kernel routes the Gram through `ops.raw_gram` (the CUDA kernel on
    a CUDA tensor); both routes share `gram_to_cosine`."""
    if use_kernel:
        return ops.cosine_gram(headers_flat)
    x = headers_flat.float()
    return gram_to_cosine(x @ x.T)


# ---------------------------------------------------------------------------
# fused Eq. 7–9 + top-k — the streaming selection entry point
# ---------------------------------------------------------------------------

def score_topk(headers_flat, last_selected, loss_matrix, round_t, *,
               alpha: float, lam: float, comm_cost, k: int,
               candidate_mask=None):
    """Fused Eq. 7–9 scoring + per-row top-k selection through
    `ops.select_topk` (the CUDA kernel on CUDA tensors).

    → (values (M, k), indices (M, k), s_d_stats (M, 2)) with
    s_d_stats[:, 0] = Σ_j s_d[i, j] and s_d_stats[:, 1] = s_d[i, i].
    Convert to a mask with `selection.topk_to_mask`."""
    m = headers_flat.shape[0]
    if isinstance(comm_cost, torch.Tensor) and comm_cost.dim() != 0 \
            and tuple(comm_cost.shape) != (m, m):
        raise ValueError(f"comm_cost must be a scalar or ({m}, {m}) matrix, "
                         f"got shape {tuple(comm_cost.shape)}")
    return ops.select_topk(headers_flat, last_selected, loss_matrix, round_t,
                           comm_cost, candidate_mask, k=k, alpha=float(alpha),
                           lam=float(lam))


def _gather_nbr_cols(arr, nbr_idx, m: int, what: str):
    """(M, M) dense → (M, D) neighbour columns; (M, D) passes through.
    D == M reads as dense (a packed fabric has D < M: no self-loops)."""
    d = nbr_idx.shape[1]
    if tuple(arr.shape) == (m, m):
        return torch.gather(arr, 1, nbr_idx.long())
    if tuple(arr.shape) == (m, d):
        return arr
    raise ValueError(f"{what} must be ({m}, {m}) dense or ({m}, {d}) "
                     f"neighbour columns, got shape {tuple(arr.shape)}")


def score_topk_sparse(headers_flat, last_selected, loss_matrix, round_t, *,
                      nbr_idx, nbr_valid, alpha: float, lam: float,
                      comm_cost, k: int):
    """Eq. 7–9 scoring + top-k over packed neighbour lists, O(M·D·P) —
    the packed fabric's twin of `score_topk` (plain PyTorch, as the
    reference's is plain jnp).

    Client i scores only its D neighbours `nbr_idx[i]` (ascending ids,
    padding arbitrary), `nbr_valid[i]` marking the slots live this round
    (`SparseFabric.round_slots`). last_selected / loss_matrix / comm_cost
    take the dense (M, M) form (gathered here) or (M, D) neighbour columns
    (e.g. `SparseFabric.slot_cost`); comm_cost may be a scalar. The
    cosine is one row dot per slot, never an (M, D, P) gather, so its
    values equal the reference's to fp tolerance, not bitwise.

    → (values (M, k), indices (M, k) int32 global ids, s_d_stats (M, 2)).
    Invalid slots score exactly NEG; a pick at that floor names the row
    itself (never the padding's fill id, which could collide with a real
    pick in `topk_to_mask`), and k > D is padded with (NEG, row) entries.
    Ties go to the lowest slot, i.e. the lowest id. s_d_stats[:, 0] sums
    the cosine over the valid neighbourhood plus the diagonal (the dense
    stats sum all M columns); s_d_stats[:, 1] is the diagonal."""
    m = headers_flat.shape[0]
    idx = nbr_idx.long()
    d = idx.shape[1]
    xf = headers_flat.float()
    sq = (xf * xf).sum(dim=1)
    inv = 1.0 / (sq.sqrt() + 1e-12)
    raw = torch.stack([(xf * xf[idx[:, j]]).sum(dim=1) for j in range(d)],
                      dim=1)
    cos = (raw * inv[:, None] * inv[idx]).clamp(-1.0, 1.0)
    last = _gather_nbr_cols(last_selected, idx, m, "last_selected")
    s_p = recency(last, round_t, lam)
    s_l = _gather_nbr_cols(loss_matrix, idx, m, "loss_matrix").float()
    c = torch.as_tensor(comm_cost, dtype=torch.float32, device=xf.device)
    c = c.expand(m, d) if c.dim() == 0 else \
        _gather_nbr_cols(c, idx, m, "comm_cost")
    s = s_p * (alpha * s_l - cos + c)
    rows = torch.arange(m, device=xf.device)[:, None]
    ok = nbr_valid.bool() & (idx != rows)
    s = torch.where(ok, s, NEG)
    kk = min(k, d)
    vals, pos = stable_topk(s, kk)
    sel = torch.where(vals > NEG / 2, torch.gather(idx, 1, pos),
                      rows.expand(m, kk))
    if kk < k:
        vals = torch.cat([vals, vals.new_full((m, k - kk), NEG)], dim=1)
        sel = torch.cat([sel, rows.expand(m, k - kk)], dim=1)
    diag = (sq * inv * inv).clamp(-1.0, 1.0)
    nbr_sum = torch.where(ok, cos, 0.0).sum(dim=1) + diag
    return vals, sel.to(torch.int32), torch.stack([nbr_sum, diag], dim=1)


# ---------------------------------------------------------------------------
# Eq. 9 decomposition over selected pairs — the telemetry side-channel
# ---------------------------------------------------------------------------

def selected_components(headers_flat, last_selected, loss_matrix, round_t,
                        idx, *, alpha: float, lam: float, comm_cost):
    """Eq. 9 components for each row's selected columns idx (M, k),
    without any (M, M) matrix. → dict of (M, k) float32: s_l, s_d, s_p,
    cost and the recombined score."""
    x = headers_flat.float()
    xn = x * inverse_norms(x)[:, None]
    idx = idx.long()
    s_d = torch.einsum("mp,mkp->mk", xn, xn[idx]).clamp(-1.0, 1.0)
    last = torch.gather(last_selected, 1, idx)
    s_p = recency(last, round_t, lam)
    s_l = torch.gather(loss_matrix, 1, idx).float()
    c = torch.as_tensor(comm_cost, dtype=torch.float32, device=x.device)
    c = c.expand(idx.shape) if c.dim() == 0 else torch.gather(c, 1, idx)
    score = s_p * (alpha * s_l - s_d + c)
    return {"s_l": s_l, "s_d": s_d, "s_p": s_p, "cost": c, "score": score}


# ---------------------------------------------------------------------------
# Eq. 8 — peer recency
# ---------------------------------------------------------------------------

def recency_scores(last_selected, t, lam: float):
    """s_p[i, j] = 1 − exp(−λ·(t − t0[i, j])); never selected (−1) → 1."""
    return recency(last_selected, t, lam)
