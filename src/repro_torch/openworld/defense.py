"""Robust aggregation — byzantine-tolerant replacements for the mean,
reference `repro.openworld.defense`.

  star (client↔server)            p2p (per row over the peer set)
  ------------------------------  ------------------------------------
  trimmed_mean_over_active        robust_row_aggregate("trimmed_mean")
  median_over_active              robust_row_aggregate("median")
  norm_clip_mean_over_active      robust_row_aggregate("norm_clip")

`star_reducer(threat)` / `robust_mixer(threat)` map a `ThreatConfig` onto
the `reducer=` hook of `engine.stage_star_average` and the `mixer=` hook
of `engine.stage_mix`; the PFedDST aggregate stage calls
`robust_row_aggregate` over its selection mask (`core.rounds`).

These are plain PyTorch, as the reference computes them with `jnp.sort`
outside any Pallas kernel. Trimmed mean and median are coordinate-wise
order statistics under a dynamic active count, with no host sync:
inactive entries are pushed to +inf, one sort orders each coordinate,
and rank windows select the survivors. The median picks its two middle
ranks by a gather (the reference sums a one-hot window, so a −0.0 may
come out there as +0.0: the values are equal) and averages them as
`0.5·(a + b)`, so it is exact; the trimmed mean and the norm-clipped
mean sum in another order than XLA (the trimmed mean adds the ranks in
order). The p2p order statistics sort a
(M, M, n) peer axis per leaf; the port cuts the leaf into column chunks
of at most `CHUNK_ELEMS` elements of that axis (each coordinate's
statistic is independent, so the bits are the same) to bound the sort's
memory.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core.aggregation import mean_over_active
from repro_torch.utils.pytree import ordered_leaves, tree_map

DEFENSES = ("none", "trimmed_mean", "median", "norm_clip")

# elements of the (M, M, chunk) peer axis sorted at once (f32 values,
# sorted values and int64 indices: 16 bytes each, 1 GiB)
CHUNK_ELEMS = 1 << 26


def _bcast(mask, x):
    """(M,) vector broadcast over the leading axis of leaf x."""
    return mask.reshape((-1,) + (1,) * (x.dim() - 1))


def _median_ranks(n):
    """(lo, hi) ranks whose midpoint is the median of n sorted entries
    (equal when n is odd); n = 0 gives (0, 0) — guard upstream."""
    return ((n - 1) // 2).clamp_min(0), n // 2


def _pick(s, k, dim: int):
    """s's entries at rank k (a tensor broadcastable to s without `dim`)
    along `dim`."""
    shape = list(s.shape)
    shape[dim] = 1
    idx = k.unsqueeze(dim).expand(shape) if k.dim() else \
        k.reshape([1] * s.dim()).expand(shape)
    return s.gather(dim, idx.long()).squeeze(dim)


def _window_mean(s, lo, hi, dim: int):
    """Mean of ranks [lo, hi) of s, pre-sorted along `dim`; lo/hi scalars
    or broadcastable to s without `dim`. The ranks are summed in order,
    one slice at a time, so the bits do not depend on the other axes'
    sizes (column chunks). Empty windows give 0."""
    total = torch.zeros_like(s.select(dim, 0))
    for r in range(s.shape[dim]):
        total = total + torch.where((lo <= r) & (r < hi), s.select(dim, r),
                                    0.0)
    return total / (hi - lo).clamp_min(1).float()


# ---------------------------------------------------------------------------
# star reducers — the mean_over_active contract: (tree, active) -> broadcast
# ---------------------------------------------------------------------------

def _sorted_active(x, active):
    return torch.sort(torch.where(_bcast(active, x), x.float(),
                                  torch.inf), dim=0).values


def trimmed_mean_over_active(tree, active, *, trim: float = 0.2):
    """Coordinate-wise trimmed mean over the active rows, broadcast to all
    M rows: per coordinate, floor(trim·n) entries dropped from each tail
    of the active values, the rest averaged. All-zero with no active row
    (callers guard with `keep_if_none_active`)."""
    n = active.sum().to(torch.int32)
    lo = torch.minimum(torch.floor(trim * n).to(torch.int32),
                       ((n - 1) // 2).clamp_min(0))
    hi = n - lo

    def red(x):
        out = _window_mean(_sorted_active(x, active), lo, hi, 0)
        out = torch.where(n > 0, out, 0.0)
        return out[None].to(x.dtype).expand(x.shape).clone()

    return tree_map(red, tree)


def median_over_active(tree, active):
    """Coordinate-wise median over the active rows, broadcast to all M
    rows (even counts average the two middle entries). All-zero with no
    active row."""
    n = active.sum().to(torch.int32)
    lo, hi = _median_ranks(n)

    def red(x):
        s = _sorted_active(x, active)
        out = 0.5 * (_pick(s, lo, 0) + _pick(s, hi, 0))
        out = torch.where(n > 0, out, 0.0)
        return out[None].to(x.dtype).expand(x.shape).clone()

    return tree_map(red, tree)


def client_norms(tree):
    """(M,) f32 global parameter norm per client over the whole tree,
    summed leaf by leaf in the reference's leaf order."""
    leaves = ordered_leaves(tree)
    m = leaves[0].shape[0]
    sq = torch.zeros((m,), dtype=torch.float32, device=leaves[0].device)
    for leaf in leaves:
        sq = sq + leaf.reshape(m, -1).float().square().sum(dim=1)
    return sq.sqrt()


def _masked_median_vec(v, mask):
    """Median of v's masked entries (a 0-d tensor); 0 when mask is empty."""
    n = mask.sum().to(torch.int32)
    lo, hi = _median_ranks(n)
    s = torch.sort(torch.where(mask, v, torch.inf)).values
    med = 0.5 * (_pick(s, lo, 0) + _pick(s, hi, 0))
    return torch.where(n > 0, med, 0.0)


def clip_scales(tree, reference_mask, *, clip: float):
    """(M,) per-client down-scales bounding every client's global norm to
    `clip ×` the median norm over the `reference_mask` rows (1.0 for
    clients already inside the bound)."""
    norms = client_norms(tree)
    limit = clip * _masked_median_vec(norms, reference_mask)
    return torch.minimum(torch.ones_like(norms),
                         limit / norms.clamp_min(1e-12))


def norm_clip_mean_over_active(tree, active, *, clip: float = 2.0):
    """Mean over the active rows after clipping each client's global
    parameter norm to `clip ×` the active median norm. The broadcast and
    none-active contract of `mean_over_active`."""
    scale = clip_scales(tree, active, clip=clip)
    clipped = tree_map(lambda x: (x.float() * _bcast(scale, x)).to(x.dtype),
                       tree)
    return mean_over_active(clipped, active)


# ---------------------------------------------------------------------------
# p2p — per-row robust aggregation over each client's peer set
# ---------------------------------------------------------------------------

def _row_order_statistic(x, peers, lo, hi, defense: str):
    """Per row i, the order statistic of the peers' values of leaf x
    ((M, n) view), computed over column chunks of the (M, M, n) axis."""
    m = x.shape[0]
    xf = x.reshape(m, -1).float()
    n = xf.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    chunk = max(1, CHUNK_ELEMS // (m * m))
    lo_b, hi_b = lo.reshape(m, 1), hi.reshape(m, 1)
    for c0 in range(0, n, chunk):
        c1 = min(c0 + chunk, n)
        vals = torch.where(peers[:, :, None], xf[None, :, c0:c1],
                           torch.inf)
        s = torch.sort(vals, dim=1).values
        if defense == "trimmed_mean":
            out[:, c0:c1] = _window_mean(s, lo_b, hi_b, 1)
        else:
            out[:, c0:c1] = 0.5 * (_pick(s, lo_b, 1) + _pick(s, hi_b, 1))
        del vals, s
    return out.reshape(x.shape)


def robust_row_aggregate(tree, edges, weights, m: int, *, defense: str,
                         trim: float = 0.2, clip: float = 2.0):
    """Per-row robust aggregation over each client's selected peer set.

    edges    (M, M) bool — i pulls j (self is added)
    weights  (M, M) row-stochastic plan weights, kept exactly by
             "norm_clip" (which clips only the oversized peers' columns,
             never the row's own); the order-statistic defenses aggregate
             the peer set uniformly."""
    if defense not in DEFENSES or defense == "none":
        raise ValueError(f"robust_row_aggregate needs a defense in "
                         f"{DEFENSES[1:]}, got {defense!r}")
    device = edges.device
    eye = torch.eye(m, dtype=torch.bool, device=device)
    peers = edges | eye

    if defense == "norm_clip":
        scale = clip_scales(tree, torch.ones((m,), dtype=torch.bool,
                                             device=device), clip=clip)
        wf = weights.float()
        w_self = torch.diagonal(wf)
        w_off = torch.where(eye, 0.0, wf)

        def agg(x):
            xf = x.reshape(m, -1).float()
            out = w_off @ (scale[:, None] * xf) + w_self[:, None] * xf
            return out.reshape(x.shape).to(x.dtype)

        return tree_map(agg, tree)

    n_i = peers.sum(dim=1).to(torch.int32)                 # ≥ 1 (self)
    if defense == "trimmed_mean":
        lo = torch.minimum(torch.floor(trim * n_i).to(torch.int32),
                           ((n_i - 1) // 2).clamp_min(0))
        hi = n_i - lo
    else:
        lo, hi = _median_ranks(n_i)
    return tree_map(lambda x: _row_order_statistic(
        x, peers, lo, hi, defense).to(x.dtype), tree)


# ---------------------------------------------------------------------------
# ThreatConfig → engine hooks
# ---------------------------------------------------------------------------

def star_reducer(threat):
    """ThreatConfig → the `reducer` hook of `engine.stage_star_average`
    (None without a defense: the plain mean, bit for bit)."""
    if threat is None or threat.defense == "none":
        return None
    if threat.defense == "trimmed_mean":
        return functools.partial(trimmed_mean_over_active,
                                 trim=threat.trim_fraction)
    if threat.defense == "median":
        return median_over_active
    return functools.partial(norm_clip_mean_over_active,
                             clip=threat.clip_factor)


def robust_mixer(threat):
    """ThreatConfig → the `mixer` hook of `engine.stage_mix` (None without
    a defense)."""
    if threat is None or threat.defense == "none":
        return None

    def mixer(tree, plan, m):
        return robust_row_aggregate(
            tree, plan.edges, plan.weights, m, defense=threat.defense,
            trim=threat.trim_fraction, clip=threat.clip_factor)

    return mixer
