"""Plain PyTorch oracles — torch twins of `repro.kernels.ref`.

These are the definitions of correctness the CUDA kernels are held to:
`cosine_gram_ref` (Eq. 7), `select_score_ref` (dense masked Eq. 9),
`select_score_nbr_ref` (its packed-neighbour columns), `select_topk_ref`
(dense Eq. 9 then a stable top-k), `gossip_mix_ref` (dense sequential
neighbour accumulation), `mask_evolve_ref`
(partition threshold, then drop and regrow), `flash_attention_ref`
(masked softmax attention) and `wkv_ref` (the per-token RWKV6
recurrence).
"""
from __future__ import annotations

import math

import torch

NEG = -1e30   # finite -inf of masked scores (core.selection.NEG)


def stable_topk(scores, k: int):
    """Per-row top-k with ties to the LOWEST column — `jax.lax.top_k`
    semantics, which `torch.topk` does not promise. → (values, int64
    indices)."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def cosine_gram_ref(x):
    """x: (M, P) → (M, M) float32 cosine-similarity Gram, clipped to [-1,1]."""
    x = x.float()
    norms = x.square().sum(dim=1, keepdim=True).sqrt() + 1e-12
    xn = x / norms
    return (xn @ xn.T).clamp(-1.0, 1.0)


def inverse_norms(xf):
    """1 / (‖x_i‖ + 1e-12) per row of a float32 (M, P) matrix."""
    return 1.0 / ((xf * xf).sum(dim=1).sqrt() + 1e-12)


def recency(last_selected, t, lam: float):
    """Eq. 8: 1 − exp(−λ·(t − t0)); never selected (t0 < 0) → 1."""
    dt = (t - last_selected).clamp_min(0).float()
    return torch.where(last_selected < 0, 1.0, 1.0 - torch.exp(-lam * dt))


def select_score_ref(x, last_selected, s_l, t, cost, candidate_mask=None,
                     *, alpha: float, lam: float):
    """Dense masked Eq. 9 score matrix. → (scores (M, M) f32, cosine s_d
    (M, M) f32). The diagonal and non-candidates score exactly NEG."""
    m = x.shape[0]
    xf = x.float()
    inv = inverse_norms(xf)
    cos = ((xf @ xf.T) * inv[:, None] * inv[None, :]).clamp(-1.0, 1.0)
    s_p = recency(last_selected, t, lam)
    c = torch.as_tensor(cost, dtype=torch.float32, device=x.device)
    s = s_p * (alpha * s_l.float() - cos + c)
    eye = torch.eye(m, dtype=torch.bool, device=x.device)
    s = torch.where(eye, NEG, s)
    if candidate_mask is not None:
        s = torch.where(candidate_mask, s, NEG)
    return s, cos


def select_score_nbr_ref(x, last_selected, s_l, t, cost, nbr_idx, nbr_valid,
                         *, alpha: float, lam: float):
    """(M, D) neighbour-column Eq. 9 scores gathered from the dense
    oracle — the parity reference of `core.scoring.score_topk_sparse`.
    The dense (M, M) scores are computed with the candidate mask set to
    the scattered valid slots, then sampled at each packed position;
    invalid slots (and a slot naming the row itself) read NEG. Small M
    only (forms the dense matrix)."""
    m = x.shape[0]
    idx = nbr_idx.long()
    rows = torch.arange(m, device=x.device)[:, None].expand_as(idx)
    ok = nbr_valid.bool() & (idx != rows)
    cand = torch.zeros((m, m), dtype=torch.bool, device=x.device)
    cand[rows[ok], idx[ok]] = True
    s, _ = select_score_ref(x, last_selected, s_l, t, cost, cand,
                            alpha=alpha, lam=lam)
    return torch.where(ok, torch.gather(s, 1, idx), NEG)


def select_topk_ref(x, last_selected, s_l, t, cost, candidate_mask=None,
                    *, k: int, alpha: float, lam: float):
    """→ (values (M, k) f32, indices (M, k) int32, stats (M, 2) f32) as
    the fused kernel emits them; stats = [Σ_j s_d[i, j], s_d[i, i]]."""
    s, cos = select_score_ref(x, last_selected, s_l, t, cost,
                              candidate_mask, alpha=alpha, lam=lam)
    vals, idx = stable_topk(s, k)
    stats = torch.stack([cos.sum(dim=1), torch.diagonal(cos)], dim=1)
    return vals, idx.to(torch.int32), stats


def fma_f32(a, b, c):
    """a·b + c for float32 tensors, rounded once to float32 — a fused
    multiply-add, the rounding XLA's CPU backend gives `acc + w·x`.

    The product of two float32 values is exact in float64. The float64
    sum is made round-to-odd (TwoSum gives its exact error; an inexact
    sum with an even last bit steps one ulp toward the error), and a
    round-to-odd value with at least two bits more than float32 rounds to
    float32 exactly as the exact sum would: no double rounding."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def neighbors_to_dense(idx, w, m: int):
    """Packed (M, D) neighbour lists → the dense (M, M) f32 mixing matrix
    (padding slots add exact zeros)."""
    rows = torch.arange(m, device=idx.device)[:, None].expand_as(idx)
    dense = torch.zeros((m, m), dtype=torch.float32, device=idx.device)
    dense.index_put_((rows, idx.long()), w.float(), accumulate=True)
    return dense


def gossip_mix_ref(x, idx, w):
    """Dense oracle of the gossip mix: scatter the packed (idx, w)
    neighbour lists back to a dense (M, M) matrix, then accumulate the
    columns j = 0..M−1 in ascending order, each step one single-rounded
    multiply-add (reference `ref.gossip_mix_ref`). → (M, F) in x.dtype."""
    m = x.shape[0]
    xf = x.float()
    dense = neighbors_to_dense(idx, w, m)
    acc = torch.zeros_like(xf)
    for j in range(m):
        acc = fma_f32(dense[:, j:j + 1], xf[j:j + 1], acc)
    return acc.to(x.dtype)


def mask_evolve_ref(x, grow, *, keep: int):
    """Partition oracle of DisPFL's mask evolution: threshold = the
    (n − keep)-th smallest |x| (`torch.kthvalue`, equal to the
    reference's `jnp.partition(|x|, kth)[kth]`), mask = (|x| ≥ thr) |
    grow, params re-projected by a product. → (x·mask in x.dtype, mask
    bool)."""
    flat = x.float().abs().reshape(-1)
    thr = torch.kthvalue(flat, flat.numel() - keep + 1).values
    mask = (x.float().abs() >= thr) | grow
    return x * mask.to(x.dtype), mask


def attention_mask(sq: int, skv: int, *, causal: bool, window: int,
                   q_offset: int, device=None):
    """(Sq, Skv) bool: key s is visible to query q (absolute row
    q + q_offset) — causal: s ≤ row; window > 0: s > row − window."""
    rows = torch.arange(sq, device=device)[:, None] + q_offset
    cols = torch.arange(skv, device=device)[None, :]
    ok = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        ok &= cols <= rows
    if window:
        ok &= cols > rows - window
    return ok


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        q_offset: int = 0):
    """Plain masked softmax attention (reference `flash_attention_ref`).

    q: (B, Sq, H, hd); k/v: (B, Skv, K, hd) with H % K == 0 (query head h
    reads kv head h // (H/K)) → (B, Sq, H, hd) in q.dtype. Scores, softmax
    and the P·V product in float32; masked scores are NEG (−1e30)."""
    b, sq, h, hd = q.shape
    skv, kh = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, sq, kh, h // kh, hd)
    scores = torch.einsum("bqkrh,bskh->bkrqs", qg, k.float()) * (
        1.0 / math.sqrt(hd))
    ok = attention_mask(sq, skv, causal=causal, window=window,
                        q_offset=q_offset, device=q.device)
    scores = torch.where(ok, scores, NEG)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkrqs,bskv->bqkrv", probs, v.float())
    return out.reshape(b, sq, h, hd).to(q.dtype)


def wkv_ref(r, k, v, w, u, state=None):
    """The RWKV6 WKV recurrence one token at a time (reference `wkv_ref`).

    r, k, v, w: (B, S, H, hd), w the per-step decay in (0, 1); u: (H, hd)
    bonus; state (B, H, hd, hd) f32 or None (zeros). Per step, in f32:
    out_t = r_t·(S + u⊙k_t v_tᵀ), S ← w_t⊙S + k_t v_tᵀ.
    → (out (B, S, H, hd) in r.dtype, final state (B, H, hd, hd) f32)."""
    b, s, h, hd = r.shape
    st = (torch.zeros((b, h, hd, hd), dtype=torch.float32, device=r.device)
          if state is None else state.float())
    rf, kf, vf, wf = (a.float() for a in (r, k, v, w))
    uf = u.float()[None, :, :, None]
    outs = []
    for t in range(s):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]
        outs.append(torch.einsum("bhi,bhij->bhj", rf[:, t], st + uf * kv))
        st = wf[:, t, :, :, None] * st + kv
    out = torch.stack(outs, dim=1) if outs else torch.zeros_like(rf)
    return out.to(r.dtype), st


def ulp(x, dtype=torch.bfloat16):
    """The spacing of `dtype` (bf16 or f16) values at |x|: one unit in
    the last place of a value of that magnitude, as float32."""
    mant = {torch.bfloat16: 7, torch.float16: 10}[dtype]
    tiny = torch.finfo(dtype).tiny
    e = torch.floor(torch.log2(x.float().abs().clamp_min(tiny)))
    return torch.exp2(e - mant)


def within_ulps(got, want, n: int = 1, rel_atol: float = 1e-5) -> bool:
    """Every element of `got` within n units in the last place of `want`'s
    low-precision dtype (the larger magnitude of the pair sets the ulp),
    plus rel_atol · max(1, max |want|): two routes that agree in f32 to
    that absolute error and round once differ by at most one ulp, except
    near zero, where cancellation leaves the f32 error larger than the
    value's own ulp."""
    g, w = got.float(), want.float()
    scale = max(1.0, float(w.abs().max())) if w.numel() else 1.0
    tol = n * ulp(torch.maximum(g.abs(), w.abs()), want.dtype) + \
        rel_atol * scale
    return bool(((g - w).abs() <= tol).all())
