"""GQA attention: full-sequence, cross and KV-cache decode paths
(reference `repro.models.attention`).

Backends of `attend`:
* ``naive``   — materializes the (.., Sq, Skv) scores; small shapes only.
* ``chunked`` — the reference's online softmax over 1024×1024 (q, kv)
  blocks on a static block-triangular schedule, in plain PyTorch (the
  reference has no kernel for it either); "auto" takes it above 4096²
  scores.
* ``flash``   — the blocked online-softmax kernel through
  `kernels.ops.flash_attention`: the CUDA kernel on a card, its plain
  PyTorch version on the CPU. The serving path prefills through it.

`attention_decode` writes into a KV cache in place, at slot pos, or at
pos % window in a sliding window's ring. MLA is not ported (ROADMAP
queue 1 item 12). Weights are (d_in, d_out), applied as x @ W. All
softmax math in float32.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.ref import NEG, attention_mask
from repro_torch.models.layers import apply_rope, dense_init, torch_dtype

CHUNK_Q = 1024
CHUNK_KV = 1024


def init_attention(generator, cfg, device, *, depth_scale: float = 1.0,
                   lead=()):
    """wq/wk/wv/wo (and the q/k/v biases when cfg.qkv_bias), with a
    leading `lead` shape for stacked layers."""
    H, K, hd, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_model
    kw = dict(lead=lead)
    p = {
        "wq": dense_init(generator, D, H * hd, cfg.dtype, device, **kw),
        "wk": dense_init(generator, D, K * hd, cfg.dtype, device, **kw),
        "wv": dense_init(generator, D, K * hd, cfg.dtype, device, **kw),
        "wo": dense_init(generator, H * hd, D, cfg.dtype, device,
                         scale=depth_scale, **kw),
    }
    if cfg.qkv_bias:
        dt = torch_dtype(cfg.dtype)
        for name, n in (("bq", H * hd), ("bk", K * hd), ("bv", K * hd)):
            p[name] = torch.zeros(tuple(lead) + (n,), dtype=dt,
                                  device=device)
    return p


def _group_q(q, num_kv: int):
    b, s, h, hd = q.shape
    return q.reshape(b, s, num_kv, h // num_kv, hd)


def attend(q, k, v, *, causal: bool = True, window: int = 0, q_offset=0,
           backend: str = "auto"):
    """q (B, Sq, H, hd), k/v (B, Skv, K, hd) → (B, Sq, H, v_dim).

    window > 0 → sliding-window causal attention; q_offset is the
    absolute position of q[0]. "auto" takes "naive" up to 4096² scores and
    "chunked" beyond."""
    b, sq, h, _ = q.shape
    skv, kh = k.shape[1], k.shape[2]
    if backend == "auto":
        backend = "naive" if sq * skv <= 4096 * 4096 else "chunked"
    if backend == "flash":
        return kernel_ops.flash_attention(q, k, v, causal=causal,
                                          window=window,
                                          q_offset=int(q_offset))
    qg = _group_q(q, kh)
    if backend == "naive":
        out = _attend_naive(qg, k, v, causal, window, q_offset)
    elif backend == "chunked":
        out = _attend_chunked(qg, k, v, causal, window, int(q_offset))
    else:
        raise ValueError(f"unknown attention backend {backend!r}")
    return out.reshape(b, sq, h, v.shape[-1])


def _mask_bias(sq, skv, causal, window, q_offset, device):
    ok = attention_mask(sq, skv, causal=causal, window=window,
                        q_offset=q_offset, device=device)
    return torch.where(ok, 0.0, NEG).float()


def _attend_naive(qg, k, v, causal, window, q_offset):
    scale = 1.0 / math.sqrt(qg.shape[-1])
    scores = torch.einsum("bqkrh,bskh->bkrqs", qg, k).float() * scale
    scores = scores + _mask_bias(qg.shape[1], k.shape[1], causal, window,
                                 q_offset, qg.device)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bkrqs,bskv->bqkrv", probs, v)


def _attend_chunked(qg, k, v, causal, window, q_offset: int):
    """The reference's `_attend_chunked`: for each 1024-row q block, an
    online softmax over the 1024-column kv blocks of its causal/window
    band only (the static schedule), scores in f32, p in v.dtype, masked
    scores NEG, the running max clamped at 0.5·NEG (so a row with every
    key masked so far keeps p = 0), l floored at 1e-30."""
    b, sq, kh, r, hd = qg.shape
    skv, vd = k.shape[1], v.shape[-1]
    cq, ckv = min(CHUNK_Q, sq), min(CHUNK_KV, skv)
    nq, nkv = -(-sq // cq), -(-skv // ckv)
    scale = 1.0 / math.sqrt(hd)
    dev = qg.device
    outs = []
    for qi in range(nq):
        q_i = qg[:, qi * cq:(qi + 1) * cq].float()
        n = q_i.shape[1]
        row_min = q_offset + qi * cq
        row_max = row_min + cq - 1
        lo, hi = 0, nkv
        if causal:
            hi = min(nkv, row_max // ckv + 1)
        if window:
            lo = max(0, (row_min - window + 1) // ckv)
        rows = row_min + torch.arange(n, device=dev)
        m = torch.full((b, n, kh, r), NEG, dtype=torch.float32, device=dev)
        l = torch.zeros_like(m)
        acc = torch.zeros((b, n, kh, r, vd), dtype=torch.float32, device=dev)
        for j in range(lo, hi):
            k_j = k[:, j * ckv:(j + 1) * ckv]
            v_j = v[:, j * ckv:(j + 1) * ckv]
            cols = j * ckv + torch.arange(k_j.shape[1], device=dev)
            s = torch.einsum("bqkrh,bckh->bqkrc", q_i, k_j.float()) * scale
            ok = torch.ones((n, cols.shape[0]), dtype=torch.bool, device=dev)
            if causal:
                ok &= cols[None, :] <= rows[:, None]
            if window:
                ok &= cols[None, :] > rows[:, None] - window
            s = torch.where(ok[None, :, None, None, :], s, NEG)
            m_new = torch.maximum(m, s.amax(dim=-1))
            m_safe = torch.clamp_min(m_new, 0.5 * NEG)[..., None]
            p = torch.exp(s - m_safe).to(v.dtype)
            corr = torch.exp(m - m_new)
            l = l * corr + p.float().sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bqkrc,bckv->bqkrv", p.float(), v_j.float())
            m = m_new
        l = torch.clamp_min(l, 1e-30)
        outs.append((acc / l[..., None]).to(v.dtype))
    return torch.cat(outs, dim=1)


def qkv_proj(p, x, cfg):
    """x (B, S, D) → q (B, S, H, hd), k and v (B, S, K, hd)."""
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    b, s, _ = x.shape
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (q.reshape(b, s, H, hd), k.reshape(b, s, K, hd),
            v.reshape(b, s, K, hd))


def attention_layer(p, x, positions, cfg, *, causal: bool = True,
                    window: int = 0, cross_kv=None, backend: str = "auto"):
    """Self- (or cross-) attention over a full sequence x (B, S, D). With
    `cross_kv` = (k, v) from `cross_kv_from_encoder`, q is x @ wq alone
    (no bias, no rotation) and the attention is not causal."""
    b, s, _ = x.shape
    if cross_kv is None:
        q, k, v = qkv_proj(p, x, cfg)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    else:
        q = (x @ p["wq"]).reshape(b, s, cfg.num_heads, cfg.head_dim)
        k, v = cross_kv
        causal = False
    out = attend(q, k, v, causal=causal, window=window, backend=backend)
    return out.reshape(b, s, -1) @ p["wo"]


def cross_kv_from_encoder(p, enc_out, cfg):
    """Project the encoder's output once into the (k, v) of a decoder
    layer's cross-attention: (B, Se, K, hd) each."""
    b, s, _ = enc_out.shape
    K, hd = cfg.num_kv_heads, cfg.head_dim
    k = (enc_out @ p["wk"]).reshape(b, s, K, hd)
    v = (enc_out @ p["wv"]).reshape(b, s, K, hd)
    if cfg.qkv_bias:
        k = k + p["bk"].reshape(K, hd)
        v = v + p["bv"].reshape(K, hd)
    return k, v


def init_kv_cache(cfg, batch: int, max_seq: int, device, lead=()):
    """Zeroed (k, v) buffers (*lead, B, max_seq, K, hd) in cfg.dtype. A
    sliding window's ring has max_seq = window."""
    dt = torch_dtype(cfg.dtype)
    shape = tuple(lead) + (batch, max_seq, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def attention_decode(p, x, cache, pos: int, cfg, *, window: int = 0):
    """One-token decode. x (B, 1, D); pos the absolute position (an int).

    Writes this token's k/v into the cache IN PLACE — at slot pos (the
    last slot once pos passes the end), or with window > 0 (a cache of
    `window` slots) at the ring slot pos % window — then attends over the
    filled slots (the whole ring once it has wrapped).
    → (out (B, 1, D), the same cache dict)."""
    b = x.shape[0]
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q, k, v = qkv_proj(p, x, cfg)
    posb = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q = apply_rope(q, posb, cfg.rope_theta)
    k = apply_rope(k, posb, cfg.rope_theta)

    ck, cv = cache["k"], cache["v"]
    cache_len = ck.shape[1]
    slot = pos % cache_len if window else min(pos, cache_len - 1)
    ck[:, slot] = k[:, 0].to(ck.dtype)
    cv[:, slot] = v[:, 0].to(cv.dtype)

    qg = q.reshape(b, K, H // K, hd)
    scale = 1.0 / math.sqrt(hd)
    scores = torch.einsum("bkrh,bskh->bkrs", qg, ck).float() * scale
    idx = torch.arange(cache_len, device=x.device)
    valid = ((idx <= slot) | (pos >= cache_len)) if window else idx <= pos
    scores = torch.where(valid, scores, NEG)
    probs = torch.softmax(scores, dim=-1).to(cv.dtype)
    out = torch.einsum("bkrs,bskv->bkrv", probs, cv).reshape(b, 1, H * hd)
    return out @ p["wo"], cache
