"""GQA and MLA attention: full-sequence, cross and KV-cache decode paths
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
pos % window in a sliding window's ring. MLA (deepseek): the low-rank
q and kv projections (`init_mla`, `mla_qkv_full`, `mla_layer`), whose
q/k head dim (nope + rope) exceeds v's, and the absorbed-weight decode
over the latent cache (`init_mla_cache`, `mla_decode`). Weights are
(d_in, d_out), applied as x @ W. All softmax math in float32.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.ref import NEG, attention_mask
from repro_torch.models.layers import (apply_rope, dense_init, rms_norm,
                                       torch_dtype)

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


def init_mla(generator, cfg, device, *, depth_scale: float = 1.0, lead=()):
    """MLA weights: wq_a (D, q_rank), q_norm, wq_b (q_rank, H·(nope+rope)),
    wkv_a (D, kv_rank + rope), kv_norm, wkv_b (kv_rank, H·(nope+v)), wo
    (H·v, D); a leading `lead` shape stacks layers. The matrices are drawn
    one layer's slice at a time (`dense_init(sliced=True)`)."""
    D, H = cfg.d_model, cfg.num_heads
    nope, rope_d, v_d = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                         cfg.v_head_dim)
    dt = torch_dtype(cfg.dtype)
    kw = dict(lead=lead, sliced=True)
    lead = tuple(lead)
    return {
        "wq_a": dense_init(generator, D, cfg.q_lora_rank, cfg.dtype, device,
                           **kw),
        "q_norm": torch.zeros(lead + (cfg.q_lora_rank,), dtype=dt,
                              device=device),
        "wq_b": dense_init(generator, cfg.q_lora_rank, H * (nope + rope_d),
                           cfg.dtype, device, **kw),
        "wkv_a": dense_init(generator, D, cfg.kv_lora_rank + rope_d,
                            cfg.dtype, device, **kw),
        "kv_norm": torch.zeros(lead + (cfg.kv_lora_rank,), dtype=dt,
                               device=device),
        "wkv_b": dense_init(generator, cfg.kv_lora_rank, H * (nope + v_d),
                            cfg.dtype, device, **kw),
        "wo": dense_init(generator, H * v_d, D, cfg.dtype, device,
                         scale=depth_scale, **kw),
    }


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


# ---------------------------------------------------------------------------
# MLA (deepseek): full sequence and the absorbed-weight decode
# ---------------------------------------------------------------------------

def mla_qkv_full(p, x, positions, cfg):
    """x (B, S, D) → q, k (B, S, H, nope + rope), v (B, S, H, v_d), the
    normed latent c_kv (B, S, kv_rank) and the rotated shared rope key
    (B, S, rope) (reference `_mla_qkv_full`). k's rope half is the one
    shared key, broadcast over the heads; q and k are contiguous."""
    b, s, _ = x.shape
    H = cfg.num_heads
    nope, rope_d, v_d = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                         cfg.v_head_dim)
    q = rms_norm(x @ p["wq_a"], p["q_norm"], cfg.norm_eps)
    q = (q @ p["wq_b"]).reshape(b, s, H, nope + rope_d)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    kv_a = x @ p["wkv_a"]
    c_kv = rms_norm(kv_a[..., :cfg.kv_lora_rank], p["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope(kv_a[..., cfg.kv_lora_rank:][:, :, None, :],
                        positions, cfg.rope_theta)
    kv = (c_kv @ p["wkv_b"]).reshape(b, s, H, nope + v_d)
    k_nope, v = kv[..., :nope], kv[..., nope:]
    k = torch.cat([k_nope, k_rope.expand(b, s, H, rope_d)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    return q, k, v, c_kv, k_rope[:, :, 0, :]


def mla_layer(p, x, positions, cfg, *, backend: str = "auto"):
    """Causal MLA self-attention over x (B, S, D) → (B, S, D); the
    attention's v head dim is v_d, below q/k's nope + rope."""
    q, k, v, _, _ = mla_qkv_full(p, x, positions, cfg)
    out = attend(q, k, v, causal=True, backend=backend)
    b, s = x.shape[:2]
    return out.reshape(b, s, -1) @ p["wo"]


def init_mla_cache(cfg, batch: int, max_seq: int, device, lead=()):
    """The compressed MLA cache: zeroed latent c_kv (*lead, B, max_seq,
    kv_rank) and shared rope key (*lead, B, max_seq, rope) in cfg.dtype."""
    dt = torch_dtype(cfg.dtype)
    lead = tuple(lead)
    return {"c_kv": torch.zeros(lead + (batch, max_seq, cfg.kv_lora_rank),
                                dtype=dt, device=device),
            "k_rope": torch.zeros(lead + (batch, max_seq,
                                          cfg.qk_rope_head_dim),
                                  dtype=dt, device=device)}


def mla_decode(p, x, cache, pos: int, cfg):
    """Absorbed-weight MLA decode of one token x (B, 1, D) at position pos
    (reference `mla_decode`): the query is taken into the latent space
    through wkv_b's k half, scores against the cached c_kv and rope keys
    run in f32 (positions past pos masked to NEG), the context comes back
    through wkv_b's v half. This token's c_kv and rope key are written
    into the cache IN PLACE at slot pos (the last slot once pos passes the
    end). → (out (B, 1, D), the same cache dict)."""
    b = x.shape[0]
    H = cfg.num_heads
    nope, rope_d, v_d = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                         cfg.v_head_dim)
    L = cfg.kv_lora_rank
    posb = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)

    q = rms_norm(x @ p["wq_a"], p["q_norm"], cfg.norm_eps)
    q = (q @ p["wq_b"]).reshape(b, 1, H, nope + rope_d)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = apply_rope(q_rope, posb, cfg.rope_theta)[:, 0]     # (b, H, rope)

    kv_a = x @ p["wkv_a"]
    c_kv_new = rms_norm(kv_a[..., :L], p["kv_norm"], cfg.norm_eps)
    k_rope_new = apply_rope(kv_a[..., L:][:, :, None, :], posb,
                            cfg.rope_theta)[:, :, 0, :]

    ckv, krope = cache["c_kv"], cache["k_rope"]
    slot = min(pos, ckv.shape[1] - 1)
    ckv[:, slot] = c_kv_new[:, 0].to(ckv.dtype)
    krope[:, slot] = k_rope_new[:, 0].to(krope.dtype)

    wkv_b = p["wkv_b"].reshape(L, H, nope + v_d)
    wk, wv = wkv_b[..., :nope], wkv_b[..., nope:]
    q_lat = torch.einsum("bhn,lhn->bhl", q_nope[:, 0], wk)       # (b, H, L)
    scale = 1.0 / math.sqrt(nope + rope_d)
    scores = (torch.einsum("bhl,bsl->bhs", q_lat.float(), ckv.float())
              + torch.einsum("bhr,bsr->bhs", q_rope.float(),
                             krope.float())) * scale
    valid = torch.arange(ckv.shape[1], device=x.device) <= pos
    scores = torch.where(valid, scores, NEG)
    probs = torch.softmax(scores, dim=-1)
    ctx_lat = torch.einsum("bhs,bsl->bhl", probs.to(ckv.dtype), ckv)
    ctx = torch.einsum("bhl,lhv->bhv", ctx_lat, wv)             # (b, H, v_d)
    out = (ctx.reshape(b, H * v_d) @ p["wo"])[:, None, :]
    return out, cache
