"""GQA attention: full-sequence and KV-cache decode paths (reference
`repro.models.attention`, the dense family's part).

Backends of `attend`:
* ``naive`` — materializes the (.., Sq, Skv) scores; small shapes only.
* ``flash`` — the blocked online-softmax kernel through
  `kernels.ops.flash_attention`: the CUDA kernel on a card, its plain
  PyTorch version on the CPU. The serving path prefills through it.

The reference's ``chunked`` backend (pure-JAX online softmax for the
training lowering) and MLA are not ported (ROADMAP queue 1 item 12).
Weights are (d_in, d_out), applied as x @ W. All softmax math in float32.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.ref import NEG, attention_mask
from repro_torch.models.layers import apply_rope, dense_init, torch_dtype


def _unported(what: str):
    return NotImplementedError(f"{what} is not ported (ROADMAP queue 1 "
                               "item 12)")


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
    the reference's "chunked" beyond (not ported)."""
    b, sq, h, _ = q.shape
    skv, kh = k.shape[1], k.shape[2]
    if backend == "auto":
        backend = "naive" if sq * skv <= 4096 * 4096 else "chunked"
    if backend == "flash":
        return kernel_ops.flash_attention(q, k, v, causal=causal,
                                          window=window,
                                          q_offset=int(q_offset))
    if backend != "naive":
        raise _unported(f"attention backend {backend!r}")
    out = _attend_naive(_group_q(q, kh), k, v, causal, window, q_offset)
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


def qkv_proj(p, x, cfg):
    """x (B, S, D) → q (B, S, H, hd), k and v (B, S, K, hd)."""
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    b, s, _ = x.shape
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (q.reshape(b, s, H, hd), k.reshape(b, s, K, hd),
            v.reshape(b, s, K, hd))


def init_kv_cache(cfg, batch: int, max_seq: int, device, lead=()):
    """Zeroed (k, v) buffers (*lead, B, max_seq, K, hd) in cfg.dtype."""
    dt = torch_dtype(cfg.dtype)
    shape = tuple(lead) + (batch, max_seq, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def attention_decode(p, x, cache, pos: int, cfg):
    """One-token decode. x (B, 1, D); pos the absolute position (an int).

    Writes this token's k/v into the cache IN PLACE at slot pos (the last
    slot once pos passes the end), then attends over the filled slots.
    The reference's sliding-window ring buffer is not ported (ROADMAP
    queue 1 item 12). → (out (B, 1, D), the same cache dict)."""
    b = x.shape[0]
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q, k, v = qkv_proj(p, x, cfg)
    posb = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q = apply_rope(q, posb, cfg.rope_theta)
    k = apply_rope(k, posb, cfg.rope_theta)

    ck, cv = cache["k"], cache["v"]
    cache_len = ck.shape[1]
    slot = min(pos, cache_len - 1)
    ck[:, slot] = k[:, 0].to(ck.dtype)
    cv[:, slot] = v[:, 0].to(cv.dtype)

    qg = q.reshape(b, K, H // K, hd)
    scale = 1.0 / math.sqrt(hd)
    scores = torch.einsum("bkrh,bskh->bkrs", qg, ck).float() * scale
    valid = torch.arange(cache_len, device=x.device) <= pos
    scores = torch.where(valid, scores, NEG)
    probs = torch.softmax(scores, dim=-1).to(cv.dtype)
    out = torch.einsum("bkrs,bskv->bkrv", probs, cv).reshape(b, 1, H * hd)
    return out @ p["wo"], cache
