"""Plain reference of the Qwen2 decoder (arXiv:2407.10671): GQA with
q/k/v biases, rotary embeddings (rotate-half, theta from the
configuration), RMSNorm, a SwiGLU MLP and an untied lm_head.

Parameters come in the layout the benchmark draws them in: weights
(d_in, d_out) applied as x @ W, layer leaves stacked on a leading L
axis, each norm's gain stored as an offset from 1, the embedding and the
lm_head over the vocabulary padded to a multiple of 256 (the padded
classes take part in the softmax and are never a target). Everything is
computed in float32 from those values; the products go through a
`Numerics`.
"""
from __future__ import annotations

import math

import torch

HEADER = ("final_norm", "lm_head")


def dims(cfg: dict) -> dict:
    heads = cfg["num_heads"]
    return dict(d=cfg["d_model"], layers=cfg["num_layers"], heads=heads,
                kv=cfg["num_kv_heads"], hd=cfg["d_model"] // heads,
                ff=cfg["d_ff"],
                vocab=((cfg["vocab_size"] + 255) // 256) * 256)


def param_specs(cfg: dict) -> dict:
    """{name: (per-client shape, init)}: init ("normal", std) or
    ("const", value). Stds: 0.02 (d_in^-1/2 for d_in <= 64), the output
    projections scaled by (2L)^-1/2; biases and norm offsets 0."""
    k = dims(cfg)
    d, n, hd, ff, v = k["d"], k["layers"], k["hd"], k["ff"], k["vocab"]
    q, kv = k["heads"] * hd, k["kv"] * hd
    depth = 1.0 / math.sqrt(2 * n)

    def w(d_in, d_out, scale=1.0, lead=(n,)):
        std = scale * (0.02 if d_in > 64 else d_in ** -0.5)
        return (tuple(lead) + (d_in, d_out), ("normal", std))

    zero = ("const", 0.0)
    specs = {
        "embed": ((v, d), ("normal", 0.02)),
        "layers/ln1": ((n, d), zero),
        "layers/ln2": ((n, d), zero),
        "layers/attn/wq": w(d, q),
        "layers/attn/wk": w(d, kv),
        "layers/attn/wv": w(d, kv),
        "layers/attn/wo": w(q, d, depth),
        "layers/mlp/wi": w(d, ff),
        "layers/mlp/wg": w(d, ff),
        "layers/mlp/wo": w(ff, d, depth),
        "final_norm": ((d,), zero),
        "lm_head": w(d, v, lead=()),
    }
    if cfg.get("qkv_bias"):
        specs.update({"layers/attn/bq": ((n, q), zero),
                      "layers/attn/bk": ((n, kv), zero),
                      "layers/attn/bv": ((n, kv), zero)})
    return specs


def _rms(x, gain_offset, eps):
    x = x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps)
    return x * (1.0 + gain_offset.float())


def _rope(x, theta):
    """x (B, S, H, hd) rotated by position, rotate-half convention."""
    s, hd = x.shape[1], x.shape[-1]
    exps = torch.arange(0, hd // 2, dtype=torch.float64) * 2.0 / hd
    inv = (1.0 / theta ** exps).float().to(x.device)
    ang = torch.arange(s, device=x.device).float()[:, None] * inv
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def logits(p: dict, tokens, cfg: dict, num):
    """Teacher-forced logits (B, S, V_padded) in float32."""
    k = dims(cfg)
    b, s = tokens.shape
    h_, kv, hd = k["heads"], k["kv"], k["hd"]
    eps, theta = cfg["norm_eps"], cfg["rope_theta"]
    causal = torch.ones(s, s, dtype=torch.bool, device=tokens.device).tril()
    x = p["embed"][tokens.long()].float()
    for i in range(k["layers"]):
        def at(name):
            return p[name][i]

        h = _rms(x, at("layers/ln1"), eps)
        q, kk, v = (num.mm(h, at("layers/attn/w" + c)) for c in "qkv")
        if cfg.get("qkv_bias"):
            q = q + at("layers/attn/bq").float()
            kk = kk + at("layers/attn/bk").float()
            v = v + at("layers/attn/bv").float()
        q = _rope(q.view(b, s, h_, hd), theta)
        kk = _rope(kk.view(b, s, kv, hd), theta)
        kk = kk.repeat_interleave(h_ // kv, dim=2)
        v = v.view(b, s, kv, hd).repeat_interleave(h_ // kv, dim=2)
        att = torch.einsum("bqhd,bkhd->bhqk", q, kk) / math.sqrt(hd)
        att = att.masked_fill(~causal, float("-inf")).softmax(-1)
        o = torch.einsum("bhqk,bkhd->bqhd", att, v).reshape(b, s, h_ * hd)
        x = x + num.mm(o, at("layers/attn/wo"))
        h = _rms(x, at("layers/ln2"), eps)
        gate = torch.nn.functional.silu(num.mm(h, at("layers/mlp/wg")))
        x = x + num.mm(gate * num.mm(h, at("layers/mlp/wi")),
                       at("layers/mlp/wo"))
    return num.mm(_rms(x, p["final_norm"], eps), p["lm_head"])


def token_nll(p: dict, tokens, cfg: dict, num):
    """(B, S-1) float32 negative log-likelihoods of tokens 1..S-1."""
    z = logits(p, tokens, cfg, num)[:, :-1]
    return torch.logsumexp(z, -1) - z.gather(
        -1, tokens[:, 1:].long().unsqueeze(-1)).squeeze(-1)


def row_nll(p: dict, batch: dict, cfg: dict, num):
    """(B,) mean next-token cross-entropy of each row of {"tokens"}."""
    return token_nll(p, batch["tokens"], cfg, num).mean(-1)


def loss(p: dict, batch: dict, cfg: dict, num):
    """Mean next-token cross-entropy of a batch {"tokens": (B, S)}."""
    return token_nll(p, batch["tokens"], cfg, num).mean()


def batch_rows(batch: dict) -> int:
    return batch["tokens"].shape[0]
