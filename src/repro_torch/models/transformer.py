"""Decoder-only transformer, dense branch (reference
`repro.models.transformer`): init, the KV cache, one-token decode and the
prefill that fills the cache.

Layers are stacked as in the reference — every leaf of
`params["layers"]` carries a leading L axis — and a Python loop walks
them (the reference scans). MoE, MLA and the vision projector are not
ported (ROADMAP queue 1 item 12); the reference's `constrain_act` is the
identity without a mesh and is dropped.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import (apply_rope, dense_init, embed_lookup,
                                       init_embed, mlp, rms_norm,
                                       torch_dtype)


def layer_at(layers: dict, i: int) -> dict:
    """Layer i of a stacked (L, …) tree (views, no copies)."""
    return {k: layer_at(v, i) if isinstance(v, dict) else v[i]
            for k, v in layers.items()}


def init_layers(generator, cfg, device) -> dict:
    """All L decoder layers, stacked: ln1/ln2, attention, gated MLP."""
    D, L = cfg.d_model, cfg.num_layers
    dt = torch_dtype(cfg.dtype)
    depth_scale = 1.0 / math.sqrt(2 * L)
    lead = (L,)
    return {
        "ln1": torch.zeros((L, D), dtype=dt, device=device),
        "ln2": torch.zeros((L, D), dtype=dt, device=device),
        "attn": attn_mod.init_attention(generator, cfg, device,
                                        depth_scale=depth_scale, lead=lead),
        "mlp": {
            "wi": dense_init(generator, D, cfg.d_ff, cfg.dtype, device,
                             lead=lead),
            "wg": dense_init(generator, D, cfg.d_ff, cfg.dtype, device,
                             lead=lead),
            "wo": dense_init(generator, cfg.d_ff, D, cfg.dtype, device,
                             scale=depth_scale, lead=lead),
        },
    }


def init_decoder(generator, cfg, device) -> dict:
    if cfg.family != "dense":
        raise NotImplementedError(f"decoder family {cfg.family!r} is not "
                                  "ported (ROADMAP queue 1 item 12)")
    return {
        "embed": init_embed(generator, cfg.padded_vocab, cfg.d_model,
                            cfg.dtype, device),
        "layers": init_layers(generator, cfg, device),
        "final_norm": torch.zeros((cfg.d_model,), dtype=torch_dtype(
            cfg.dtype), device=device),
        "lm_head": dense_init(generator, cfg.d_model, cfg.padded_vocab,
                              cfg.dtype, device),
    }


def _head(params, x, cfg):
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x @ params["lm_head"]


def init_decoder_cache(cfg, batch: int, max_seq: int, device):
    """Stacked (L, B, max_seq, K, hd) k and v buffers."""
    return attn_mod.init_kv_cache(cfg, batch, max_seq, device,
                                  lead=(cfg.num_layers,))


def decoder_decode_step(params, cache, tokens, pos: int, cfg):
    """One-token decode. tokens (B, 1); pos the absolute position.
    The cache is updated in place. → (logits (B, 1, V), cache)."""
    x = embed_lookup(params["embed"], tokens)
    for i in range(cfg.num_layers):
        layer = layer_at(params["layers"], i)
        h = rms_norm(x, layer["ln1"], cfg.norm_eps)
        h, _ = attn_mod.attention_decode(
            layer["attn"], h, {"k": cache["k"][i], "v": cache["v"][i]}, pos,
            cfg)
        x = x + h
        x = x + mlp(layer["mlp"], rms_norm(x, layer["ln2"], cfg.norm_eps),
                    act=cfg.act)
    return _head(params, x, cfg), cache


def decoder_prefill(params, tokens, cfg, *, max_seq: int, backend="auto"):
    """Full prefill of tokens (B, S). → (logits (B, S, V), cache with k/v
    (L, B, max_seq, K, hd) filled up to S, zeros after)."""
    b, s = tokens.shape
    x = embed_lookup(params["embed"], tokens)
    positions = torch.arange(s, device=tokens.device)[None]
    cache = init_decoder_cache(cfg, b, max_seq, tokens.device)
    for i in range(cfg.num_layers):
        layer = layer_at(params["layers"], i)
        h = rms_norm(x, layer["ln1"], cfg.norm_eps)
        q, k, v = attn_mod.qkv_proj(layer["attn"], h, cfg)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        o = attn_mod.attend(q, k, v, causal=True, backend=backend)
        x = x + o.reshape(b, s, -1) @ layer["attn"]["wo"]
        cache["k"][i, :, :s] = k
        cache["v"][i, :, :s] = v
        x = x + mlp(layer["mlp"], rms_norm(x, layer["ln2"], cfg.norm_eps),
                    act=cfg.act)
    return _head(params, x, cfg), cache
