"""Decoder-only transformer — dense, MoE and MLA layers, and the vlm
family's text path (reference `repro.models.transformer`): init, the KV
(or MLA latent) cache, one-token decode and the prefill that fills the
cache.

Layers are stacked as in the reference — every leaf of
`params["layers"]` carries a leading L axis — and a Python loop walks
them (the reference scans). A layer's attention is GQA or, with
`cfg.use_mla`, MLA; its FFN the gated MLP or, with `cfg.num_experts`,
`moe.moe_layer` (its aux dict discarded, as the reference's serving
does) in serving; `decoder_forward` (training) sums the MoE aux losses
over the layers. The vlm family's `vision_proj` is read only by
`decoder_forward` with prefix embeddings, as in the reference. `remat`
recomputes each layer in the backward
(`torch.utils.checkpoint.checkpoint`, non-reentrant), the reference's
`jax.checkpoint` with nothing saveable. The reference's `constrain_act`
is the identity without a mesh and is dropped.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import (apply_rope, dense_init, embed_lookup,
                                       init_embed, mlp, rms_norm,
                                       torch_dtype)


def layer_at(layers: dict, i: int) -> dict:
    """Layer i of a stacked (L, …) tree (views, no copies)."""
    return {k: layer_at(v, i) if isinstance(v, dict) else v[i]
            for k, v in layers.items()}


def init_layers(generator, cfg, device) -> dict:
    """All L decoder layers, stacked: ln1/ln2, attention (GQA or MLA) and
    the FFN (gated MLP or MoE)."""
    D, L = cfg.d_model, cfg.num_layers
    dt = torch_dtype(cfg.dtype)
    depth_scale = 1.0 / math.sqrt(2 * L)
    lead = (L,)
    layers = {
        "ln1": torch.zeros((L, D), dtype=dt, device=device),
        "ln2": torch.zeros((L, D), dtype=dt, device=device),
    }
    if cfg.use_mla:
        layers["attn"] = attn_mod.init_mla(generator, cfg, device,
                                           depth_scale=depth_scale,
                                           lead=lead)
    else:
        layers["attn"] = attn_mod.init_attention(generator, cfg, device,
                                                 depth_scale=depth_scale,
                                                 lead=lead)
    if cfg.num_experts:
        layers["moe"] = moe_mod.init_moe(generator, cfg, device,
                                         depth_scale=depth_scale, lead=lead)
    else:
        layers["mlp"] = {
            "wi": dense_init(generator, D, cfg.d_ff, cfg.dtype, device,
                             lead=lead),
            "wg": dense_init(generator, D, cfg.d_ff, cfg.dtype, device,
                             lead=lead),
            "wo": dense_init(generator, cfg.d_ff, D, cfg.dtype, device,
                             scale=depth_scale, lead=lead),
        }
    return layers


def init_decoder(generator, cfg, device) -> dict:
    """The dense, moe and vlm families' parameters (with `vision_proj` for
    a vision stub frontend)."""
    params = {
        "embed": init_embed(generator, cfg.padded_vocab, cfg.d_model,
                            cfg.dtype, device),
        "layers": init_layers(generator, cfg, device),
        "final_norm": torch.zeros((cfg.d_model,), dtype=torch_dtype(
            cfg.dtype), device=device),
        "lm_head": dense_init(generator, cfg.d_model, cfg.padded_vocab,
                              cfg.dtype, device),
    }
    if cfg.frontend == "vision_stub":
        # the projector from the stub's patch embeddings into the residual
        # stream (the ViT itself is stubbed in the reference)
        params["vision_proj"] = dense_init(generator, cfg.d_model,
                                           cfg.d_model, cfg.dtype, device,
                                           sliced=True)
    return params


def _head(params, x, cfg):
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x @ params["lm_head"]


def _ffn(layer, x, cfg):
    """The layer's FFN on its normed input: the gated MLP or the MoE."""
    if cfg.num_experts:
        return moe_mod.moe_layer(layer["moe"], x, cfg)[0]
    return mlp(layer["mlp"], x, act=cfg.act)


def zero_aux(device) -> dict:
    """The aux dict of a family without a router: both losses 0 (f32)."""
    z = torch.zeros((), dtype=torch.float32, device=device)
    return {"load_balance": z, "router_z": z.clone()}


def run_layer(fn, remat: bool, *args):
    """fn(*args), recomputed in the backward when `remat` (the
    reference's `jax.checkpoint(..., nothing_saveable)` of a layer)."""
    if remat:
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _layer_train(layer, x, cfg, backend):
    """One decoder layer over a full sequence → (x, aux) with the MoE
    layer's aux losses in f32 (zeros for the gated MLP)."""
    positions = torch.arange(x.shape[1], device=x.device)[None]
    h = rms_norm(x, layer["ln1"], cfg.norm_eps)
    if cfg.use_mla:
        h = attn_mod.mla_layer(layer["attn"], h, positions, cfg,
                               backend=backend)
    else:
        h = attn_mod.attention_layer(layer["attn"], h, positions, cfg,
                                     causal=True, backend=backend)
    x = x + h
    h = rms_norm(x, layer["ln2"], cfg.norm_eps)
    if cfg.num_experts:
        h, aux = moe_mod.moe_layer(layer["moe"], h, cfg)
        aux = {k: v.float() for k, v in aux.items()}
    else:
        h = mlp(layer["mlp"], h, act=cfg.act)
        aux = zero_aux(x.device)
    return x + h, aux


def sum_aux(auxs: list) -> dict:
    """The layers' aux dicts summed key by key (the reference sums the
    scanned (L,) stack)."""
    return {k: torch.stack([a[k] for a in auxs]).sum() for k in auxs[0]}


def decoder_forward(params, tokens, cfg, *, prefix_embeds=None,
                    backend: str = "auto", remat: bool = False):
    """Teacher-forced forward of tokens (B, S_text), after an optional
    prefix (B, S_pre, D) projected by `vision_proj` where the model has
    one. → (logits (B, S_pre + S_text, V), aux {load_balance, router_z}
    summed over the layers)."""
    x = embed_lookup(params["embed"], tokens)
    if prefix_embeds is not None:
        pe = prefix_embeds.to(x.dtype)
        if "vision_proj" in params:
            pe = pe @ params["vision_proj"]
        x = torch.cat([pe, x], dim=1)
    auxs = []
    for i in range(cfg.num_layers):
        x, aux = run_layer(_layer_train, remat,
                           layer_at(params["layers"], i), x, cfg, backend)
        auxs.append(aux)
    return _head(params, x, cfg), sum_aux(auxs)


def init_decoder_cache(cfg, batch: int, max_seq: int, device):
    """Stacked (L, B, max_seq, K, hd) k and v buffers, or with MLA the
    latent cache: c_kv (L, B, max_seq, kv_rank) and k_rope (L, B,
    max_seq, rope)."""
    if cfg.use_mla:
        return attn_mod.init_mla_cache(cfg, batch, max_seq, device,
                                       lead=(cfg.num_layers,))
    return attn_mod.init_kv_cache(cfg, batch, max_seq, device,
                                  lead=(cfg.num_layers,))


def decoder_decode_step(params, cache, tokens, pos: int, cfg):
    """One-token decode. tokens (B, 1); pos the absolute position.
    The cache is updated in place. → (logits (B, 1, V), cache)."""
    x = embed_lookup(params["embed"], tokens)
    for i in range(cfg.num_layers):
        layer = layer_at(params["layers"], i)
        h = rms_norm(x, layer["ln1"], cfg.norm_eps)
        cache_l = {name: buf[i] for name, buf in cache.items()}
        if cfg.use_mla:
            h, _ = attn_mod.mla_decode(layer["attn"], h, cache_l, pos, cfg)
        else:
            h, _ = attn_mod.attention_decode(layer["attn"], h, cache_l, pos,
                                             cfg)
        x = x + h
        x = x + _ffn(layer, rms_norm(x, layer["ln2"], cfg.norm_eps), cfg)
    return _head(params, x, cfg), cache


def decoder_prefill(params, tokens, cfg, *, max_seq: int, backend="auto"):
    """Full prefill of tokens (B, S). → (logits (B, S, V), the cache of
    `init_decoder_cache` filled up to S, zeros after: k/v, or MLA's
    c_kv and k_rope)."""
    b, s = tokens.shape
    x = embed_lookup(params["embed"], tokens)
    positions = torch.arange(s, device=tokens.device)[None]
    cache = init_decoder_cache(cfg, b, max_seq, tokens.device)
    for i in range(cfg.num_layers):
        layer = layer_at(params["layers"], i)
        h = rms_norm(x, layer["ln1"], cfg.norm_eps)
        if cfg.use_mla:
            q, k, v, c_kv, k_rope = attn_mod.mla_qkv_full(
                layer["attn"], h, positions, cfg)
            cache["c_kv"][i, :, :s] = c_kv
            cache["k_rope"][i, :, :s] = k_rope
        else:
            q, k, v = attn_mod.qkv_proj(layer["attn"], h, cfg)
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
            cache["k"][i, :, :s] = k
            cache["v"][i, :, :s] = v
        o = attn_mod.attend(q, k, v, causal=True, backend=backend)
        del q, k, v         # freed before the FFN's (MoE) buffers
        x = x + o.reshape(b, s, -1) @ layer["attn"]["wo"]
        x = x + _ffn(layer, rms_norm(x, layer["ln2"], cfg.norm_eps), cfg)
    return _head(params, x, cfg), cache
