"""RecurrentGemma-style hybrid stack: RG-LRU and local attention in the
config's `block_pattern` (reference `repro.models.hybrid`), for serving.

The layers are heterogeneous, so `params["layers"]` is a Python list of
per-layer dicts (not stacked). Every layer is a temporal block (rec: the
RG-LRU block; attn: sliding-window attention over `window_size` keys)
plus a gated MLP, with pre-norms. The decode state is O(window + lru
width), whatever the context: per rec layer the LRU state, per attn layer
a window-sized ring KV cache written at pos % window. The prefill leaves
the same ring layout (`_fill_ring`), so decoding continues from it.

`hybrid_forward` is the teacher-forced training forward (`remat`
recomputes each layer in the backward).
"""
from __future__ import annotations

import math

import torch

from repro_torch.models import attention as attn_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models.layers import (apply_rope, dense_init, embed_lookup,
                                       init_embed, mlp, rms_norm,
                                       torch_dtype)
from repro_torch.models.transformer import run_layer, zero_aux


def init_hybrid_layer(generator, cfg, kind: str, device) -> dict:
    D = cfg.d_model
    dt = torch_dtype(cfg.dtype)
    ds = 1.0 / math.sqrt(2 * cfg.num_layers)
    layer = {"ln1": torch.zeros((D,), dtype=dt, device=device),
             "ln2": torch.zeros((D,), dtype=dt, device=device)}
    if kind == "rec":
        layer["temporal"] = rglru_mod.init_rglru_block(generator, cfg, device,
                                                       depth_scale=ds)
    else:
        layer["temporal"] = attn_mod.init_attention(generator, cfg, device,
                                                    depth_scale=ds)
    layer["mlp"] = {
        "wi": dense_init(generator, D, cfg.d_ff, cfg.dtype, device),
        "wg": dense_init(generator, D, cfg.d_ff, cfg.dtype, device),
        "wo": dense_init(generator, cfg.d_ff, D, cfg.dtype, device,
                         scale=ds),
    }
    return layer


def init_hybrid(generator, cfg, device) -> dict:
    return {
        "embed": init_embed(generator, cfg.padded_vocab, cfg.d_model,
                            cfg.dtype, device),
        "layers": [init_hybrid_layer(generator, cfg, kind, device)
                   for kind in cfg.block_pattern],
        "final_norm": torch.zeros((cfg.d_model,),
                                  dtype=torch_dtype(cfg.dtype),
                                  device=device),
        "lm_head": dense_init(generator, cfg.d_model, cfg.padded_vocab,
                              cfg.dtype, device),
    }


def init_hybrid_state(cfg, batch: int, device) -> list:
    """Per-layer decode state list: the LRU state of a rec layer, the
    zeroed (B, window, K, hd) ring cache of an attn layer."""
    states = []
    for kind in cfg.block_pattern:
        if kind == "rec":
            states.append(rglru_mod.init_rglru_state(cfg, batch, device))
        else:
            states.append(attn_mod.init_kv_cache(cfg, batch,
                                                 cfg.window_size, device))
    return states


def _fill_ring(k, window: int):
    """The last min(window, S) entries of k (B, S, K, hd), laid out at the
    ring slots (pos % window) that the decode step writes; zeros in the
    slots no position has reached."""
    b, s = k.shape[:2]
    w = min(window, s)
    slots = torch.arange(s - w, s, device=k.device) % window
    ring = k.new_zeros((b, window) + tuple(k.shape[2:]))
    ring[:, slots] = k[:, s - w:]
    return ring


def _head(params, x, cfg):
    return rms_norm(x, params["final_norm"], cfg.norm_eps) @ params["lm_head"]


def _layer_full(layer, kind, x, cfg, backend):
    """One layer over a full sequence (training)."""
    h = rms_norm(x, layer["ln1"], cfg.norm_eps)
    if kind == "rec":
        h, _ = rglru_mod.rglru_block(layer["temporal"], h)
    else:
        positions = torch.arange(x.shape[1], device=x.device)[None]
        h = attn_mod.attention_layer(layer["temporal"], h, positions, cfg,
                                     causal=True, window=cfg.window_size,
                                     backend=backend)
    x = x + h
    return x + mlp(layer["mlp"], rms_norm(x, layer["ln2"], cfg.norm_eps),
                   act=cfg.act)


def hybrid_forward(params, tokens, cfg, *, backend="auto",
                   remat: bool = False):
    """Teacher-forced forward of tokens (B, S) → (logits (B, S, V), aux:
    both losses 0)."""
    x = embed_lookup(params["embed"], tokens)
    for layer, kind in zip(params["layers"], cfg.block_pattern):
        x = run_layer(_layer_full, remat, layer, kind, x, cfg, backend)
    return _head(params, x, cfg), zero_aux(x.device)


def hybrid_prefill(params, tokens, cfg, *, backend="auto"):
    """Prefill of tokens (B, S) → (logits (B, S, V), decode state): the
    LRU states carried exactly, each local-attention layer's last
    `window` keys and values in the ring layout. The state does not
    depend on a maximal length."""
    x = embed_lookup(params["embed"], tokens)
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device)[None]
    dt = torch_dtype(cfg.dtype)
    states = []
    for layer, kind in zip(params["layers"], cfg.block_pattern):
        h = rms_norm(x, layer["ln1"], cfg.norm_eps)
        if kind == "rec":
            h, st = rglru_mod.rglru_block(layer["temporal"], h)
        else:
            q, k, v = attn_mod.qkv_proj(layer["temporal"], h, cfg)
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
            o = attn_mod.attend(q, k, v, causal=True, window=cfg.window_size,
                                backend=backend)
            h = o.reshape(b, s, -1) @ layer["temporal"]["wo"]
            st = {"k": _fill_ring(k.to(dt), cfg.window_size),
                  "v": _fill_ring(v.to(dt), cfg.window_size)}
        x = x + h
        x = x + mlp(layer["mlp"], rms_norm(x, layer["ln2"], cfg.norm_eps),
                    act=cfg.act)
        states.append(st)
    return _head(params, x, cfg), states


def hybrid_decode_step(params, state, tokens, pos: int, cfg):
    """One-token decode, tokens (B, 1), at absolute position pos. The ring
    caches are written in place; the LRU states are replaced.
    → (logits (B, 1, V), the new state list)."""
    x = embed_lookup(params["embed"], tokens)
    new_states = []
    for layer, st, kind in zip(params["layers"], state, cfg.block_pattern):
        h = rms_norm(x, layer["ln1"], cfg.norm_eps)
        if kind == "rec":
            h, st = rglru_mod.rglru_block_step(layer["temporal"], h, st)
        else:
            h, st = attn_mod.attention_decode(layer["temporal"], h, st, pos,
                                              cfg, window=cfg.window_size)
        x = x + h
        x = x + mlp(layer["mlp"], rms_norm(x, layer["ln2"], cfg.norm_eps),
                    act=cfg.act)
        new_states.append(st)
    return _head(params, x, cfg), new_states
