"""Whisper-style encoder-decoder backbone (reference `repro.models.encdec`),
for serving.

The mel-spectrogram and conv frontend is a stub, as in the reference:
`frames` are precomputed (B, encoder_seq, d_model) embeddings. The
backbone is a bidirectional encoder and a causal decoder with
cross-attention; RMSNorm and RoPE as in the rest of the zoo (the
reference's documented deviation from Whisper). Layers are stacked as in
the dense family: every leaf of `params["encoder"]` and
`params["layers"]` carries a leading layer axis, and a Python loop walks
them (the reference scans).

Serving: `init_encdec_cache` runs the encoder once (backend "auto") and
projects each decoder layer's cross k/v; the decoder's self-attention
cache starts at zeros. The reference's `model.prefill` returns that cache
and takes only the logits from `encdec_forward`, so decoding from
position S attends over S zero slots; the port does the same (ROADMAP §3,
reference conditions). `encdec_forward` is the teacher-forced training
forward, → (logits, aux); `remat` recomputes each encoder and decoder
layer in the backward.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import (dense_init, embed_lookup, init_embed,
                                       mlp, rms_norm, torch_dtype)
from repro_torch.models.transformer import layer_at, run_layer, zero_aux


def _init_mlp(generator, cfg, device, depth_scale, lead):
    D, F = cfg.d_model, cfg.d_ff
    return {
        "wi": dense_init(generator, D, F, cfg.dtype, device, lead=lead),
        "wg": dense_init(generator, D, F, cfg.dtype, device, lead=lead),
        "wo": dense_init(generator, F, D, cfg.dtype, device,
                         scale=depth_scale, lead=lead),
    }


def _norm(cfg, device, lead):
    return torch.zeros(tuple(lead) + (cfg.d_model,),
                       dtype=torch_dtype(cfg.dtype), device=device)


def init_encoder_layer(generator, cfg, device, lead=()) -> dict:
    """Encoder layer(s), stacked on `lead`: ln1, attention, ln2, MLP."""
    ds = 1.0 / math.sqrt(2 * cfg.encoder_layers)
    return {
        "ln1": _norm(cfg, device, lead),
        "attn": attn_mod.init_attention(generator, cfg, device,
                                        depth_scale=ds, lead=lead),
        "ln2": _norm(cfg, device, lead),
        "mlp": _init_mlp(generator, cfg, device, ds, lead),
    }


def init_decoder_layer(generator, cfg, device, lead=()) -> dict:
    """Decoder layer(s), stacked on `lead`: self-attention, cross-attention
    and MLP, each with its pre-norm."""
    ds = 1.0 / math.sqrt(2 * cfg.num_layers)
    return {
        "ln1": _norm(cfg, device, lead),
        "attn": attn_mod.init_attention(generator, cfg, device,
                                        depth_scale=ds, lead=lead),
        "ln_cross": _norm(cfg, device, lead),
        "cross": attn_mod.init_attention(generator, cfg, device,
                                         depth_scale=ds, lead=lead),
        "ln2": _norm(cfg, device, lead),
        "mlp": _init_mlp(generator, cfg, device, ds, lead),
    }


def init_encdec(generator, cfg, device) -> dict:
    return {
        "embed": init_embed(generator, cfg.padded_vocab, cfg.d_model,
                            cfg.dtype, device),
        "encoder": init_encoder_layer(generator, cfg, device,
                                      lead=(cfg.encoder_layers,)),
        "enc_norm": _norm(cfg, device, ()),
        "layers": init_decoder_layer(generator, cfg, device,
                                     lead=(cfg.num_layers,)),
        "final_norm": _norm(cfg, device, ()),
        "lm_head": dense_init(generator, cfg.d_model, cfg.padded_vocab,
                              cfg.dtype, device),
    }


def _encoder_layer(layer, x, positions, cfg, backend):
    h = rms_norm(x, layer["ln1"], cfg.norm_eps)
    x = x + attn_mod.attention_layer(layer["attn"], h, positions, cfg,
                                     causal=False, backend=backend)
    return x + mlp(layer["mlp"], rms_norm(x, layer["ln2"], cfg.norm_eps),
                   act=cfg.act)


def encode(params, frames, cfg, *, backend="auto", remat: bool = False):
    """frames (B, Se, D) stub embeddings → encoder output (B, Se, D):
    bidirectional (non-causal) attention at every layer."""
    x = frames.to(torch_dtype(cfg.dtype))
    positions = torch.arange(x.shape[1], device=x.device)[None]
    for i in range(cfg.encoder_layers):
        x = run_layer(_encoder_layer, remat, layer_at(params["encoder"], i),
                      x, positions, cfg, backend)
    return rms_norm(x, params["enc_norm"], cfg.norm_eps)


def _decoder_layer(layer, x, enc_out, positions, cfg, backend):
    h = rms_norm(x, layer["ln1"], cfg.norm_eps)
    x = x + attn_mod.attention_layer(layer["attn"], h, positions, cfg,
                                     causal=True, backend=backend)
    h = rms_norm(x, layer["ln_cross"], cfg.norm_eps)
    ckv = attn_mod.cross_kv_from_encoder(layer["cross"], enc_out, cfg)
    x = x + attn_mod.attention_layer(layer["cross"], h, positions, cfg,
                                     cross_kv=ckv, backend=backend)
    return x + mlp(layer["mlp"], rms_norm(x, layer["ln2"], cfg.norm_eps),
                   act=cfg.act)


def encdec_forward(params, tokens, frames, cfg, *, backend="auto",
                   remat: bool = False):
    """Teacher-forced decoder over tokens (B, S) against the encoded
    frames → (logits (B, S, V), aux: both losses 0). Per decoder layer:
    causal self-attention, non-causal cross-attention (S queries over Se
    keys), MLP."""
    enc_out = encode(params, frames, cfg, backend=backend, remat=remat)
    x = embed_lookup(params["embed"], tokens)
    positions = torch.arange(tokens.shape[1], device=tokens.device)[None]
    for i in range(cfg.num_layers):
        x = run_layer(_decoder_layer, remat, layer_at(params["layers"], i),
                      x, enc_out, positions, cfg, backend)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x @ params["lm_head"], zero_aux(x.device)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def init_encdec_cache(params, frames, cfg, batch: int, max_seq: int) -> dict:
    """The decoder's zeroed self-attention cache (L, B, max_seq, K, hd)
    and every layer's cross k/v (L, B, Se, K, hd) from one encoder pass
    (backend "auto", as in the reference)."""
    enc_out = encode(params, frames, cfg)
    ks, vs = [], []
    for i in range(cfg.num_layers):
        k, v = attn_mod.cross_kv_from_encoder(
            layer_at(params["layers"], i)["cross"], enc_out, cfg)
        ks.append(k)
        vs.append(v)
    self_kv = attn_mod.init_kv_cache(cfg, batch, max_seq, frames.device,
                                     lead=(cfg.num_layers,))
    return {"self": self_kv,
            "cross": {"k": torch.stack(ks), "v": torch.stack(vs)}}


def init_encdec_cache_shapes(cfg, batch: int, max_seq: int, device) -> dict:
    """The cache's skeleton in zeros, without running the encoder."""
    lead = (cfg.num_layers,)
    return {
        "self": attn_mod.init_kv_cache(cfg, batch, max_seq, device,
                                       lead=lead),
        "cross": attn_mod.init_kv_cache(cfg, batch, cfg.encoder_seq, device,
                                        lead=lead),
    }


def encdec_decode_step(params, cache, tokens, pos: int, cfg):
    """One decoder token, tokens (B, 1), at position pos: self-attention
    on the cache (written in place), cross-attention against the fixed
    encoder k/v (naive scores). → (logits (B, 1, V), the same cache)."""
    x = embed_lookup(params["embed"], tokens)
    b = x.shape[0]
    H, hd = cfg.num_heads, cfg.head_dim
    for i in range(cfg.num_layers):
        layer = layer_at(params["layers"], i)
        h = rms_norm(x, layer["ln1"], cfg.norm_eps)
        h, _ = attn_mod.attention_decode(
            layer["attn"], h, {"k": cache["self"]["k"][i],
                               "v": cache["self"]["v"][i]}, pos, cfg)
        x = x + h
        h = rms_norm(x, layer["ln_cross"], cfg.norm_eps)
        q = (h @ layer["cross"]["wq"]).reshape(b, 1, H, hd)
        o = attn_mod.attend(q, cache["cross"]["k"][i],
                            cache["cross"]["v"][i], causal=False,
                            backend="naive")
        x = x + o.reshape(b, 1, H * hd) @ layer["cross"]["wo"]
        x = x + mlp(layer["mlp"], rms_norm(x, layer["ln2"], cfg.norm_eps),
                    act=cfg.act)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x @ params["lm_head"], cache
