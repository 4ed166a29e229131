"""Model API — reference `repro.models.model`: the cnn branch, the
serving branches of the LLM families, and the analytic parameter count.

batch dicts: cnn {"images": (B, H, W, C), "labels": (B,) int}; the LLM
families {"tokens": (B, S) int}, and for the audio family also
{"frames": (B, encoder_seq, d_model)}. The cnn trains (forward, losses);
every LLM family serves (init_cache, prefill, decode_step): dense, moe,
vlm (text tokens only, as the reference's `prefill`), ssm, hybrid and
audio. LLM training is not ported (ROADMAP queue 1 item 12).
`count_params` covers every family.
"""
from __future__ import annotations

import torch

from repro_torch.models import cnn as cnn_mod
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import hybrid as hybrid_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models import transformer as tf_mod
from repro_torch.models.layers import cross_entropy_loss, per_example_nll

def _check_family(cfg):
    if cfg.family != "cnn":
        raise NotImplementedError(
            f"training of the {cfg.family!r} family is not ported "
            "(ROADMAP queue 1 item 12)")


def _check_serving(cfg):
    if cfg.family == "cnn":
        raise ValueError("cnn has no decode step")


def init_params(cfg, generator: torch.Generator, device) -> dict:
    """Random parameters drawn from `generator` on `device`."""
    if cfg.family == "cnn":
        return cnn_mod.init_cnn(cfg, generator, device)
    _check_serving(cfg)
    if cfg.family == "ssm":
        return rwkv_mod.init_rwkv(generator, cfg, device)
    if cfg.family == "hybrid":
        return hybrid_mod.init_hybrid(generator, cfg, device)
    if cfg.family == "audio":
        return encdec_mod.init_encdec(generator, cfg, device)
    return tf_mod.init_decoder(generator, cfg, device)


def forward(cfg, params, batch):
    """→ logits (B, num_classes) in the parameters' dtype."""
    _check_family(cfg)
    return cnn_mod.cnn_forward(params, batch["images"], cfg)


def loss_fn(cfg, params, batch):
    """→ (loss, metrics dict) — the training objective."""
    logits = forward(cfg, params, batch)
    loss = cross_entropy_loss(logits, batch["labels"])
    acc = (logits.argmax(-1) == batch["labels"]).float().mean()
    return loss, {"loss": loss, "accuracy": acc}


def eval_loss(cfg, params, batch):
    """Pure task loss — the s_l scoring signal (paper Eq. 6)."""
    return cross_entropy_loss(forward(cfg, params, batch), batch["labels"])


def eval_loss_grouped(cfg, params, images, labels):
    """Eq. 6 over G probe batches in one forward: images (G, B, H, W, C),
    labels (G, B) → (G,) per-batch mean losses. Equal to G calls of
    `eval_loss` (the CNN has no cross-example coupling)."""
    g, b = labels.shape
    logits = forward(cfg, params,
                     {"images": images.reshape((g * b,) + images.shape[2:])})
    return per_example_nll(logits, labels.reshape(-1)).reshape(g, b).mean(1)


def accuracy(cfg, params, batch):
    logits = forward(cfg, params, batch)
    return (logits.argmax(-1) == batch["labels"]).float().mean()


# ---------------------------------------------------------------------------
# serving (dense, moe, vlm, ssm, hybrid, audio)
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, max_seq: int, device):
    """Decode state: the stacked KV cache of length max_seq (dense, moe,
    vlm; MLA's latent cache for deepseek), the O(1) recurrent state (ssm), the LRU states and window rings (hybrid),
    or the decoder's self-cache and cross-k/v buffers (audio)."""
    _check_serving(cfg)
    if cfg.family == "ssm":
        return rwkv_mod.init_rwkv_model_state(cfg, batch, device)
    if cfg.family == "hybrid":
        return hybrid_mod.init_hybrid_state(cfg, batch, device)
    if cfg.family == "audio":
        return encdec_mod.init_encdec_cache_shapes(cfg, batch, max_seq,
                                                   device)
    return tf_mod.init_decoder_cache(cfg, batch, max_seq, device)


def decode_step(cfg, params, cache, tokens, pos: int):
    """One-token serve step: (logits (B, 1, V), new cache). KV caches and
    window rings are updated in place."""
    _check_serving(cfg)
    if cfg.family == "ssm":
        return rwkv_mod.rwkv_decode_step(params, cache, tokens, pos, cfg)
    if cfg.family == "hybrid":
        return hybrid_mod.hybrid_decode_step(params, cache, tokens, pos, cfg)
    if cfg.family == "audio":
        return encdec_mod.encdec_decode_step(params, cache, tokens, pos, cfg)
    return tf_mod.decoder_decode_step(params, cache, tokens, pos, cfg)


def prefill(cfg, params, batch, *, max_seq: int, backend="flash"):
    """Prefill returning (logits (B, S, V), cache/state). backend "flash"
    reaches the kernels (attention or WKV), "naive" the plain paths. The
    audio family's cache is `init_encdec_cache`'s (a zeroed decoder
    self-cache, as in the reference) and its logits `encdec_forward`'s."""
    _check_serving(cfg)
    tokens = batch["tokens"]
    if cfg.family == "ssm":
        return rwkv_mod.rwkv_prefill(params, tokens, cfg, backend=backend)
    if cfg.family == "hybrid":
        return hybrid_mod.hybrid_prefill(params, tokens, cfg,
                                         backend=backend)
    if cfg.family == "audio":
        cache = encdec_mod.init_encdec_cache(params, batch["frames"], cfg,
                                             tokens.shape[0], max_seq)
        logits = encdec_mod.encdec_forward(params, tokens, batch["frames"],
                                           cfg, backend=backend)
        return logits, cache
    return tf_mod.decoder_prefill(params, tokens, cfg, max_seq=max_seq,
                                  backend=backend)


# ---------------------------------------------------------------------------
# analytic parameter counts
# ---------------------------------------------------------------------------

def count_params(cfg, active_only: bool = False) -> int:
    """Parameters of `cfg` by arithmetic on its fields (reference
    `count_params`); with active_only, a MoE counts only the experts a
    token reaches."""
    D, F, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    if cfg.family == "cnn":
        widths = [cfg.cnn_width * (2**i) for i in range(len(cfg.cnn_stages))]
        total = 3 * 3 * cfg.image_channels * widths[0]
        cin = widths[0]
        for n, cout in zip(cfg.cnn_stages, widths):
            for _ in range(n):
                total += 9 * cin * cout + 9 * cout * cout
                if cin != cout:
                    total += cin * cout
                cin = cout
        return total + cin * cfg.num_classes

    embed_head = 2 * V * D

    if cfg.family == "ssm":
        time = 5 * D * D + D * 5 * 32 + 5 * 32 * D + D * 64 + 64 * D + 2 * D
        chan = D * F + F * D + D * D
        return cfg.num_layers * (time + chan) + embed_head

    if cfg.family == "hybrid":
        W = cfg.lru_width
        rec = 2 * D * W + 2 * W * W + W * D + 4 * W
        attn = D * H * hd + 2 * D * K * hd + H * hd * D
        mlp_p = 3 * D * F
        n_rec = sum(1 for k in cfg.block_pattern if k == "rec")
        n_attn = cfg.num_layers - n_rec
        return n_rec * (rec + mlp_p) + n_attn * (attn + mlp_p) + embed_head

    if cfg.family == "audio":
        attn = D * H * hd + 2 * D * K * hd + H * hd * D
        mlp_p = 3 * D * F
        enc = cfg.encoder_layers * (attn + mlp_p)
        dec = cfg.num_layers * (2 * attn + mlp_p)
        return enc + dec + embed_head

    # dense / moe / vlm
    if cfg.use_mla:
        nope, rope_d, v_d = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                             cfg.v_head_dim)
        attn = (D * cfg.q_lora_rank
                + cfg.q_lora_rank * H * (nope + rope_d)
                + D * (cfg.kv_lora_rank + rope_d)
                + cfg.kv_lora_rank * H * (nope + v_d)
                + H * v_d * D)
    else:
        attn = D * H * hd + 2 * D * K * hd + H * hd * D

    if cfg.num_experts:
        e_eff = ((cfg.num_experts_per_tok if active_only
                  else cfg.num_experts) + cfg.num_shared_experts)
        ffn = D * cfg.num_experts + e_eff * 3 * D * cfg.moe_d_ff
    else:
        ffn = 3 * D * F
    return cfg.num_layers * (attn + ffn) + embed_head
