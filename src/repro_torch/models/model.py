"""Model API — reference `repro.models.model`: family dispatch for init,
the training forward and losses, serving, and the analytic parameter
count.

batch dicts: cnn {"images": (B, H, W, C), "labels": (B,) int}; the LLM
families {"tokens": (B, S) int}, the vlm family optionally with
{"prefix_embeds": (B, P, D)}, the audio family with {"frames": (B,
encoder_seq, d_model)}. Every family trains (forward, loss_fn,
eval_loss, accuracy): the LLM loss is next-token cross-entropy over the
text positions (a prefix's positions are cut off), plus the MoE aux
losses weighted by AUX_WEIGHTS. Every LLM family serves (init_cache,
prefill, decode_step): dense, moe, vlm (text tokens only, as the
reference's `prefill`), ssm, hybrid and audio. `count_params` covers
every family.

backend: "auto" (attention: "naive" up to 4096² scores, else
"chunked"; rwkv: the per-token recurrence), "naive", "chunked" or
"flash" (the kernels: forward only, they have no backward).
"""
from __future__ import annotations

import torch

from repro_torch.models import cnn as cnn_mod
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import hybrid as hybrid_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models import transformer as tf_mod
from repro_torch.models.layers import cross_entropy_loss, per_example_nll

AUX_WEIGHTS = {"load_balance": 0.01, "router_z": 0.001}


def _check_serving(cfg):
    if cfg.family == "cnn":
        raise ValueError("cnn has no decode step")


def init_params(cfg, generator: torch.Generator, device) -> dict:
    """Random parameters drawn from `generator` on `device`."""
    if cfg.family == "cnn":
        return cnn_mod.init_cnn(cfg, generator, device)
    if cfg.family == "ssm":
        return rwkv_mod.init_rwkv(generator, cfg, device)
    if cfg.family == "hybrid":
        return hybrid_mod.init_hybrid(generator, cfg, device)
    if cfg.family == "audio":
        return encdec_mod.init_encdec(generator, cfg, device)
    return tf_mod.init_decoder(generator, cfg, device)


# ---------------------------------------------------------------------------
# forward / losses
# ---------------------------------------------------------------------------

def forward(cfg, params, batch, *, backend="auto", remat=False):
    """→ (logits, aux). The cnn's logits are (B, num_classes) and its aux
    empty; an LLM's (B, S_total, V) with aux {load_balance, router_z}."""
    if cfg.family == "cnn":
        return cnn_mod.cnn_forward(params, batch["images"], cfg), {}
    if cfg.family == "ssm":
        return rwkv_mod.rwkv_forward(params, batch["tokens"], cfg,
                                     remat=remat,
                                     wkv_fn=rwkv_mod.wkv_route(backend))
    if cfg.family == "hybrid":
        return hybrid_mod.hybrid_forward(params, batch["tokens"], cfg,
                                         backend=backend, remat=remat)
    if cfg.family == "audio":
        return encdec_mod.encdec_forward(params, batch["tokens"],
                                         batch["frames"], cfg,
                                         backend=backend, remat=remat)
    return tf_mod.decoder_forward(params, batch["tokens"], cfg,
                                  prefix_embeds=batch.get("prefix_embeds"),
                                  backend=backend, remat=remat)


def _text_logits(logits, tokens):
    """The logits that predict text tokens 1..S−1: after a prefix of P
    positions, text token t+1 is predicted at position P + t."""
    p = logits.shape[1] - tokens.shape[1]
    return logits[:, p:p + tokens.shape[1] - 1]


def loss_fn(cfg, params, batch, *, backend="auto", remat=False):
    """→ (total, metrics): the objective the training steps differentiate.
    For an LLM, total = next-token loss + Σ AUX_WEIGHTS[k]·aux[k] and the
    metrics hold the loss and each aux term; for the cnn, total = the
    cross-entropy and the metrics hold it and the accuracy."""
    logits, aux = forward(cfg, params, batch, backend=backend, remat=remat)
    if cfg.family == "cnn":
        loss = cross_entropy_loss(logits, batch["labels"])
        acc = (logits.argmax(-1) == batch["labels"]).float().mean()
        return loss, {"loss": loss, "accuracy": acc}
    tokens = batch["tokens"]
    loss = cross_entropy_loss(_text_logits(logits, tokens), tokens[:, 1:])
    total, metrics = loss, {"loss": loss}
    for k, w in AUX_WEIGHTS.items():
        if k in aux:
            total = total + w * aux[k]
            metrics[k] = aux[k]
    return total, metrics


def eval_loss(cfg, params, batch, *, backend="auto"):
    """Pure task loss, no aux — the s_l scoring signal (paper Eq. 6)."""
    logits, _ = forward(cfg, params, batch, backend=backend)
    if cfg.family == "cnn":
        return cross_entropy_loss(logits, batch["labels"])
    tokens = batch["tokens"]
    return cross_entropy_loss(_text_logits(logits, tokens), tokens[:, 1:])


def eval_loss_probes(cfg, params, probes: dict, *, backend="auto"):
    """Eq. 6 over G probe batches: probes a dict of (G, B, ...) tensors →
    (G,) per-batch `eval_loss`. Families without coupling across a
    batch's examples (every one but the MoE) take all G batches in one
    forward; the MoE's capacity and drops depend on the tokens of the
    call (`moe.moe_layer`), so it takes one forward per batch, as the
    reference evaluates each batch alone."""
    g = next(iter(probes.values())).shape[0]
    if cfg.num_experts:
        return torch.stack([eval_loss(cfg, params,
                                      {k: v[j] for k, v in probes.items()},
                                      backend=backend) for j in range(g)])
    flat = {k: v.reshape((-1,) + v.shape[2:]) for k, v in probes.items()}
    logits, _ = forward(cfg, params, flat, backend=backend)
    if cfg.family == "cnn":
        nll = per_example_nll(logits, flat["labels"])
    else:
        tokens = flat["tokens"]
        nll = per_example_nll(_text_logits(logits, tokens), tokens[:, 1:])
    return nll.reshape(g, -1).mean(1)


def accuracy(cfg, params, batch):
    """Classification accuracy (cnn) or next-token accuracy (LLM)."""
    logits, _ = forward(cfg, params, batch)
    if cfg.family == "cnn":
        return (logits.argmax(-1) == batch["labels"]).float().mean()
    tokens = batch["tokens"]
    pred = _text_logits(logits, tokens).argmax(-1)
    return (pred == tokens[:, 1:]).float().mean()


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
        logits, _ = encdec_mod.encdec_forward(params, tokens,
                                              batch["frames"], cfg,
                                              backend=backend)
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
