"""Model API — the cnn, dense and ssm branches of reference
`repro.models.model`.

batch dicts: cnn {"images": (B, H, W, C), "labels": (B,) int}; the LLM
families {"tokens": (B, S) int}. The cnn trains (forward, losses); the
dense and ssm families serve (init_cache, prefill, decode_step). The
moe, hybrid, audio and vlm families are not ported (ROADMAP queue 1
item 12).
"""
from __future__ import annotations

import torch

from repro_torch.models import cnn as cnn_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models import transformer as tf_mod
from repro_torch.models.layers import cross_entropy_loss, per_example_nll

SERVING_FAMILIES = ("dense", "ssm")


def _unported(cfg):
    return NotImplementedError(
        f"family {cfg.family!r} is not ported (ROADMAP queue 1 item 12)")


def _check_family(cfg):
    if cfg.family != "cnn":
        raise _unported(cfg)


def _check_serving(cfg):
    if cfg.family == "cnn":
        raise ValueError("cnn has no decode step")
    if cfg.family not in SERVING_FAMILIES:
        raise _unported(cfg)


def init_params(cfg, generator: torch.Generator, device) -> dict:
    """Random parameters drawn from `generator` on `device`."""
    if cfg.family == "cnn":
        return cnn_mod.init_cnn(cfg, generator, device)
    _check_serving(cfg)
    if cfg.family == "ssm":
        return rwkv_mod.init_rwkv(generator, cfg, device)
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
# serving (dense, ssm)
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, max_seq: int, device):
    """Decode state: the stacked KV cache of length max_seq (dense) or
    the O(1) recurrent state (ssm)."""
    _check_serving(cfg)
    if cfg.family == "ssm":
        return rwkv_mod.init_rwkv_model_state(cfg, batch, device)
    return tf_mod.init_decoder_cache(cfg, batch, max_seq, device)


def decode_step(cfg, params, cache, tokens, pos: int):
    """One-token serve step: (logits (B, 1, V), new cache). The dense KV
    cache is updated in place."""
    _check_serving(cfg)
    if cfg.family == "ssm":
        return rwkv_mod.rwkv_decode_step(params, cache, tokens, pos, cfg)
    return tf_mod.decoder_decode_step(params, cache, tokens, pos, cfg)


def prefill(cfg, params, batch, *, max_seq: int, backend="flash"):
    """Prefill returning (logits (B, S, V), cache/state). backend "flash"
    reaches the kernels (attention or WKV), "naive" the plain paths."""
    _check_serving(cfg)
    if cfg.family == "ssm":
        return rwkv_mod.rwkv_prefill(params, batch["tokens"], cfg,
                                     backend=backend)
    return tf_mod.decoder_prefill(params, batch["tokens"], cfg,
                                  max_seq=max_seq, backend=backend)
