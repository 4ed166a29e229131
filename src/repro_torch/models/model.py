"""Model API — the cnn branch of reference `repro.models.model`.

batch dict: {"images": (B, H, W, C), "labels": (B,) int}.
"""
from __future__ import annotations

import torch

from repro_torch.models import cnn as cnn_mod
from repro_torch.models.layers import cross_entropy_loss, per_example_nll


def _check_family(cfg):
    if cfg.family != "cnn":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported (ROADMAP queue 1 item 12)"
        )


def init_params(cfg, generator: torch.Generator, device) -> dict:
    _check_family(cfg)
    return cnn_mod.init_cnn(cfg, generator, device)


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
