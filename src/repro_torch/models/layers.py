"""Shared primitive layers (reference `repro.models.layers`), CNN subset."""
from __future__ import annotations

import torch


def group_norm(x, scale, bias, num_groups: int, eps: float = 1e-5,
               channel_axis: int = -1):
    """GroupNorm over the channel axis, statistics per position.

    Like the reference (`layers.group_norm`), the mean and variance run
    over the C/G channels of a group at each spatial position (not over
    the spatial extent), in float32, and the result is cast back to
    x.dtype. `channel_axis` = -1 is the reference's NHWC layout; the CNN
    passes 1 for its NCHW (channels-last in memory) activations.
    """
    xf = x.float().movedim(channel_axis, -1)
    shape = xf.shape
    xf = xf.reshape(shape[:-1] + (num_groups, shape[-1] // num_groups))
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    xf = ((xf - mu) * torch.rsqrt(var + eps)).reshape(shape)
    out = xf * scale.float() + bias.float()
    return out.to(x.dtype).movedim(-1, channel_axis)


def cross_entropy_loss(logits, labels):
    """Mean cross-entropy in float32 (reference `cross_entropy_loss`)."""
    return per_example_nll(logits, labels).mean()


def per_example_nll(logits, labels):
    """(..., V) logits, (...) int labels → (...) float32 negative
    log-likelihoods."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long().unsqueeze(-1)).squeeze(-1)
    return logz - gold
