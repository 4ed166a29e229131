"""Shared primitive layers (reference `repro.models.layers`): the CNN's
GroupNorm and losses, and the LLM layers."""
from __future__ import annotations

import functools

import numpy as np
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


# ---------------------------------------------------------------------------
# LLM layers (reference `repro.models.layers`): init, norms, MLP, RoPE,
# embedding. Weights are (d_in, d_out) as in the reference, applied as
# x @ W; stacked layers carry a leading L axis.
# ---------------------------------------------------------------------------

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def torch_dtype(name) -> torch.dtype:
    """A config's dtype name (or a torch dtype) as a torch dtype."""
    return name if isinstance(name, torch.dtype) else DTYPES[name]


def normal(generator, shape, std: float, dtype, device):
    """N(0, std²) draws from `generator` (in f32, then cast to dtype). On
    the meta device (the dry run's parameter structs) nothing is drawn
    or allocated, and the generator's state is left as it was."""
    x = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32)
    return x.mul_(std).to(torch_dtype(dtype))


def normal_sliced(generator, shape, std: float, dtype, device, *,
                  lead: int):
    """N(0, std²) draws from `generator` into a tensor of `dtype`, one
    slice of the first `lead` axes at a time (each drawn in f32, then
    cast): a stacked leaf never has an f32 copy of its whole, only of one
    slice. The draws differ from `normal`'s over the same shape. On the
    meta device an empty tensor (no slice loop), as `normal`."""
    shape = tuple(shape)
    out = torch.empty(shape, dtype=torch_dtype(dtype), device=device)
    if out.is_meta:
        return out
    for piece in out.view((-1,) + shape[lead:]):
        piece.copy_(torch.randn(shape[lead:], generator=generator,
                                device=device,
                                dtype=torch.float32).mul_(std))
    return out


def dense_init(generator, d_in: int, d_out: int, dtype, device, *,
               scale: float = 1.0, lead=(), sliced: bool = False):
    """A (*lead, d_in, d_out) weight: std 0.02 (d_in^-½ for d_in ≤ 64),
    times `scale` (reference `dense_init`; `lead` stacks layers). With
    `sliced` it is drawn one (d_in, d_out) slice at a time
    (`normal_sliced`); the moe, MLA and vision leaves are."""
    std = scale * (0.02 if d_in > 64 else d_in ** -0.5)
    shape = tuple(lead) + (d_in, d_out)
    if sliced:
        return normal_sliced(generator, shape, std, dtype, device,
                             lead=len(lead))
    return normal(generator, shape, std, dtype, device)


def init_embed(generator, vocab: int, d_model: int, dtype, device):
    return normal(generator, (vocab, d_model), 0.02, dtype, device)


def embed_lookup(table, tokens):
    return table[tokens.long()]


def rms_norm(x, scale, eps: float = 1e-5):
    """RMSNorm with the reference's cast order: f32 row statistics, the
    multiplier and the gain (1 + scale) cast to x.dtype, (x·mult)·gain."""
    var = x.float().square().mean(dim=-1, keepdim=True)
    mult = torch.rsqrt(var + eps).to(x.dtype)
    gain = (1.0 + scale.float()).to(x.dtype)
    return (x * mult) * gain


def act_fn(name: str):
    return {
        "silu": torch.nn.functional.silu,
        "gelu": lambda x: torch.nn.functional.gelu(x, approximate="tanh"),
        "relu": torch.relu,
        "relu2": lambda x: torch.relu(x).square(),
    }[name]


def mlp(params, x, act="silu"):
    """Gated MLP for one layer: wi/wg (d_model, d_ff), wo (d_ff, d_model)."""
    h = x @ params["wi"]
    g = x @ params["wg"]
    return (act_fn(act)(g) * h) @ params["wo"]


def rope_frequencies(head_dim: int, theta: float, device=None):
    """(head_dim/2,) f32 inverse frequencies θ^(−2i/hd), computed by numpy
    in f32 exactly as the reference computes them (torch's f32 pow rounds
    some of them differently)."""
    exps = np.arange(0, head_dim // 2, dtype=np.float32) * 2.0 / head_dim
    return torch.from_numpy(1.0 / (theta ** exps)).to(device)


@functools.lru_cache(maxsize=None)
def _inv_freq_on(head_dim: int, theta: float, device):
    """rope_frequencies, copied to `device` once: a copy from pageable host
    memory to the card waits for the card, at every layer of every step."""
    return rope_frequencies(head_dim, theta, device)


def apply_rope(x, positions, theta: float):
    """x: (B, S, H, hd); positions: (B, S) or (S,) integers. Rotates the
    two halves of each head in f32, returns x.dtype."""
    hd = x.shape[-1]
    inv_freq = _inv_freq_on(hd, float(theta), x.device)
    angles = positions.float()[..., None] * inv_freq      # (..., S, half)
    if angles.dim() == 2:
        angles = angles[None]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
