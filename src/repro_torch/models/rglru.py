"""RG-LRU recurrent block (Griffin / RecurrentGemma), reference
`repro.models.rglru`.

Recurrent block: x → two linear branches; branch a → GeLU (tanh form)
gate; branch b → width-4 causal depthwise conv1d → RG-LRU; merged by an
elementwise product → linear out.

RG-LRU (per channel, Griffin eq. 3-4), in float32:
    r_t = σ(x_t W_a + b_a)          recurrence gate
    i_t = σ(x_t W_x + b_x)          input gate
    log a_t = −c · softplus(Λ) · r_t            (c = 8)
    h_t = a_t ⊙ h_{t-1} + sqrt(1 − a_t²) ⊙ (i_t ⊙ x_t)

The full-sequence recurrence is a log-depth doubling scan over (a, b)
pairs with the reference's combine (a_l·a_r, a_r·b_l + b_r): ⌈log2 S⌉
steps of whole-tensor products (12 at S = 4096), where the reference
runs `jax.lax.associative_scan`; the two associate the products
differently, so they agree to f32 rounding, not bitwise. The decode state
is O(1): the h vector (f32) and the conv's last 3 inputs.

As in the reference, the scan writes sqrt(max(1 − exp(2·log a), 1e-12))
and the decode step sqrt(max(1 − a², 1e-12)); softplus is
log(exp(x) + 1) = logaddexp(x, 0), as `jax.nn.softplus` computes it.
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import dense_init, normal, torch_dtype

C_CONST = 8.0
CONV_WIDTH = 4


def init_rglru_block(generator, cfg, device, *, depth_scale: float = 1.0):
    """The block's weights; Λ (`lambda`, f32) is drawn so that a lies in
    (0.9, 0.999) at r = 1 (Griffin's appendix)."""
    D, W = cfg.d_model, cfg.lru_width
    dt = torch_dtype(cfg.dtype)
    u = torch.rand((W,), generator=generator, device=device) * \
        (0.999 - 0.9) + 0.9
    lam = torch.log(torch.expm1(-torch.log(u) / C_CONST))  # softplus⁻¹
    return {
        "proj_a": dense_init(generator, D, W, cfg.dtype, device),
        "proj_b": dense_init(generator, D, W, cfg.dtype, device),
        "conv_w": normal(generator, (CONV_WIDTH, W), 0.1, cfg.dtype, device),
        "conv_b": torch.zeros((W,), dtype=dt, device=device),
        "gate_a": dense_init(generator, W, W, cfg.dtype, device),
        "gate_a_b": torch.zeros((W,), dtype=dt, device=device),
        "gate_x": dense_init(generator, W, W, cfg.dtype, device),
        "gate_x_b": torch.zeros((W,), dtype=dt, device=device),
        "lambda": lam.float(),
        "proj_out": dense_init(generator, W, D, cfg.dtype, device,
                               scale=depth_scale),
    }


def _softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


def _gelu(x):
    return torch.nn.functional.gelu(x, approximate="tanh")


def _conv1d(p, x, tail=None):
    """Causal depthwise width-4 conv. x (B, S, W); tail (B, 3, W): the
    previous inputs (zeros without one). → (out, the new tail)."""
    if tail is None:
        tail = x.new_zeros((x.shape[0], CONV_WIDTH - 1, x.shape[2]))
    xp = torch.cat([tail, x], dim=1)
    s = x.shape[1]
    out = xp[:, 0:s] * p["conv_w"][0]
    for i in range(1, CONV_WIDTH):
        out = out + xp[:, i:i + s] * p["conv_w"][i]
    return out + p["conv_b"], xp[:, -(CONV_WIDTH - 1):]


def _gates(p, xf):
    """r and i of f32 inputs xf (…, W), each from an f32 GEMM."""
    r = torch.sigmoid(xf @ p["gate_a"].float() + p["gate_a_b"].float())
    i = torch.sigmoid(xf @ p["gate_x"].float() + p["gate_x_b"].float())
    return r, i


def linear_scan(a, b):
    """h_t = a_t·h_{t−1} + b_t along axis 1 from h_{−1} = 0, by doubling:
    after the step of stride d each (a, b) holds the composition of the
    ≤ 2d steps ending at t, with combine(l, r) = (a_l·a_r, a_r·b_l + b_r).
    ⌈log2 S⌉ steps. → h, the shape of b."""
    s = a.shape[1]
    d = 1
    while d < s:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        if 2 * d < s:
            a = torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], dim=1)
        d *= 2
    return b


def scan_inputs(p, x, h0=None):
    """The recurrence's f32 (a, b) over a full sequence x (B, S, W), so
    that h_t = a_t·h_{t−1} + b_t from h_{−1} = 0: the state h0 (B, W), if
    given, folded into b_0."""
    xf = x.float()
    r, i = _gates(p, xf)
    log_a = -C_CONST * _softplus(p["lambda"]) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)) \
        * (i * xf)
    if h0 is not None:
        b[:, 0] = b[:, 0] + a[:, 0] * h0.float()
    return a, b


def rg_lru_scan(p, x, h0=None):
    """The LRU recurrence over a full sequence x (B, S, W), from the state
    h0 (B, W) f32 (zeros without one). → (h (B, S, W) in x.dtype, the
    last h (B, W) f32)."""
    h = linear_scan(*scan_inputs(p, x, h0))
    return h.to(x.dtype), h[:, -1]


def rg_lru_step(p, x1, h):
    """One decode step. x1 (B, W); h (B, W) f32 → (h in x1.dtype, h f32)."""
    xf = x1.float()
    r, i = _gates(p, xf)
    log_a = -C_CONST * _softplus(p["lambda"]) * r
    a = torch.exp(log_a)
    h_new = a * h + torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * (i * xf)
    return h_new.to(x1.dtype), h_new


def rglru_block(p, x, *, state=None):
    """Full-sequence recurrent block, x (B, S, D), from `state` ({"conv",
    "h"}, or zeros). → (out (B, S, D), the state after the last token)."""
    ga = _gelu(x @ p["proj_a"])
    xb = x @ p["proj_b"]
    tail = None if state is None else state["conv"]
    h0 = None if state is None else state["h"]
    xb, tail_new = _conv1d(p, xb, tail)
    y, h_last = rg_lru_scan(p, xb, h0)
    return (y * ga) @ p["proj_out"], {"conv": tail_new, "h": h_last}


def rglru_block_step(p, x1, state):
    """One-token decode, x1 (B, 1, D). → (out (B, 1, D), new state)."""
    x1 = x1[:, 0]
    ga = _gelu(x1 @ p["proj_a"])
    xb = x1 @ p["proj_b"]
    conv = torch.cat([state["conv"], xb[:, None]], dim=1)     # (B, 4, W)
    xc = conv[:, 0] * p["conv_w"][0]
    for i in range(1, CONV_WIDTH):
        xc = xc + conv[:, i] * p["conv_w"][i]
    y, h_new = rg_lru_step(p, xc + p["conv_b"], state["h"])
    return ((y * ga) @ p["proj_out"])[:, None], {"conv": conv[:, 1:],
                                                 "h": h_new}


def init_rglru_state(cfg, batch: int, device):
    """Zero decode state: the conv tail (B, 3, W) in the model dtype and
    h (B, W) in f32."""
    W = cfg.lru_width
    return {
        "conv": torch.zeros((batch, CONV_WIDTH - 1, W),
                            dtype=torch_dtype(cfg.dtype), device=device),
        "h": torch.zeros((batch, W), dtype=torch.float32, device=device),
    }
