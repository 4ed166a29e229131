"""RWKV6 (Finch) blocks — attention-free, data-dependent decay (reference
`repro.models.rwkv`).

Time-mix: token-shift ddlerp, per-channel data-dependent decay
w_t ∈ (0, 1), per-head WKV state S ∈ (head, hd, hd):

    S_t[i,j]  = w_t[i] · S_{t-1}[i,j] + k_t[i] · v_t[j]
    out_t[j]  = Σ_i r_t[i] · (S_{t-1}[i,j] + u[i]·k_t[i]·v_t[j])

Channel-mix: squared-ReLU MLP with token-shift. The decode state is O(1)
in the context: (prev_x, S) per layer.

Prefill with backend="flash" runs the WKV through `kernels.ops.wkv` (the
CUDA kernel on a card, its plain chunked version on the CPU);
backend="naive" and decode take the per-token recurrence
(`kernels.ref.wkv_ref`). The reference's pure-JAX chunked path
(`wkv_chunked_jax`, backend="chunked") is not ported (ROADMAP queue 1
item 12). Layers are stacked with a leading L axis; a Python loop walks
them.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.ref import wkv_ref
from repro_torch.models.layers import (dense_init, embed_lookup, group_norm,
                                       init_embed, normal, rms_norm,
                                       torch_dtype)
from repro_torch.models.transformer import layer_at

LORA_MIX = 32
LORA_DECAY = 64
N_MIX = 5  # w, k, v, r, g


def _uniform(generator, shape, device, lo: float, hi: float, dtype):
    """U[lo, hi) draws from `generator` (in f32, then cast to dtype)."""
    x = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    return (x * (hi - lo) + lo).to(torch_dtype(dtype))


def init_time_mix(generator, cfg, device, *, depth_scale: float = 1.0,
                  lead=()):
    D = cfg.d_model
    H, hd = cfg.num_heads, cfg.ssm_head_dim
    dt = cfg.dtype
    lead = tuple(lead)
    kw = dict(lead=lead)
    return {
        # [x, w, k, v, r, g]
        "mu_base": _uniform(generator, lead + (N_MIX + 1, D), device, 0.0,
                            0.5, dt),
        "mix_w1": dense_init(generator, D, N_MIX * LORA_MIX, dt, device,
                             **kw),
        "mix_w2": normal(generator, lead + (N_MIX, LORA_MIX, D), 0.02, dt,
                         device),
        "decay_base": _uniform(generator, lead + (H, hd), device, -6.0,
                               -1.0, dt),
        "decay_w1": dense_init(generator, D, LORA_DECAY, dt, device, **kw),
        "decay_w2": dense_init(generator, LORA_DECAY, D, dt, device, **kw),
        "bonus_u": normal(generator, lead + (H, hd), 0.3, dt, device),
        "wr": dense_init(generator, D, D, dt, device, **kw),
        "wk": dense_init(generator, D, D, dt, device, **kw),
        "wv": dense_init(generator, D, D, dt, device, **kw),
        "wg": dense_init(generator, D, D, dt, device, **kw),
        "wo": dense_init(generator, D, D, dt, device, scale=depth_scale,
                         **kw),
        "gn_scale": torch.ones(lead + (D,), dtype=torch_dtype(dt),
                               device=device),
        "gn_bias": torch.zeros(lead + (D,), dtype=torch_dtype(dt),
                               device=device),
    }


def init_channel_mix(generator, cfg, device, *, depth_scale: float = 1.0,
                     lead=()):
    D, F = cfg.d_model, cfg.d_ff
    dt = cfg.dtype
    lead = tuple(lead)
    kw = dict(lead=lead)
    return {
        "mu_k": _uniform(generator, lead + (D,), device, 0.0, 0.5, dt),
        "mu_r": _uniform(generator, lead + (D,), device, 0.0, 0.5, dt),
        "wk": dense_init(generator, D, F, dt, device, **kw),
        "wv": dense_init(generator, F, D, dt, device, scale=depth_scale,
                         **kw),
        "wr": dense_init(generator, D, D, dt, device, **kw),
    }


def _shift(x):
    """Previous-token shift (zeros at t=0). x: (B, S, D)."""
    return torch.nn.functional.pad(x, (0, 0, 1, 0))[:, :-1]


def _ddlerp(p, x, xprev):
    """Data-dependent token-shift mixes → dict of mixed inputs."""
    xx = xprev - x
    base = p["mu_base"]
    xxx = x + xx * base[0]
    lora = torch.tanh(xxx @ p["mix_w1"])
    lora = lora.reshape(*lora.shape[:-1], N_MIX, LORA_MIX)
    dyn = torch.einsum("bsnk,nkd->bsnd", lora, p["mix_w2"])
    mixed = x[..., None, :] + xx[..., None, :] * (base[1:] + dyn)
    return {n: mixed[..., i, :] for i, n in enumerate("wkvrg")}


def _rkvwg(p, x, xprev, cfg):
    m = _ddlerp(p, x, xprev)
    B, S, D = x.shape
    H, hd = cfg.num_heads, cfg.ssm_head_dim
    r = (m["r"] @ p["wr"]).reshape(B, S, H, hd)
    k = (m["k"] @ p["wk"]).reshape(B, S, H, hd)
    v = (m["v"] @ p["wv"]).reshape(B, S, H, hd)
    g = torch.nn.functional.silu(m["g"] @ p["wg"])
    decay_in = torch.tanh(m["w"] @ p["decay_w1"])
    dlora = decay_in @ p["decay_w2"]
    logw = p["decay_base"].reshape(1, 1, D) + dlora
    w = torch.exp(-torch.exp(logw.float()))       # (B, S, D) in (0, 1)
    return r, k, v, g, w.reshape(B, S, H, hd)


def time_mix(p, x, cfg, *, state=None, wkv_fn=None):
    """Full-sequence time-mix. state: None (fresh) or {"prev_x", "S"}.
    r/k/v go to the WKV in the model dtype, w, u and the state in f32.
    → (out, new state)."""
    B, S, D = x.shape
    if state is None:
        xprev = _shift(x)
    else:
        xprev = torch.cat([state["prev_x"][:, None, :], x[:, :-1]], dim=1)
    r, k, v, g, w = _rkvwg(p, x, xprev, cfg)
    s0 = None if state is None else state["S"]
    wkv = wkv_fn or wkv_ref
    out, s_new = wkv(r, k, v, w, p["bonus_u"].float(), s0)
    out = out.reshape(B, S, D)
    out = group_norm(out, p["gn_scale"], p["gn_bias"], cfg.num_heads)
    out = (out * g) @ p["wo"]
    return out, {"prev_x": x[:, -1, :], "S": s_new}


def channel_mix(p, x, *, state=None):
    if state is None:
        xprev = _shift(x)
    else:
        xprev = torch.cat([state["prev_x"][:, None, :], x[:, :-1]], dim=1)
    xx = xprev - x
    xk = x + xx * p["mu_k"]
    xr = x + xx * p["mu_r"]
    k = torch.relu(xk @ p["wk"]).square()
    out = torch.sigmoid(xr @ p["wr"]) * (k @ p["wv"])
    return out, {"prev_x": x[:, -1, :]}


def init_rwkv_layer(generator, cfg, device, *, depth_scale: float = 1.0,
                    lead=()):
    D = cfg.d_model
    dt = torch_dtype(cfg.dtype)
    lead = tuple(lead)
    return {
        "ln1": torch.zeros(lead + (D,), dtype=dt, device=device),
        "time": init_time_mix(generator, cfg, device,
                              depth_scale=depth_scale, lead=lead),
        "ln2": torch.zeros(lead + (D,), dtype=dt, device=device),
        "chan": init_channel_mix(generator, cfg, device,
                                 depth_scale=depth_scale, lead=lead),
    }


def rwkv_layer(p, x, cfg, *, state=None, wkv_fn=None):
    ts = None if state is None else state["time"]
    cs = None if state is None else state["chan"]
    h, ts_new = time_mix(p["time"], rms_norm(x, p["ln1"], cfg.norm_eps), cfg,
                         state=ts, wkv_fn=wkv_fn)
    x = x + h
    h, cs_new = channel_mix(p["chan"], rms_norm(x, p["ln2"], cfg.norm_eps),
                            state=cs)
    return x + h, {"time": ts_new, "chan": cs_new}


def init_rwkv(generator, cfg, device) -> dict:
    """The whole model; the L layers stacked on a leading axis."""
    depth_scale = 1.0 / math.sqrt(2 * cfg.num_layers)
    return {
        "embed": init_embed(generator, cfg.padded_vocab, cfg.d_model,
                            cfg.dtype, device),
        "layers": init_rwkv_layer(generator, cfg, device,
                                  depth_scale=depth_scale,
                                  lead=(cfg.num_layers,)),
        "final_norm": torch.zeros((cfg.d_model,), dtype=torch_dtype(
            cfg.dtype), device=device),
        "lm_head": dense_init(generator, cfg.d_model, cfg.padded_vocab,
                              cfg.dtype, device),
    }


def _run_layers(params, x, state, cfg, wkv_fn):
    """Walk the stacked layers; state is the stacked (L, …) decode state,
    rebuilt from the per-layer states."""
    new = []
    for i in range(cfg.num_layers):
        x, st = rwkv_layer(layer_at(params["layers"], i), x, cfg,
                           state=layer_at(state, i), wkv_fn=wkv_fn)
        new.append(st)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    stacked = {part: {k: torch.stack([st[part][k] for st in new])
                      for k in new[0][part]} for part in new[0]}
    return x @ params["lm_head"], stacked


def rwkv_prefill(params, tokens, cfg, *, backend="flash"):
    """Prompt prefill that returns the decode state: (logits, stacked
    state). backend "flash" → the chunked WKV kernel route, "naive" → the
    per-token recurrence."""
    if backend == "flash":
        wkv_fn = kernel_ops.wkv
    elif backend == "naive":
        wkv_fn = None
    else:
        raise NotImplementedError(f"rwkv prefill backend {backend!r} is not "
                                  "ported (ROADMAP queue 1 item 12)")
    x = embed_lookup(params["embed"], tokens)
    state = init_rwkv_model_state(cfg, tokens.shape[0], tokens.device)
    return _run_layers(params, x, state, cfg, wkv_fn)


def init_rwkv_state(cfg, batch: int, device, lead=()):
    """Zeroed decode state of one layer (or `lead`-stacked layers): the
    previous token's input of each mix in cfg.dtype, S in f32."""
    dt = torch_dtype(cfg.dtype)
    D, H, hd = cfg.d_model, cfg.num_heads, cfg.ssm_head_dim
    lead = tuple(lead)
    return {
        "time": {
            "prev_x": torch.zeros(lead + (batch, D), dtype=dt, device=device),
            "S": torch.zeros(lead + (batch, H, hd, hd), dtype=torch.float32,
                             device=device),
        },
        "chan": {"prev_x": torch.zeros(lead + (batch, D), dtype=dt,
                                       device=device)},
    }


def init_rwkv_model_state(cfg, batch: int, device):
    """Stacked (L, …) decode state — O(1) in the context length."""
    return init_rwkv_state(cfg, batch, device, lead=(cfg.num_layers,))


def rwkv_decode_step(params, state, tokens, pos, cfg):
    """One-token decode. tokens (B, 1); pos unused (the state has no
    positions). → (logits (B, 1, V), new stacked state)."""
    del pos
    x = embed_lookup(params["embed"], tokens)
    return _run_layers(params, x, state, cfg, None)
