"""RWKV6 (Finch) blocks — attention-free, data-dependent decay (reference
`repro.models.rwkv`).

Time-mix: token-shift ddlerp, per-channel data-dependent decay
w_t ∈ (0, 1), per-head WKV state S ∈ (head, hd, hd):

    S_t[i,j]  = w_t[i] · S_{t-1}[i,j] + k_t[i] · v_t[j]
    out_t[j]  = Σ_i r_t[i] · (S_{t-1}[i,j] + u[i]·k_t[i]·v_t[j])

Channel-mix: squared-ReLU MLP with token-shift. The decode state is O(1)
in the context: (prev_x, S) per layer.

The WKV routes: backend "flash" runs `kernels.ops.wkv` (the CUDA kernel
on a card, its plain chunked version on the CPU; no backward, so a
forward only); "chunked" runs `wkv_chunked_torch`, the reference's
block-parallel closed form (`wkv_chunked_jax`) in plain PyTorch; "naive"
and "auto" (training and decode) the per-token recurrence
(`kernels.ref.wkv_ref`). `rwkv_forward` is the teacher-forced training
forward (`remat` recomputes each layer in the backward). Layers are
stacked with a leading L axis; a Python loop walks them.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.ref import wkv_ref
from repro_torch.models.layers import (dense_init, embed_lookup, group_norm,
                                       init_embed, normal, rms_norm,
                                       torch_dtype)
from repro_torch.models.transformer import layer_at, run_layer, zero_aux

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


def wkv_chunked_torch(r, k, v, w, u, state=None, chunk: int = 512,
                      sub_chunk: int = 16):
    """The WKV recurrence in the reference's chunked closed form
    (`wkv_chunked_jax`), plain PyTorch: a loop over chunks of `chunk`
    tokens carrying the (B, H, hd, hd) f32 state; inside a chunk,
    sub-chunk diagonal blocks take the exact decay einsum and the
    off-diagonal block pairs the factored form (every exponent ≤ 0).
    Differentiable. r, k, v, w (B, S, H, hd), u (H, hd) → (out in
    r.dtype, final state f32)."""
    B, S, H, hd = r.shape
    dev = r.device
    s0 = (torch.zeros((B, H, hd, hd), dtype=torch.float32, device=dev)
          if state is None else state.float())
    c = min(chunk, S)
    pad = (-S) % c
    f = [a.float() for a in (r, k, v, w)]
    if pad:
        f = [torch.nn.functional.pad(a, (0, 0, 0, 0, 0, pad), value=val)
             for a, val in zip(f, (0.0, 0.0, 0.0, 1.0))]
    nc = (S + pad) // c
    rc, kc, vc, wc = (a.reshape(B, nc, c, H, hd) for a in f)
    uf = u.float()
    sc = sub_chunk if (sub_chunk and c % sub_chunk == 0 and c > sub_chunk) \
        else c
    n = c // sc
    iota = torch.arange(sc, device=dev)
    tri_sc = iota[:, None] > iota[None, :]
    blk = torch.arange(n, device=dev)
    blk_lower = blk[:, None] > blk[None, :]
    outs = []
    for ci in range(nc):
        rr, kk, vv, ww = rc[:, ci], kc[:, ci], vc[:, ci], wc[:, ci]
        # the reference's maximum(w, 1e-38), by a select: a clamped w
        # (underflowed to 0 at full width) gets a zero gradient, where
        # clamp_min's backward would multiply log's 1/1e-38 by 0 (NaN)
        lw = torch.log(torch.where(ww > 1e-38, ww, 1e-38))
        cum = torch.cumsum(lw, dim=1)              # inclusive
        cum_prev = cum - lw
        # cross-chunk: (r ⊙ e^{cum_prev}) @ S0
        o = torch.einsum("bthi,bhij->bthj", rr * torch.exp(cum_prev), s0)
        # intra-chunk, two-level
        shp = (B, n, sc, H, hd)
        r2, k2, v2 = (a.reshape(shp) for a in (rr, kk, vv))
        cum2, cum_prev2 = cum.reshape(shp), cum_prev.reshape(shp)
        a_start = cum_prev2[:, :, 0]               # (B, n, H, hd)
        b_end = cum2[:, :, -1]
        expo_d = cum_prev2[:, :, :, None] - cum2[:, :, None, :]
        expo_d = torch.where(tri_sc[None, None, :, :, None, None], expo_d,
                             float("-inf"))
        scores_d = torch.einsum("bnthi,bnshi,bntshi->bntsh", r2, k2,
                                torch.exp(expo_d))
        o_d = torch.einsum("bntsh,bnshj->bnthj", scores_d, v2)
        if n > 1:
            r_hat = r2 * torch.exp(cum_prev2 - a_start[:, :, None])
            k_hat = k2 * torch.exp(b_end[:, :, None] - cum2)
            # masked before the exp (the reference masks after it): the
            # pairs above the diagonal have positive exponents, inf when
            # decays underflow, and exp's gradient there would be inf · 0
            m_ij = torch.exp(torch.where(
                blk_lower[None, :, :, None, None],
                a_start[:, :, None] - b_end[:, None, :], float("-inf")))
            rm = torch.einsum("bithc,bijhc->bijthc", r_hat, m_ij)
            scores_o = torch.einsum("bijthc,bjshc->bijtsh", rm, k_hat)
            o_d = o_d + torch.einsum("bijtsh,bjshd->bithd", scores_o, v2)
        o = o + o_d.reshape(rr.shape)
        # the bonus diagonal
        diag = torch.einsum("bthi,hi,bthi->bth", rr, uf, kk)
        o = o + diag[..., None] * vv
        # state update: every exponent ≤ 0
        k_dec = kk * torch.exp(cum[:, -1:] - cum)
        s0 = torch.exp(cum[:, -1])[..., None] * s0 + torch.einsum(
            "bshi,bshj->bhij", k_dec, vv)
        outs.append(o)
    out = torch.stack(outs, dim=1).reshape(B, S + pad, H, hd)[:, :S]
    return out.to(r.dtype), s0


WKV_ROUTES = {"flash": kernel_ops.wkv, "chunked": wkv_chunked_torch,
              "naive": None, "auto": None}


def wkv_route(backend: str):
    """The WKV function of a backend (None: the per-token recurrence)."""
    if backend not in WKV_ROUTES:
        raise ValueError(f"unknown rwkv backend {backend!r} "
                         f"(use one of {sorted(WKV_ROUTES)})")
    return WKV_ROUTES[backend]


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


def _layer_train(layer, x, cfg, wkv_fn):
    return rwkv_layer(layer, x, cfg, wkv_fn=wkv_fn)[0]


def rwkv_forward(params, tokens, cfg, *, remat: bool = False,
                 wkv_fn=None):
    """Teacher-forced forward of tokens (B, S) from a fresh state →
    (logits (B, S, V), aux: both losses 0)."""
    x = embed_lookup(params["embed"], tokens)
    for i in range(cfg.num_layers):
        x = run_layer(_layer_train, remat, layer_at(params["layers"], i), x,
                      cfg, wkv_fn)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x @ params["lm_head"], zero_aux(x.device)


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
    state). backend "flash" → the chunked WKV kernel route, "chunked" →
    `wkv_chunked_torch` (and "auto", as in the reference), "naive" → the
    per-token recurrence."""
    wkv_fn = wkv_route("chunked" if backend == "auto" else backend)
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
