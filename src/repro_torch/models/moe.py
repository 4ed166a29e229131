"""Mixture-of-Experts layer (reference `repro.models.moe`): a top-k router
and grouped, capacity-based dispatch.

Tokens are split into groups of `min(group_size or GROUP_SIZE, T)`
(zero-padded to whole groups); each group routes its tokens in f32
(softmax, top-k with ties to the lower expert index, as `jax.lax.top_k`),
renormalises the k gates, queues each (token, k) assignment at its
expert in k-major order (every top-1 pick before any top-2 pick) and
drops what is past the expert's capacity C. The experts then run on an
(E, G·C, D) buffer as three batched GEMMs, so a layer costs E·G·C rows
of expert FFN whatever the routing.

dispatch modes (default `cfg.moe_dispatch`):
  "gather"  the slot table: each kept (token, k) owns slot e·C + pos;
            tokens are gathered into the expert buffer and the outputs
            gathered back per (token, k), summed over a token's experts
            in ascending expert order. A sum in a fixed order, with no
            atomics, so a prefill is bitwise repeatable on a card. (The
            reference scatter-adds the slots back to their tokens, in
            slot order on its CPU backend: the same order.)
  "einsum"  GShard's one-hot dispatch / combine tensors (G, T, E, C).

The deepseek-style shared expert is dense and always on. The aux dict
(load balance, router z-loss) is returned as in the reference; serving
discards it. The reference's `constrain_act` is the identity without a
mesh and is dropped. `torch.profiler` ranges `moe:route`, `moe:dispatch`,
`moe:experts`, `moe:combine` and `moe:shared` name the layer's parts in
a trace; `recording_routes()` reads each layer's routing.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from repro_torch.models.layers import act_fn, dense_init, normal_sliced

CAPACITY_FACTOR = 1.25
GROUP_SIZE = 4096  # tokens per dispatch group
_route_sink: list | None = None   # the list recording_routes() fills


def init_moe(generator, cfg, device, *, depth_scale: float = 1.0, lead=()):
    """router (D, E), experts wi/wg (E, D, F) and wo (E, F, D) at std 0.02
    (wo times depth_scale), and with num_shared_experts a dense shared
    expert of width F·num_shared; a leading `lead` shape stacks layers.
    The experts are drawn one (D, F) slice at a time (`normal_sliced`)."""
    D, E, Fe = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    lead = tuple(lead)
    n = len(lead) + 1

    def experts(shape, std):
        return normal_sliced(generator, lead + shape, std, cfg.dtype,
                             device, lead=n)

    p = {
        "router": dense_init(generator, D, E, cfg.dtype, device, lead=lead),
        "experts": {
            "wi": experts((E, D, Fe), 0.02),
            "wg": experts((E, D, Fe), 0.02),
            "wo": experts((E, Fe, D), 0.02 * depth_scale),
        },
    }
    if cfg.num_shared_experts:
        Fs = Fe * cfg.num_shared_experts
        p["shared"] = {
            "wi": dense_init(generator, D, Fs, cfg.dtype, device, lead=lead),
            "wg": dense_init(generator, D, Fs, cfg.dtype, device, lead=lead),
            "wo": dense_init(generator, Fs, D, cfg.dtype, device,
                             scale=depth_scale, lead=lead),
        }
    return p


def moe_capacity(group_tokens: int, num_experts: int, top_k: int) -> int:
    """Slots per expert and group: ⌈Tg·k·1.25 / E⌉, rounded up to a
    multiple of 4, at least 4."""
    cap = math.ceil(group_tokens * top_k * CAPACITY_FACTOR / num_experts)
    return max(4, math.ceil(cap / 4) * 4)


def topk_lower_index(x, k: int):
    """The k largest entries of the last axis, largest first, ties to the
    lower index (as `jax.lax.top_k`; `torch.topk` promises no order on
    ties). → (values, int64 indices)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_route(p, x, cfg, *, group_size: int | None = None) -> dict:
    """The router of `moe_layer` for x (B, S, D): the grouped tokens `xg`
    (G, Tg, D) and, per group, the f32 `logits` and `probs` (G, Tg, E),
    `gate_idx` (G, Tg, K) int64, the renormalised `gate_vals`, the queue
    position `pos` (float, exact integers), `keep` (pos < C) and
    `gate_kept`, the one-hot `onehot` (G, Tg, K, E) f32, and the sizes
    T, Tg, G, C."""
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    T = B * S
    Tg = min(group_size or GROUP_SIZE, T)
    pad = (-T) % Tg
    xt = x.reshape(T, D)
    if pad:
        xt = F.pad(xt, (0, 0, 0, pad))
    G = (T + pad) // Tg
    C = moe_capacity(Tg, E, K)
    xg = xt.reshape(G, Tg, D)

    logits = (xg @ p["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = topk_lower_index(probs, K)           # (G,Tg,K)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    # each (token, k) assignment's place in its expert's queue, k-major
    onehot = F.one_hot(gate_idx, E).float()                    # (G,Tg,K,E)
    flat = onehot.transpose(1, 2).reshape(G, K * Tg, E)
    pos = torch.cumsum(flat, dim=1) - flat
    pos = pos.reshape(G, K, Tg, E).transpose(1, 2)
    pos_in_expert = (pos * onehot).sum(-1)                     # (G,Tg,K)
    keep = pos_in_expert < C
    return dict(xg=xg, logits=logits, probs=probs, gate_idx=gate_idx,
                gate_vals=gate_vals, pos=pos_in_expert, keep=keep,
                gate_kept=gate_vals * keep.to(gate_vals.dtype),
                onehot=onehot, T=T, Tg=Tg, G=G, C=C)


@contextlib.contextmanager
def recording_routes():
    """Inside the block each `moe_layer` call appends its routing over the
    real tokens, (gate_idx (T, K) int64, keep (T, K) bool) on the layer's
    device, to the yielded list. Off (nothing kept) outside the block."""
    global _route_sink
    prev, sink = _route_sink, []
    _route_sink = sink
    try:
        yield sink
    finally:
        _route_sink = prev


def _experts(p, xe, cfg):
    """xe (E, N, D) → (E, N, D): expert e's gated FFN on its N rows (the
    C slots of every group), as three batched GEMMs."""
    h = torch.bmm(xe, p["experts"]["wi"])
    g = torch.bmm(xe, p["experts"]["wg"])
    return torch.bmm(act_fn(cfg.act)(g) * h, p["experts"]["wo"])


def moe_layer(p, x, cfg, *, group_size: int | None = None,
              dispatch_mode: str | None = None):
    """x (B, S, D) → (B, S, D) and the aux dict {load_balance, router_z}
    (0-dim f32). Assignments past an expert's capacity are dropped
    (GShard); the shared expert, if any, sees every token."""
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    mode = dispatch_mode or cfg.moe_dispatch
    if mode not in ("gather", "einsum"):
        raise ValueError(f"unknown moe dispatch mode {mode!r} "
                         "(use 'gather' or 'einsum')")
    with record_function("moe:route"):
        r = moe_route(p, x, cfg, group_size=group_size)
    xg, T, Tg, G, C = r["xg"], r["T"], r["Tg"], r["G"], r["C"]
    keep, gate_kept = r["keep"], r["gate_kept"]
    dev = x.device
    if _route_sink is not None:
        _route_sink.append((r["gate_idx"].reshape(-1, K)[:T],
                            keep.reshape(-1, K)[:T]))

    if mode == "gather":
        with record_function("moe:dispatch"):
            # the slot table: the token filling slot (e, c) of each group
            # (Tg marks an empty slot; dropped assignments go to the
            # bucket E·C, cut off)
            slot = torch.where(keep, r["gate_idx"] * C + r["pos"].long(),
                               E * C)                          # (G,Tg,K)
            tok_id = torch.arange(Tg, device=dev).expand(G, K, Tg)
            token_for_slot = torch.full((G, E * C + 1), Tg,
                                        dtype=torch.long, device=dev)
            token_for_slot.scatter_(1, slot.reshape(G, Tg * K),
                                    tok_id.transpose(1, 2).reshape(G, -1))
            # gathered straight into the experts' (E, G·C, D) layout
            tfs = token_for_slot[:, :E * C].reshape(G, E, C).transpose(0, 1)
            tfs = tfs + (torch.arange(G, device=dev) * (Tg + 1))[:, None]
            xg_pad = torch.cat([xg, xg.new_zeros((G, 1, D))], dim=1)
            xe = xg_pad.reshape(G * (Tg + 1), D)[tfs.reshape(E, G * C)]
        with record_function("moe:experts"):
            ye = _experts(p, xe, cfg).reshape(E * G * C, D)
        with record_function("moe:combine"):
            # token side: each kept (token, k) reads its slot's output
            # times its gate (f32, cast to the output's dtype); a token's
            # experts are summed in ascending expert order, from zero
            order = torch.argsort(r["gate_idx"], dim=-1)
            e_sorted = r["gate_idx"].gather(-1, order)
            c_sorted = r["pos"].long().gather(-1, order)
            k_sorted = keep.gather(-1, order)
            w = gate_kept.gather(-1, order).to(ye.dtype)
            g_off = (torch.arange(G, device=dev) * C)[:, None, None]
            idx = torch.where(k_sorted, e_sorted * (G * C) + g_off
                              + c_sorted, 0)
            out = torch.zeros((G, Tg, D), dtype=ye.dtype, device=dev)
            for j in range(K):
                part = ye[idx[..., j]] * w[..., j, None]
                out = out + torch.where(k_sorted[..., j, None], part, 0.0)
            out = out.reshape(G * Tg, D)[:T]
    else:
        with record_function("moe:dispatch"):
            # dropped assignments hit the one-hot's extra column C → zeros
            pos_oh = F.one_hot(torch.where(keep, r["pos"].long(), C),
                               C + 1)[..., :C].float()         # (G,Tg,K,C)
            onehot = r["onehot"]
            dispatch = torch.einsum("gtke,gtkc->gtec",
                                    onehot * keep[..., None], pos_oh)
            combine = torch.einsum("gtke,gtkc->gtec",
                                   onehot * gate_kept[..., None], pos_oh)
            expert_in = torch.einsum("gtec,gtd->egcd",
                                     dispatch.to(x.dtype), xg)
        with record_function("moe:experts"):
            expert_out = _experts(p, expert_in.reshape(E, G * C, D), cfg)
        with record_function("moe:combine"):
            out = torch.einsum("gtec,egcd->gtd", combine.to(x.dtype),
                               expert_out.reshape(E, G, C, D))
            out = out.reshape(G * Tg, D)[:T]

    if "shared" in p:
        with record_function("moe:shared"):
            xs = x.reshape(T, D)
            sh = xs @ p["shared"]["wi"]
            sg = xs @ p["shared"]["wg"]
            out = out + (act_fn(cfg.act)(sg) * sh) @ p["shared"]["wo"]

    # aux losses over the groups' tokens (padding included, as in the
    # reference)
    me = r["probs"].mean(dim=(0, 1))
    ce = r["onehot"][..., 0, :].mean(dim=(0, 1))
    aux = {"load_balance": E * (me * ce).sum(),
           "router_z": torch.logsumexp(r["logits"], dim=-1).square().mean()}
    return out.reshape(B, S, D), aux
