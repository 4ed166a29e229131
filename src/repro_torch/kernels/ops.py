"""Public kernel wrappers — the hooks the core layers call (reference
`repro.kernels.ops`).

  * core/scoring.py  header_distance_matrix(use_kernel=True) → cosine_gram
  * core/scoring.py  score_topk                              → select_topk
  * fl/engine.py     mix_tree (packed gossip plans)          → gossip_mix
  * fl/strategies.py stage_evolve_masks (dispfl)      → mask_evolve_leaves
  * models/attention.py attend(backend="flash")              → flash_attention
  * models/rwkv.py   rwkv_prefill(backend="flash")           → wkv

Routing is by the device of the input, never by a fallback: a CUDA tensor
reaches the CUDA kernel (or the kernel raises), a CPU tensor takes the
plain PyTorch version. `impl="plain"` asks for the plain version
explicitly on either device (the tests and `chip_smoke.py` compare the
two with it); `impl="cuda"` on a CPU tensor raises. On `meta` tensors
(the dry run, `launch/dryrun.py`) flash_attention and wkv run neither:
they return empty outputs of the kernel's shapes and report the call to
`META_OBSERVERS`, which count it by the kernel's work
(`launch/roofline.OpCounter`).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import gossip_mix as _gm
from repro_torch.kernels import mask_evolve as _me
from repro_torch.kernels import peer_score as _ps
from repro_torch.kernels import select_score as _ss
from repro_torch.kernels import wkv_chunked as _wkv

KERNELS = {"flash_attention": _fa.flash_attention_cuda,
           "gossip_mix": _gm.gossip_mix_cuda,
           "mask_evolve": _me.mask_evolve_cuda,
           "raw_gram": _ps.raw_gram_cuda,
           "select_topk": _ss.select_topk_cuda,
           "wkv_chunked": _wkv.wkv_chunked_cuda}

# Packing a gossip plan into neighbour lists pays on the CPU only from
# this population size on (the reference's measured crossover, where its
# dense einsum stops fitting in cache). On a CUDA card the plan is always
# packed for the kernel, as the reference does on a TPU.
MIN_PACKED_MIX_CPU = 1024

# callables told of each flash_attention / wkv call on meta tensors, as
# observer(kernel name, *the call's arguments, **its options)
META_OBSERVERS: list = []


def _meta_call(name, *args, **kwargs):
    for observer in META_OBSERVERS:
        observer(name, *args, **kwargs)


def launch_counts() -> dict:
    """Launches of each CUDA kernel wrapper in this process."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts():
    for fn in KERNELS.values():
        fn.launches = 0
        if hasattr(fn, "leaves"):
            fn.leaves = 0
        for route in getattr(fn, "route_launches", {}):
            fn.route_launches[route] = 0


def _route(x, impl):
    if impl is None:
        return "cuda" if x.is_cuda else "plain"
    if impl not in ("cuda", "plain"):
        raise ValueError(f"unknown impl {impl!r} (use 'cuda' or 'plain')")
    if impl == "cuda" and not x.is_cuda:
        raise ValueError("impl='cuda' needs CUDA tensors")
    return impl


def raw_gram(x, *, impl: str | None = None):
    """x: (M, P) → (M, M) float32 un-normalized Gram x @ x.T."""
    if _route(x, impl) == "cuda":
        return _ps.raw_gram_cuda(x.float().contiguous())
    return _ps.raw_gram_plain(x)


def cosine_gram(x, *, impl: str | None = None):
    """x: (M, P) → (M, M) f32 cosine-similarity matrix (paper Eq. 7)."""
    return _ps.gram_to_cosine(raw_gram(x, impl=impl))


def select_topk(x, last_selected, s_l, t, cost, candidate_mask=None, *,
                k: int, alpha: float, lam: float, impl: str | None = None):
    """Fused Eq. 7–9 scoring + per-row top-k.

    → (values (M, k) f32, indices (M, k) int32, s_d stats (M, 2) f32);
    masked entries score exactly NEG, ties go to the lowest column.
    cost is a scalar or an (M, M) matrix; candidate_mask None or (M, M)
    bool."""
    if _route(x, impl) == "plain":
        return _ss.select_topk_plain(x, last_selected, s_l, t, cost,
                                     candidate_mask, k=k, alpha=alpha,
                                     lam=lam)
    if isinstance(cost, torch.Tensor) and cost.dim() == 2:
        cost = cost.float().contiguous()
    elif isinstance(cost, torch.Tensor):
        cost = float(cost)
    if candidate_mask is not None:
        candidate_mask = candidate_mask.bool().contiguous()
    return _ss.select_topk_cuda(
        x.float().contiguous(), last_selected.to(torch.int32).contiguous(),
        s_l.float().contiguous(), int(t), cost, candidate_mask,
        k=k, alpha=alpha, lam=lam)


def packs_gossip_plans(m: int, device) -> bool:
    """Whether a gossip plan over M clients on `device` is packed into
    neighbour lists for `gossip_mix` (else it mixes dense)."""
    return torch.device(device).type == "cuda" or m >= MIN_PACKED_MIX_CPU


def gossip_mix(x, idx, w, *, impl: str | None = None):
    """Row-stochastic mixing over packed neighbour lists: x (M, F), idx/w
    (M, D) ascending lists from `weights_to_neighbors` → (M, F) f32.
    Every route agrees bitwise."""
    if _route(x, impl) == "cuda":
        return _gm.gossip_mix_cuda(x.float().contiguous(),
                                   idx.to(torch.int32).contiguous(),
                                   w.float().contiguous())
    return _gm.gossip_mix_plain(x, idx, w).float()


def mask_evolve(x, grow, *, keep: int, impl: str | None = None):
    """DisPFL mask evolution of one leaf: keep the `keep` largest |x|,
    regrow where `grow`, re-project. → (x·mask in x.dtype, mask bool).
    The threshold is the exact (n − keep)-th smallest |x|: a radix select
    on the card, the reference's bisection in the plain version. Every
    route agrees bitwise."""
    return mask_evolve_leaves([x], [grow], [keep], impl=impl)[0]


def mask_evolve_leaves(leaves, grows, keeps, *, impl: str | None = None,
                       in_place: bool = False):
    """`mask_evolve` over a list of leaves (a round's), leaf i with
    grows[i] and keeps[i] → [(x·mask in x.dtype, mask bool)]. On the card
    one kernel call covers every leaf; the plain route loops over
    `mask_evolve_plain`. Every route agrees bitwise. in_place: each
    x·mask is written into its leaf and each mask into its grow plane
    (contiguous bool tensors the caller owns), which are returned."""
    if not leaves:
        return []
    if _route(leaves[0], impl) == "cuda":
        xs = [x.contiguous() for x in leaves]
        gs = [g.bool().contiguous() for g in grows]
        if in_place and any(a.data_ptr() != b.data_ptr() for a, b in
                            zip(xs + gs, list(leaves) + list(grows))):
            raise ValueError("in_place needs contiguous leaves and bool "
                             "grow planes")
        done = _me.mask_evolve_leaves_cuda(
            xs, gs, keeps, outs=xs if in_place else None,
            masks=gs if in_place else None)
        return [(out, mask) for out, mask, _ in done]
    out = []
    for x, g, k in zip(leaves, grows, keeps):
        y, mask, _ = _me.mask_evolve_plain(x, g, keep=k)
        if in_place:
            x.copy_(y)
            g.copy_(mask)
            y, mask = x, g
        out.append((y, mask))
    return out


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_offset: int = 0, impl: str | None = None):
    """Blocked online-softmax attention: q/k (B, Sq|Skv, H|K, hd), v
    (B, Skv, K, dv) with dv ≤ hd, GQA by h // (H/K) → (B, Sq, H, dv) in
    q.dtype. A dv below hd (MLA: 192 / 128) runs the kernel on v
    zero-padded to the instance's head dim (zero columns of v add exact
    zeros to P·v), the plain version on v as it is."""
    if q.is_meta and impl is None:
        _meta_call("flash_attention", q, k, v, causal=causal, window=window,
                   q_offset=q_offset)
        return q.new_empty(q.shape[:3] + v.shape[3:])
    if _route(q, impl) == "cuda":
        return _fa.flash_attention_cuda(
            q.contiguous(), k.contiguous(), v.contiguous(), causal=causal,
            window=window, q_offset=q_offset)
    return _fa.flash_attention_plain(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset)


def wkv(r, k, v, w, u, state=None, *, impl: str | None = None):
    """Chunked RWKV6 WKV: r/k/v (B, S, H, hd) in the model dtype, w f32
    decays, u (H, hd) f32, state (B, H, hd, hd) f32 or None → (out in
    r.dtype, final state f32)."""
    if r.is_meta and impl is None:
        _meta_call("wkv_chunked", r, k, v, w, u, state)
        b, _, h, hd = r.shape
        return r.new_empty(r.shape), r.new_empty((b, h, hd, hd),
                                                 dtype=torch.float32)
    if _route(r, impl) == "cuda":
        return _wkv.wkv_chunked_cuda(
            r.contiguous(), k.contiguous(), v.contiguous(),
            w.float().contiguous(), u.float().contiguous(),
            None if state is None else state.float().contiguous())
    return _wkv.wkv_chunked_plain(r, k, v, w, u, state)
