"""Blocked online-softmax attention — reference
`repro.kernels.flash_attention`.

Causal and sliding-window masks, a query offset, and GQA (query head h
reads kv head h // (H/K)) on q (B, Sq, H, hd) and k/v (B, Skv, K, hd)
(v's head dim may be below hd, as MLA's);
the running max m, sum l and accumulator stay in f32 and the output is in
q's dtype. `flash_attention_cuda` launches one of the two hand-written
CUDA kernels of `csrc/flash_attention.cu` (which replaces the Pallas
`flash_attention`), chosen by dtype in `ROUTES`: bf16 and f16 take the
tensor-core kernel (wgmma fed by TMA, P split into hi + lo parts of the
input type so P·V keeps f32-level precision), f32 the fp32 FFMA kernel.
`flash_attention_plain` is their plain PyTorch version: the Pallas body
over (q block, kv block) pairs, skipping kv blocks wholly outside the
band.

The kernels are instantiated at head dims 64, 128 and 256
(`HEAD_DIMS`); `flash_attention_padded` runs any other head dim up to 256
on the next instance: q, k and v zero-padded on the head axis, the scale
that of the true head dim, the padded output columns dropped; a v head
dim below hd (MLA's 192 / 128) is padded to the same instance. Zero
columns add exact zeros to q·k and to P·v, so it is the same function.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.peer_score import aligned, check_cuda_matrix

BLOCK = 128               # the Pallas kernel's default q and kv block
HEAD_DIMS = (64, 128, 256)  # the CUDA kernels' instances
# dtype -> the kernel that takes it: the one place the route is chosen
ROUTES = {torch.float32: "ffma", torch.bfloat16: "wgmma",
          torch.float16: "wgmma"}
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def in_band(row_lo: int, row_hi: int, col_lo: int, col_hi: int, *,
            skv: int, causal: bool, window: int) -> bool:
    """Whether any (row, col) of a block can be visible (Pallas `in_band`)."""
    ok = col_lo < skv
    if causal:
        ok &= col_lo <= row_hi
    if window:
        ok &= col_hi > row_lo - window
    return ok


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          q_offset: int = 0, scale: float | None = None):
    """The Pallas body in PyTorch: for each q block, the kv blocks in its
    band in order, with the online softmax (masked scores −1e30, masked
    p zeroed, l floored at 1e-30). scale multiplies q·k (default
    1/√hd). v's head dim dv may be below hd (MLA). → (B, Sq, H, dv) in
    q.dtype."""
    b, sq, h, hd = q.shape
    skv, kh, dv = k.shape[1], k.shape[2], v.shape[-1]
    if h % kh:
        raise ValueError(f"query heads {h} not a multiple of kv heads {kh}")
    if dv > hd:
        raise ValueError(f"v head dim {dv} exceeds q's {hd}")
    rep = h // kh
    bq, bkv = min(BLOCK, max(sq, 8)), min(BLOCK, max(skv, 8))
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    # (B, K, R, S, hd) queries and (B, K, S, hd) keys/values, in f32
    qf = q.float().reshape(b, sq, kh, rep, hd).permute(0, 2, 3, 1, 4)
    kf = k.float().permute(0, 2, 1, 3)
    vf = v.float().permute(0, 2, 1, 3)
    out = torch.empty((b, kh, rep, sq, dv), dtype=torch.float32,
                      device=q.device)
    for q0 in range(0, sq, bq):
        q1 = min(q0 + bq, sq)
        row_lo = q0 + q_offset
        qb = qf[:, :, :, q0:q1]
        m = torch.full(qb.shape[:-1], ref.NEG, device=q.device)
        l = torch.zeros_like(m)
        acc = qb.new_zeros(qb.shape[:-1] + (dv,))
        for c0 in range(0, skv, bkv):
            if not in_band(row_lo, row_lo + bq - 1, c0, c0 + bkv - 1,
                           skv=skv, causal=causal, window=window):
                continue
            c1 = min(c0 + bkv, skv)
            s = torch.einsum("bkrqh,bksh->bkrqs", qb,
                             kf[:, :, c0:c1]) * scale
            mask = ref.attention_mask(q1 - q0, c1 - c0, causal=causal,
                                      window=window,
                                      q_offset=row_lo - c0, device=q.device)
            s = torch.where(mask, s, ref.NEG)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkrqs,bksh->bkrqh", p, vf[:, :, c0:c1])
            m = m_new
        out[:, :, :, q0:q1] = acc / l.clamp_min(1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dv).to(q.dtype)


def padded_head_dim(hd: int) -> int:
    """The kernel instance a head dim runs on: the smallest of HEAD_DIMS
    at least hd. Raises above the largest."""
    for inst in HEAD_DIMS:
        if hd <= inst:
            return inst
    raise ValueError(f"the flash_attention kernel takes head_dim up to "
                     f"{HEAD_DIMS[-1]}, got {hd}")


def flash_attention_padded(fn, q, k, v, **kw):
    """`fn(q, k, v, scale=…, **kw)` on the head dim's kernel instance:
    q, k and v (whose head dim dv may be below q's, as MLA's) zero-padded
    on the head axis to `padded_head_dim(hd)`, the scale 1/√hd of the
    true head dim, the output's columns past dv dropped. Without padding
    it is `fn` with the default scale."""
    hd, dv = q.shape[-1], v.shape[-1]
    inst = padded_head_dim(hd)
    scale = 1.0 / math.sqrt(hd)
    if inst == hd == dv:
        return fn(q, k, v, scale=scale, **kw)

    def pad(t):
        n = inst - t.shape[-1]
        return torch.nn.functional.pad(t, (0, n)).contiguous() if n else t

    out = fn(pad(q), pad(k), pad(v), scale=scale, **kw)
    return out[..., :dv].contiguous()


def flash_attention_cuda(q, k, v, *, causal: bool = True, window: int = 0,
                         q_offset: int = 0):
    """The CUDA kernel of q's dtype (`ROUTES`). q (B, Sq, H, hd), k
    (B, Skv, K, hd), v (B, Skv, K, dv) with dv ≤ hd: contiguous CUDA tensors of one float dtype (f32, bf16
    or f16) on one device, hd ≤ 256 (other than 64, 128 and 256 through
    `flash_attention_padded`), H a multiple of K. A bf16/f16 q, k or v
    whose start is not 16-byte aligned (TMA's requirement) is copied
    first and takes the same kernel. Same output as
    `flash_attention_plain`."""
    if not isinstance(q, torch.Tensor) or q.dtype not in ROUTES:
        raise ValueError("q must be a float32/bfloat16/float16 tensor")
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_cuda_matrix(name, t, q.dtype, device=q.device)
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-D (B, S, heads, hd), got "
                             f"{tuple(t.shape)}")
    b, sq, h, hd = q.shape
    skv, kh = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    if tuple(k.shape) != (b, skv, kh, hd) or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"k/v must be (B, Skv, K, hd|dv) = "
                         f"{(b, skv, kh, hd)}, got {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if dv > hd:
        raise ValueError(f"v head dim {dv} exceeds q's {hd}")
    if skv < 1:
        raise ValueError("k/v must hold at least one position")
    padded_head_dim(hd)
    if kh < 1 or h % kh:
        raise ValueError(f"query heads {h} not a multiple of kv heads {kh}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if q.numel() == 0:
        return q.new_empty((b, sq, h, dv))
    return flash_attention_padded(_launch, q, k, v, causal=causal,
                                  window=window, q_offset=q_offset)


def _launch(q, k, v, *, causal: bool, window: int, q_offset: int,
            scale: float):
    """One launch of the kernel of q's dtype at an instance's head dim."""
    b, sq, h, hd = q.shape
    skv, kh = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    route = ROUTES[q.dtype]
    if route == "wgmma":
        q, k, v = aligned(q), aligned(k), aligned(v)
    lib = build.library()
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    args = (b, sq, skv, h, kh, hd, int(bool(causal)), int(window),
            int(q_offset), float(scale),
            torch.cuda.current_stream(q.device).cuda_stream)
    if route == "wgmma":
        code = lib.repro_flash_attention_wgmma(*ptrs, DTYPE_CODES[q.dtype],
                                               *args)
    else:
        code = lib.repro_flash_attention_f32(*ptrs, *args)
    flash_attention_cuda.launches += 1
    flash_attention_cuda.route_launches[route] += 1
    build.check(code, f"flash_attention ({route})")
    return out


flash_attention_cuda.launches = 0
# launches by route, for showing which kernel a dtype reached
flash_attention_cuda.route_launches = {"ffma": 0, "wgmma": 0}
