"""Chunked RWKV6 WKV — reference `repro.kernels.wkv_chunked`.

The recurrence S_t = diag(w_t)·S_{t−1} + k_t v_tᵀ,
o_t = r_tᵀ(S_{t−1} + diag(u)·k_t v_tᵀ) over chunks of C tokens, in the
closed form of the TPU kernel: the cross-chunk term (r⊙e^{cum_prev})·S₀,
the intra-chunk scores with the decay inside the contraction (every
exponent ≤ 0), the bonus diagonal, and the state update
S_C = diag(e^{cum_C})·S₀ + Σ_s (k_s⊙e^{cum_C−cum_s}) v_sᵀ.

`wkv_chunked_cuda` launches the two hand-written CUDA kernels of
`csrc/wkv_chunked.cu` (which replace the Pallas `wkv_chunked`): a state
pass that walks the chunks in order and keeps the state entering each,
then an output pass over all chunks at once, with the intra-chunk scores
in a sub-chunk factored form and the products in 3xTF32 on the tensor
cores. `wkv_chunked_plain` is their plain PyTorch version. Both take
r/k/v in the model's dtype, w, u and the state in f32, and return (out in
r.dtype, final state f32).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import DTYPE_CODES
from repro_torch.kernels.peer_score import aligned, check_cuda_matrix

CHUNK = 64           # the Pallas kernel's default chunk
HEAD_DIM = 64        # the CUDA kernel's head width


def wkv_chunked_plain(r, k, v, w, u, state=None):
    """r, k, v, w: (B, S, H, hd); u: (H, hd); state (B, H, hd, hd) or None.
    The sequence is padded as the Pallas wrapper pads it (r/k/v with 0, w
    with 1, chunk = min(64, max(S, 8))). → (out (B, S, H, hd) in r.dtype,
    final state (B, H, hd, hd) f32)."""
    b, s, h, hd = r.shape
    st = (torch.zeros((b, h, hd, hd), dtype=torch.float32, device=r.device)
          if state is None else state.float())
    chunk = min(CHUNK, max(s, 8))
    ps = (-s) % chunk
    nc = (s + ps) // chunk

    def chunks(a, fill):
        a = torch.nn.functional.pad(a.float(), (0, 0, 0, 0, 0, ps),
                                    value=fill)
        return a.reshape(b, nc, chunk, h, hd).permute(0, 3, 1, 2, 4)

    rc, kc, vc = (chunks(a, 0.0) for a in (r, k, v))
    wc = chunks(w, 1.0)                       # decay 1 ⇒ state unchanged
    uf = u.float()[None, :, None, :]          # (1, H, 1, hd)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=r.device), diagonal=-1)
    outs = []
    for c in range(nc):
        rr, kk, vv, ww = rc[:, :, c], kc[:, :, c], vc[:, :, c], wc[:, :, c]
        lw = torch.log(ww.clamp_min(1e-38))            # (B, H, C, hd) ≤ 0
        cum = torch.cumsum(lw, dim=2)
        cum_prev = cum - lw
        o = (rr * torch.exp(cum_prev)) @ st             # cross-chunk
        expo = cum_prev[:, :, :, None, :] - cum[:, :, None, :, :]
        expo = torch.where(tri[:, :, None], expo, -torch.inf)
        scores = (rr[:, :, :, None, :] * kk[:, :, None, :, :]
                  * torch.exp(expo)).sum(dim=-1)        # (B, H, C, C)
        diag = (rr * uf * kk).sum(dim=-1)
        o = o + scores @ vv
        o = o + diag[..., None] * vv
        k_dec = kk * torch.exp(cum[:, :, -1:] - cum)
        st = torch.exp(cum[:, :, -1])[..., None] * st + \
            k_dec.transpose(-1, -2) @ vv
        outs.append(o)
    out = torch.stack(outs, dim=2).permute(0, 2, 3, 1, 4)
    return out.reshape(b, s + ps, h, hd)[:, :s].to(r.dtype), st


def wkv_chunked_cuda(r, k, v, w, u, state=None):
    """The CUDA kernels, one launch of each pass. r, k, v: (B, S, H, 64)
    contiguous CUDA tensors of one float dtype; w: f32 of the same shape;
    u: (H, 64) f32; state: (B, H, 64, 64) f32 or None (zeros). An input
    whose start is not 16-byte aligned is copied first (the kernels load
    16 bytes at a time). Same outputs as `wkv_chunked_plain`; the state
    entering each chunk goes through an f32 scratch of
    (B, H, ceil(S / 64), 64, 64)."""
    if not isinstance(r, torch.Tensor) or r.dtype not in DTYPE_CODES:
        raise ValueError("r must be a float32/bfloat16/float16 tensor")
    if r.dim() != 4:
        raise ValueError(f"r must be (B, S, H, hd), got {tuple(r.shape)}")
    b, s, h, hd = r.shape
    dev = r.device
    for name, t in (("r", r), ("k", k), ("v", v)):
        check_cuda_matrix(name, t, r.dtype, (b, s, h, hd), dev)
    check_cuda_matrix("w", w, torch.float32, (b, s, h, hd), dev)
    check_cuda_matrix("u", u, torch.float32, (h, hd), dev)
    if hd != HEAD_DIM:
        raise ValueError(f"the wkv_chunked kernel takes head_dim "
                         f"{HEAD_DIM}, got {hd}")
    if state is None:
        state = torch.zeros((b, h, hd, hd), dtype=torch.float32, device=dev)
    check_cuda_matrix("state", state, torch.float32, (b, h, hd, hd), dev)
    out = torch.empty_like(r)
    s_fin = torch.empty_like(state)
    if s == 0 or b == 0 or h == 0:
        return out, s_fin.copy_(state)
    r, k, v, w, u, state = (aligned(t) for t in (r, k, v, w, u, state))
    s_chunks = torch.empty((b, h, -(-s // CHUNK), hd, hd),
                           dtype=torch.float32, device=dev)
    lib = build.library()
    code = lib.repro_wkv_chunked(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        state.data_ptr(), out.data_ptr(), s_fin.data_ptr(),
        s_chunks.data_ptr(), DTYPE_CODES[r.dtype], b, s, h, hd,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    wkv_chunked_cuda.launches += 1
    build.check(code, "wkv_chunked")
    return out, s_fin


wkv_chunked_cuda.launches = 0
