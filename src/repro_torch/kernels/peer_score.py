"""Eq. 7 header Gram — reference `repro.kernels.peer_score`.

`raw_gram_cuda` launches the hand-written CUDA kernel
(`csrc/raw_gram.cu`, which replaces the Pallas `raw_gram`);
`raw_gram_plain` is its plain PyTorch version. `gram_to_cosine` is the
single definition of the Eq. 7 normalization, shared by the kernel route
and the dense route of `core.scoring.header_distance_matrix`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build


def gram_to_cosine(raw):
    """(M, M) raw Gram → cosine matrix: normalize by the diagonal norms,
    guard zero-norm rows, clip to [-1, 1]."""
    norms = torch.diagonal(raw).clamp_min(0.0).sqrt() + 1e-12
    return (raw / (norms[:, None] * norms[None, :])).clamp(-1.0, 1.0)


def raw_gram_plain(x):
    """x: (M, P) → (M, M) float32 un-normalized Gram x @ x.T."""
    xf = x.float()
    return xf @ xf.T


def check_cuda_matrix(name: str, t, dtype, shape=None, device=None):
    """Raise unless `t` is a contiguous CUDA tensor of `dtype` (and of
    `shape` / on `device` when given) — what the kernels take."""
    if not isinstance(t, torch.Tensor) or not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} must be on {device}, got {t.device}")


def raw_gram_cuda(x):
    """x: (M, P) float32 contiguous CUDA tensor → (M, M) float32 Gram,
    computed by the CUDA kernel on the current stream."""
    check_cuda_matrix("x", x, torch.float32)
    if x.dim() != 2 or x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"x must be a non-empty (M, P) matrix, got "
                         f"{tuple(x.shape)}")
    m, p = x.shape
    out = torch.empty((m, m), dtype=torch.float32, device=x.device)
    lib = build.library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = lib.repro_raw_gram_f32(x.data_ptr(), out.data_ptr(), m, p, stream)
    raw_gram_cuda.launches += 1
    build.check(code, "raw_gram")
    return out


raw_gram_cuda.launches = 0
