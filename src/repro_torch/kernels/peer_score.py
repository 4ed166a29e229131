"""Eq. 7 header Gram — reference `repro.kernels.peer_score`.

`raw_gram_cuda` launches the hand-written CUDA kernel
(`csrc/raw_gram.cu`, which replaces the Pallas `raw_gram`) with P split
across blocks by `gram_split_plan`; `raw_gram_plain` is its plain
PyTorch version. `gram_to_cosine` is the
single definition of the Eq. 7 normalization, shared by the kernel route
and the dense route of `core.scoring.header_distance_matrix`.
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.kernels import build

SMS = 132              # streaming multiprocessors of an H100 SXM
MIN_SPLIT_P = 64       # fewest P elements worth a split of their own
FULL_M = 1024          # from here on the output tiles alone fill the card


def gram_to_cosine(raw):
    """(M, M) raw Gram → cosine matrix: normalize by the diagonal norms,
    guard zero-norm rows, clip to [-1, 1]."""
    norms = torch.diagonal(raw).clamp_min(0.0).sqrt() + 1e-12
    return (raw / (norms[:, None] * norms[None, :])).clamp(-1.0, 1.0)


def raw_gram_plain(x):
    """x: (M, P) → (M, M) float32 un-normalized Gram x @ x.T."""
    xf = x.float()
    return xf @ xf.T


# the kernels index a row's columns with 32-bit ints (a slice's start plus
# a 32-column step); the largest LLM header, deepseek-v3's final_norm +
# lm_head, is 926,686,208 wide
MAX_WIDTH = 2 ** 31 - 64


def check_width(p: int):
    """Raise unless a row of P columns is within MAX_WIDTH."""
    if p > MAX_WIDTH:
        raise ValueError(f"the kernels take at most {MAX_WIDTH} columns a "
                         f"row, got P={p}")


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


def aligned(t):
    """t itself if its start is 16-byte aligned, else a copy (the caching
    allocator's blocks start 512-byte aligned)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


@functools.lru_cache(maxsize=64)
def gram_split_plan(m: int, p: int) -> tuple[int, int, int]:
    """How the kernel cuts the (M, P) Gram: → (tile, splits, chunk).

    Output tiles of `tile`² (16 for M ≤ 16, else 64); P cut into `splits`
    chunks of `chunk` elements (the last one shorter), split s covering
    [s·chunk, min((s+1)·chunk, P)). About 2 × SMS blocks in all, at least
    MIN_SPLIT_P elements a chunk where P allows, one split from FULL_M on.
    Every split is non-empty and together they cover P exactly."""
    if m < 1 or p < 1:
        raise ValueError(f"need M, P >= 1, got {m}, {p}")
    tile = 16 if m <= 16 else 64
    tiles = math.ceil(m / tile) ** 2
    splits = 1 if m >= FULL_M else max(
        1, min(math.ceil(2 * SMS / tiles), p // MIN_SPLIT_P))
    chunk = math.ceil(p / splits)
    return tile, math.ceil(p / chunk), chunk


def raw_gram_cuda(x):
    """x: (M, P) float32 contiguous CUDA tensor → (M, M) float32 Gram,
    computed by the CUDA kernel on the current stream: partial Grams over
    the chunks of `gram_split_plan`, summed in ascending order by a second
    launch (none with one chunk), so repeated calls agree bitwise."""
    check_cuda_matrix("x", x, torch.float32)
    if x.dim() != 2 or x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"x must be a non-empty (M, P) matrix, got "
                         f"{tuple(x.shape)}")
    m, p = x.shape
    check_width(p)
    tile, splits, chunk = plan = gram_split_plan(m, p)
    out = torch.empty((m, m), dtype=torch.float32, device=x.device)
    work = (torch.empty((splits, m, m), dtype=torch.float32,
                        device=x.device) if splits > 1 else None)
    lib = build.library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = lib.repro_raw_gram_f32(
        x.data_ptr(), out.data_ptr(), None if work is None else
        work.data_ptr(), m, p, tile, splits, chunk, stream)
    raw_gram_cuda.launches += 1
    raw_gram_cuda.last_plan = plan
    build.check(code, "raw_gram")
    return out


raw_gram_cuda.launches = 0
# (tile, splits, chunk) of the last launch, as passed to the kernel
raw_gram_cuda.last_plan = None
