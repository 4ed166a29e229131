"""Fused Eq. 7–9 scoring with a streaming per-row top-k — reference
`repro.kernels.select_score`.

PFedDST's peer choice needs, for every client pair (i, j),

    S[i, j] = s_p · (α·s_l − s_d + c)        (paper Eq. 9)

then the k best peers per row. `select_topk_cuda` launches the
hand-written CUDA kernel (`csrc/select_topk.cu`, which replaces the
Pallas `select_topk`): the score tile lives in shared memory and only
(M, k) values and indices and (M, 2) row statistics reach device memory
(and, with the column or P splits of `select_plan`, per-split top-k
lists or partial Grams reach a workspace, merged in a fixed order).
`select_topk_plain` is its plain PyTorch version: the dense scores, then
a stable top-k.
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.peer_score import (MIN_SPLIT_P, SMS,
                                            check_cuda_matrix, check_width)

MAX_K = 32                 # the CUDA kernel's per-row carry width
TILE_M, TILE_N = 128, 128  # the kernel's Gram tile: rows × columns
TARGET_BLOCKS = SMS        # one block on each SM


@functools.lru_cache(maxsize=64)
def select_plan(m: int, p: int) -> tuple[int, int, int, int, int]:
    """How the kernel cuts the work: → (vec, col_splits, tiles_per_split,
    p_splits, chunk).

    The ceil(M / TILE_N) column tiles go in `col_splits` runs of
    `tiles_per_split` (the last one shorter), split c covering tiles
    [c·tiles_per_split, min((c+1)·tiles_per_split, tiles)), so that row
    tiles × column splits come as close to TARGET_BLOCKS as one wave of
    blocks allows. Where the (row, column) tiles number at most half of
    it, P is cut into `p_splits` chunks of `chunk` elements (the last one
    shorter) as well, at least MIN_SPLIT_P a chunk, for at most
    TARGET_BLOCKS blocks. `vec` is the floats a copy moves: the largest of
    4, 2, 1 dividing P (and every chunk). Every split is non-empty and
    together they cover the columns and P exactly."""
    if m < 1 or p < 1:
        raise ValueError(f"need M, P >= 1, got {m}, {p}")
    row_tiles, col_tiles = math.ceil(m / TILE_M), math.ceil(m / TILE_N)
    per = math.ceil(col_tiles / max(1, min(col_tiles,
                                           TARGET_BLOCKS // row_tiles)))
    col_splits = math.ceil(col_tiles / per)
    vec = 4 if p % 4 == 0 else 2 if p % 2 == 0 else 1
    p_splits = max(1, min(TARGET_BLOCKS // (row_tiles * col_tiles),
                          p // MIN_SPLIT_P))
    chunk = math.ceil(math.ceil(p / p_splits) / vec) * vec
    return vec, col_splits, per, math.ceil(p / chunk), chunk


def select_work_floats(m: int, k: int, plan) -> int:
    """float32 words of the kernel's workspace: inverse norms (rounded up
    to 4), the P chunks' partial Grams (with more than one chunk), the
    column splits' top-k carries (values, indices) and statistics."""
    _, col_splits, _, p_splits, _ = plan
    return (math.ceil(m / 4) * 4 + (p_splits * m * m if p_splits > 1 else 0)
            + col_splits * m * (2 * k + 2))


def check_k(k: int, m: int):
    if not 1 <= k <= max(m - 1, 1):
        raise ValueError(f"k must be in [1, M-1], got k={k} for M={m}")


def select_topk_plain(x, last_selected, s_l, t, cost, candidate_mask=None,
                      *, k: int, alpha: float, lam: float):
    """Dense Eq. 7–9 + stable top-k. → (values (M, k) f32, indices (M, k)
    int32, stats (M, 2) f32)."""
    check_k(k, x.shape[0])
    return ref.select_topk_ref(x, last_selected, s_l, t, cost,
                               candidate_mask, k=k, alpha=alpha, lam=lam)


def select_topk_cuda(x, last_selected, s_l, t, cost, candidate_mask=None,
                     *, k: int, alpha: float, lam: float):
    """The CUDA kernel. x (M, P) f32; last_selected (M, M) int32; s_l
    (M, M) f32; t int; cost a float or an (M, M) f32 tensor;
    candidate_mask None or (M, M) bool — all contiguous, on one CUDA
    device. Same outputs as `select_topk_plain`."""
    check_cuda_matrix("x", x, torch.float32)
    if x.dim() != 2 or x.shape[1] < 1:
        raise ValueError(f"x must be an (M, P) matrix, got {tuple(x.shape)}")
    m, p = x.shape
    check_k(k, m)
    check_width(p)
    if k > MAX_K:
        raise ValueError(f"the select_topk kernel takes k <= {MAX_K}, "
                         f"got k={k}")
    dev = x.device
    check_cuda_matrix("last_selected", last_selected, torch.int32, (m, m), dev)
    check_cuda_matrix("s_l", s_l, torch.float32, (m, m), dev)
    cost_ptr, cost_scalar = None, 0.0
    if isinstance(cost, torch.Tensor) and cost.dim() == 2:
        check_cuda_matrix("cost", cost, torch.float32, (m, m), dev)
        cost_ptr = cost.data_ptr()
    else:
        cost_scalar = float(cost)
    cand_ptr = None
    if candidate_mask is not None:
        check_cuda_matrix("candidate_mask", candidate_mask, torch.bool,
                          (m, m), dev)
        cand_ptr = candidate_mask.data_ptr()

    plan = vec, col_splits, per, p_splits, chunk = select_plan(m, p)
    if x.data_ptr() % (4 * vec):
        x = x.clone()   # a copy moves vec floats: align the rows' start
    f32 = dict(dtype=torch.float32, device=dev)
    work = torch.empty((select_work_floats(m, k, plan),), **f32)
    vals = torch.empty((m, k), **f32)
    idx = torch.empty((m, k), dtype=torch.int32, device=dev)
    stats = torch.empty((m, 2), **f32)
    lib = build.library()
    code = lib.repro_select_topk_f32(
        x.data_ptr(), work.data_ptr(), last_selected.data_ptr(),
        s_l.data_ptr(), int(t), cost_ptr, cost_scalar, cand_ptr,
        vals.data_ptr(), idx.data_ptr(), stats.data_ptr(),
        m, p, k, float(alpha), float(lam), vec, col_splits, per, p_splits,
        chunk, torch.cuda.current_stream(dev).cuda_stream,
    )
    select_topk_cuda.launches += 1
    select_topk_cuda.last_plan = plan
    build.check(code, "select_topk")
    return vals, idx, stats


select_topk_cuda.launches = 0
# (vec, col_splits, tiles_per_split, p_splits, chunk) of the last launch
select_topk_cuda.last_plan = None
