"""Fused Eq. 7–9 scoring with a streaming per-row top-k — reference
`repro.kernels.select_score`.

PFedDST's peer choice needs, for every client pair (i, j),

    S[i, j] = s_p · (α·s_l − s_d + c)        (paper Eq. 9)

then the k best peers per row. `select_topk_cuda` launches the
hand-written CUDA kernel (`csrc/select_topk.cu`, which replaces the
Pallas `select_topk`): the score tile lives in shared memory and only
(M, k) values and indices and (M, 2) row statistics reach device memory.
`select_topk_plain` is its plain PyTorch version: the dense scores, then
a stable top-k.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.peer_score import check_cuda_matrix

MAX_K = 32  # the CUDA kernel's per-row carry width


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

    f32 = dict(dtype=torch.float32, device=dev)
    inv = torch.empty((m,), **f32)
    vals = torch.empty((m, k), **f32)
    idx = torch.empty((m, k), dtype=torch.int32, device=dev)
    stats = torch.empty((m, 2), **f32)
    lib = build.library()
    code = lib.repro_select_topk_f32(
        x.data_ptr(), inv.data_ptr(), last_selected.data_ptr(),
        s_l.data_ptr(), int(t), cost_ptr, cost_scalar, cand_ptr,
        vals.data_ptr(), idx.data_ptr(), stats.data_ptr(),
        m, p, k, float(alpha), float(lam),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    select_topk_cuda.launches += 1
    build.check(code, "select_topk")
    return vals, idx, stats


select_topk_cuda.launches = 0
