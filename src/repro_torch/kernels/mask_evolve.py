"""DisPFL mask evolution — drop to the `keep` largest magnitudes, regrow,
re-project — reference `repro.kernels.mask_evolve`.

The magnitude threshold is found without a sort: non-negative float32
bit patterns are ordered like their int32 values, so 31 halvings of
[0, 0x7F800000], each counting the elements at or below the midpoint,
recover the (n − keep)-th smallest |x| exactly — equal, ties included,
to `partition(|x|, kth)[kth]` and to `torch.kthvalue(|x|, kth + 1)`.
Then

    mask = (|x| ≥ thr) | grow          out = x · mask   (a product:
                                                         −x·0 is −0.0)

`mask_evolve_cuda` launches the hand-written CUDA kernel
(`csrc/mask_evolve.cu`, which replaces the Pallas `mask_evolve`: its
`_thr_kernel` and `_apply_kernel`); `mask_evolve_plain` is its plain
PyTorch version, the same bisection over a whole tensor per step. Both
return (out, mask, thr); threshold, mask and output agree bitwise.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.peer_score import check_cuda_matrix

ITERS = 31                    # halvings of the interval down to one value
MAX_FINITE_BITS = 0x7F800000  # f32 +inf bit pattern: above every finite |x|
DTYPES = {torch.float32: 0, torch.bfloat16: 1}   # the kernel's dtype codes


def check_keep(keep: int, n: int):
    if not 1 <= keep <= n:
        raise ValueError(f"keep must be in [1, n], got keep={keep} for "
                         f"n={n}")


def magnitude_threshold_plain(x, kth: int):
    """The kth-smallest (0-based) |x| over all of x, as a 0-d float32
    tensor, by bisection over the int32 bits of |x| in float32 — no host
    synchronisation."""
    bits = x.float().abs().reshape(-1).view(torch.int32)
    target = kth + 1
    lo = torch.zeros((), dtype=torch.int64, device=x.device)
    hi = torch.full((), MAX_FINITE_BITS, dtype=torch.int64, device=x.device)
    for _ in range(ITERS):
        mid = lo + (hi - lo) // 2
        keep_lo = (bits <= mid).sum() >= target
        lo = torch.where(keep_lo, lo, mid + 1)
        hi = torch.where(keep_lo, mid, hi)
    return lo.to(torch.int32).view(torch.float32)


def mask_evolve_plain(x, grow, *, keep: int):
    """x: one stacked leaf (any shape) in float32 or bfloat16; grow: bool,
    same shape; keep: entries kept by magnitude. → (x·mask in x.dtype,
    mask bool, thr 0-d float32)."""
    check_keep(keep, x.numel())
    thr = magnitude_threshold_plain(x, x.numel() - keep)
    mask = (x.float().abs() >= thr) | grow
    return x * mask.to(x.dtype), mask, thr


def mask_evolve_cuda(x, grow, *, keep: int):
    """The CUDA kernel. x float32 or bfloat16, grow bool of the same
    shape, both contiguous on one CUDA device. → (x·mask in x.dtype, mask
    bool, thr 0-d float32), bitwise equal to `mask_evolve_plain`."""
    if not isinstance(x, torch.Tensor) or x.dtype not in DTYPES:
        raise ValueError(f"x must be a float32 or bfloat16 tensor, got "
                         f"{getattr(x, 'dtype', type(x))}")
    check_cuda_matrix("x", x, x.dtype)
    check_cuda_matrix("grow", grow, torch.bool, x.shape, x.device)
    n = x.numel()
    check_keep(keep, n)
    out = torch.empty_like(x)
    mask = torch.empty(x.shape, dtype=torch.bool, device=x.device)
    counts = torch.zeros((ITERS,), dtype=torch.int64, device=x.device)
    thr = torch.empty((), dtype=torch.int32, device=x.device)
    lib = build.library()
    code = lib.repro_mask_evolve(
        x.data_ptr(), DTYPES[x.dtype], grow.data_ptr(), n, n - keep + 1,
        counts.data_ptr(), out.data_ptr(), mask.data_ptr(), thr.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream)
    mask_evolve_cuda.launches += 1
    build.check(code, "mask_evolve")
    return out, mask, thr.view(torch.float32)


mask_evolve_cuda.launches = 0
