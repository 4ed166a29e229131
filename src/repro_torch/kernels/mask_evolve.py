"""DisPFL mask evolution — drop to the `keep` largest magnitudes, regrow,
re-project — reference `repro.kernels.mask_evolve`.

The magnitude threshold is found without a sort: non-negative float32
bit patterns are ordered like their int32 values, so the (n − keep)-th
smallest |x| — equal, ties included, to `partition(|x|, kth)[kth]` and
to `torch.kthvalue(|x|, kth + 1)` — can be searched for in the bits.
Then

    mask = (|x| ≥ thr) | grow          out = x · mask   (a product:
                                                         −x·0 is −0.0)

`mask_evolve_plain` is the plain PyTorch version: the reference's 31
halvings of [0, 0x7F800000], each counting the elements at or below the
midpoint over the whole tensor. `mask_evolve_leaves_cuda` launches the
hand-written CUDA kernel (`csrc/mask_evolve.cu`, which replaces the
Pallas `mask_evolve`: its `_thr_kernel` and `_apply_kernel`) over a list
of leaves in one call: an exact radix select, 8-bit digits of |x|'s bits
from the top (4 passes for float32, 2 for bfloat16), its result clamped
to NAN_END_BITS as the bisection's end is. `mask_evolve_cuda` is its
one-leaf case. All return (out, mask, thr); threshold, mask and output
agree bitwise.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.peer_score import check_cuda_matrix

ITERS = 31                    # halvings of the interval down to one value
MAX_FINITE_BITS = 0x7F800000  # f32 +inf bit pattern: above every finite |x|
# where the bisection ends when the kth-smallest |x| is a NaN: every step
# moves lo up, the interval closes on +inf a step early, and the last
# step moves lo one past it (a NaN threshold: only regrowth is kept)
NAN_END_BITS = MAX_FINITE_BITS + 1
DTYPES = {torch.float32: 0, torch.bfloat16: 1}   # the kernel's dtype codes
# radix passes a leaf takes: 8-bit digits of |x|'s bits 30..0 (the first
# digit 7 bits wide); bfloat16 |x| has no bits below 16
PASSES = {torch.float32: 4, torch.bfloat16: 2}
DIGIT_SHIFTS = (24, 16, 8, 0)  # each pass's lowest bit
THREADS = 256                 # a block of the kernel
ELEMS_PER_BLOCK = 8192        # elements a block takes before the grid grows
MAX_LEAF_BLOCKS = 8 * 132     # blocks of one leaf: 8 per SM of an H100
MAX_LEAVES = 1024             # leaves one call takes
STATE_WORDS = 260             # int64 workspace a leaf: 256 bins, ticket,
                              # prefix, target left, pad


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


def leaf_blocks(n: int) -> int:
    """Blocks the kernel gives a leaf of n elements: one per
    ELEMS_PER_BLOCK, at least 1, at most MAX_LEAF_BLOCKS (a block then
    strides over the leaf)."""
    return max(1, min(math.ceil(n / ELEMS_PER_BLOCK), MAX_LEAF_BLOCKS))


def leaf_plan(sizes, dtypes):
    """How one call lays out its leaves: → (order, begins, grid,
    grid_deep). `order` lists the leaves as the table holds them, float32
    first (they take passes 2 and 3); leaf order[r] owns blocks
    [begins[r], begins[r + 1]) of the grid (the last up to `grid`);
    `grid_deep` is the float32 leaves' blocks."""
    order = sorted(range(len(sizes)), key=lambda i: PASSES[dtypes[i]] != 4)
    begins, grid, grid_deep = [], 0, 0
    for i in order:
        begins.append(grid)
        grid += leaf_blocks(sizes[i])
        if PASSES[dtypes[i]] == 4:
            grid_deep = grid
    return order, begins, grid, grid_deep


def check_leaf(x, grow, keep: int, device=None):
    """Raise unless the kernel takes (x, grow, keep): x float32 or
    bfloat16, grow bool of its shape, both contiguous on one CUDA device
    (`device` when given), keep in [1, x.numel()]."""
    if not isinstance(x, torch.Tensor) or x.dtype not in DTYPES:
        raise ValueError(f"x must be a float32 or bfloat16 tensor, got "
                         f"{getattr(x, 'dtype', type(x))}")
    check_cuda_matrix("x", x, x.dtype, device=device)
    check_cuda_matrix("grow", grow, torch.bool, x.shape, x.device)
    check_keep(keep, x.numel())


def mask_evolve_leaves_cuda(leaves, grows, keeps, *, outs=None,
                            masks=None):
    """The CUDA kernel over a list of leaves in one call: leaf i keeps its
    keeps[i] largest |x| and regrows where grows[i]. Every leaf float32
    or bfloat16, its grow plane bool of the same shape, all contiguous on
    one CUDA device. → [(x·mask in x.dtype, mask bool, thr 0-d float32)]
    in the leaves' order, each bitwise equal to `mask_evolve_plain`.
    outs / masks: where given, the tensors written (they may be the
    leaves and the grow planes themselves: the apply reads x[i] and
    grow[i] before it writes out[i] and mask[i], in the same thread,
    after every histogram pass); else new ones.

    Element indices and counts are 64-bit in the kernel (a leaf's n and
    target, the chunk loops), so a client-stacked leaf may pass 2³¹
    elements.

    One launch per radix pass (4 with a float32 leaf, else 2) and one
    apply, whatever the number of leaves; no host synchronisation."""
    leaves, grows, keeps = list(leaves), list(grows), list(keeps)
    if not leaves or not len(leaves) == len(grows) == len(keeps):
        raise ValueError(f"need as many grow planes and keeps as leaves "
                         f"(at least one), got {len(leaves)}, {len(grows)}, "
                         f"{len(keeps)}")
    if len(leaves) > MAX_LEAVES:
        raise ValueError(f"the kernel takes at most {MAX_LEAVES} leaves a "
                         f"call, got {len(leaves)}")
    dev = leaves[0].device if isinstance(leaves[0], torch.Tensor) else None
    for x, grow, keep in zip(leaves, grows, keeps):
        check_leaf(x, grow, keep, dev)
    if outs is None:
        outs = [torch.empty_like(x) for x in leaves]
    if masks is None:
        masks = [torch.empty(x.shape, dtype=torch.bool, device=dev)
                 for x in leaves]
    order, begins, grid, grid_deep = leaf_plan(
        [x.numel() for x in leaves], [x.dtype for x in leaves])
    rows = [[leaves[i].data_ptr(), grows[i].data_ptr(), outs[i].data_ptr(),
             masks[i].data_ptr(), leaves[i].numel(),
             leaves[i].numel() - keeps[i] + 1, begin, DTYPES[leaves[i].dtype]]
            for i, begin in zip(order, begins)]
    table = torch.tensor(rows, dtype=torch.int64).pin_memory().to(
        dev, non_blocking=True)
    states = torch.zeros((len(leaves), STATE_WORDS), dtype=torch.int64,
                         device=dev)
    thr = torch.empty((len(leaves),), dtype=torch.int32, device=dev)
    lib = build.library()
    code = lib.repro_mask_evolve_leaves(
        table.data_ptr(), len(leaves), states.data_ptr(), thr.data_ptr(),
        grid, grid_deep, torch.cuda.current_stream(dev).cuda_stream)
    mask_evolve_cuda.launches += 1
    mask_evolve_cuda.leaves += len(leaves)
    build.check(code, "mask_evolve")
    thr = thr.view(torch.float32)
    row_of = {i: r for r, i in enumerate(order)}
    return [(outs[i], masks[i], thr[row_of[i]]) for i in range(len(leaves))]


def mask_evolve_cuda(x, grow, *, keep: int):
    """The CUDA kernel on one leaf (the one-leaf case of
    `mask_evolve_leaves_cuda`). x float32 or bfloat16, grow bool of the
    same shape, both contiguous on one CUDA device. → (x·mask in x.dtype,
    mask bool, thr 0-d float32), bitwise equal to `mask_evolve_plain`."""
    return mask_evolve_leaves_cuda([x], [grow], [keep])[0]


# calls of the kernel (each one launch per radix pass and an apply), and
# the leaves they covered
mask_evolve_cuda.launches = 0
mask_evolve_cuda.leaves = 0
