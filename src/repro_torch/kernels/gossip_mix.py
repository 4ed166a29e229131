"""Sparse gossip mixing over packed neighbour lists — reference
`repro.kernels.gossip_mix`.

Row-stochastic gossip mixing (the aggregate step of dfedavgm, dfedpgp
and dispfl) is `out = W @ X` with at most D nonzeros per row of W (the
k gossip pulls and the client itself). Packed as (idx, w) lists
(`weights_to_neighbors`: ascending nonzero columns, padded with index 0
and weight 0.0), the mix is

    out[i] = Σ_d w[i, d] · x[idx[i, d]]      d ascending, f32 FMA steps

`gossip_mix_cuda` launches the hand-written CUDA kernel
(`csrc/gossip_mix.cu`, which replaces the Pallas `gossip_mix`);
`gossip_mix_plain` is its plain PyTorch version. Both accumulate the
slots in ascending order with one single-rounded multiply-add per slot,
which is what the reference's Pallas kernel, `gossip_mix_blocked` and
`ref.gossip_mix_ref` compute on the CPU (XLA contracts `acc + w·x` into
an FMA), so all of them agree bitwise. `gossip_mix_dense` scatters the
lists back to (M, M) and runs one matrix product: the reference's dense
route, a plain GEMM outside any kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.peer_score import check_cuda_matrix
from repro_torch.kernels.ref import fma_f32, neighbors_to_dense

MAX_D = 1024  # neighbour slots the CUDA kernel stages in shared memory


def weights_to_neighbors(weights, d_max: int):
    """Pack a dense (M, M) mixing matrix into neighbour lists.

    → (idx (M, d_max) int32 ascending nonzero columns, w (M, d_max) f32),
    padded with index 0 / weight 0.0. `d_max` must bound the true row
    degree (self included): overflow neighbours would be dropped."""
    nz = weights != 0.0
    # a stable sort of ~nz floats the nonzero columns to the front in
    # ascending column order — the accumulation order of every route
    order = torch.sort((~nz).to(torch.uint8), dim=1, stable=True).indices
    idx = order[:, :d_max]
    w = torch.gather(weights, 1, idx).float()
    return idx.to(torch.int32), w


def gossip_degree_bound(k: int, m: int, *, directed: bool,
                        topo_degree: int | None = None) -> int:
    """Static row-degree bound of a k-peer gossip plan, self included.

    Directed: each row pulls its own k picks → k + 1 (at most the
    topology's degree + 1 where a static graph bounds it). Undirected
    `mask | mask.T` plans add every peer that picked the row, which
    random selection bounds only by M − 1 — unless the communication
    topology does: the plan is cut to the candidate mask, a subset of the
    static adjacency (events only remove edges), so with a static graph of
    max degree `topo_degree` (`comms.topology.topology_degree_bound`)
    every row touches at most topo_degree peers and itself. Without a
    topology bound the undirected layout is D = M (callers mix dense)."""
    if directed:
        d = k + 1 if topo_degree is None else min(k, topo_degree) + 1
    elif topo_degree is not None:
        d = topo_degree + 1
    else:
        d = m
    return max(1, min(d, m))


def gossip_mix_plain(x, idx, w):
    """x (M, F); idx/w (R, D) packed lists (R = M for a whole mix, or a
    subset of its rows) → (R, F) in x.dtype: the D slots in ascending
    order, each a single-rounded f32 multiply-add."""
    xf = x.float()
    wf = w.float()
    idx = idx.long()
    acc = xf.new_zeros((idx.shape[0], xf.shape[1]))
    for d in range(idx.shape[1]):
        acc = fma_f32(wf[:, d:d + 1], xf[idx[:, d]], acc)
    return acc.to(x.dtype)


def gossip_mix_dense(x, idx, w):
    """Scatter the lists back to a dense (M, M) matrix and mix with one
    f32 matrix product (reference `gossip_mix_dense`)."""
    return (neighbors_to_dense(idx, w, x.shape[0]) @ x.float()).to(x.dtype)


def gossip_mix_cuda(x, idx, w):
    """The CUDA kernel. x (M, F) f32; idx (M, D) int32 with entries in
    [0, M); w (M, D) f32 — contiguous, on one CUDA device. → (M, F) f32,
    bitwise equal to `gossip_mix_plain`."""
    check_cuda_matrix("x", x, torch.float32)
    if x.dim() != 2 or x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"x must be a non-empty (M, F) matrix, got "
                         f"{tuple(x.shape)}")
    m, f = x.shape
    if idx.dim() != 2 or idx.shape[0] != m or idx.shape[1] < 1:
        raise ValueError(f"idx must be an (M, D) matrix with M={m}, got "
                         f"{tuple(idx.shape)}")
    d = idx.shape[1]
    if d > MAX_D:
        raise ValueError(f"the gossip_mix kernel takes D <= {MAX_D} "
                         f"neighbour slots, got D={d}")
    check_cuda_matrix("idx", idx, torch.int32, (m, d), x.device)
    check_cuda_matrix("w", w, torch.float32, (m, d), x.device)
    out = torch.empty_like(x)
    lib = build.library()
    code = lib.repro_gossip_mix_f32(
        x.data_ptr(), idx.data_ptr(), w.data_ptr(), out.data_ptr(), m, f, d,
        torch.cuda.current_stream(x.device).cuda_stream)
    gossip_mix_cuda.launches += 1
    build.check(code, "gossip_mix")
    return out


gossip_mix_cuda.launches = 0
