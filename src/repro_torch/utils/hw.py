"""Target-hardware constants of the port (reference `repro.utils.hw`,
whose target is a TPU v5e): one NVIDIA H100 SXM.

The peaks feed `launch/roofline.py` and the bounds `chip_smoke.py`
prints; they are never used to gate correctness. The FLOP/s and HBM
bandwidth figures are NVIDIA's H100 SXM data-sheet numbers (dense, no
sparsity); `hbm_bytes` is what `torch.cuda.get_device_properties(0)
.total_memory` reports on an H100 80GB HBM3 (PERF.md §6).
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ChipSpec:
    name: str
    peak_flops_fp32: float  # FLOP/s per chip, FFMA outside the tensor cores
    peak_flops_bf16: float  # FLOP/s per chip, dense bf16/f16 tensor cores
    peak_flops_tf32: float  # FLOP/s per chip, dense TF32 tensor cores
    hbm_bandwidth: float    # bytes/s per chip
    hbm_bytes: int          # HBM capacity per chip


H100_SXM = ChipSpec(
    name="h100_sxm",
    peak_flops_fp32=67e12,
    peak_flops_bf16=989e12,
    peak_flops_tf32=495e12,
    hbm_bandwidth=3.35e12,
    hbm_bytes=85_017_493_504,
)

# What the hand-written kernels are shaped to (the counterparts of the
# reference's MXU_TILE / VPU_LANES / SUBLANES):
WARP = 32                      # threads per warp (CUDA programming guide)
WGMMA_M = 64                   # rows of one warpgroup wgmma tile (PTX ISA,
                               # sm_90a `wgmma.mma_async` shapes m64nNk16)
NUM_SMS = 132                  # streaming multiprocessors of an H100 SXM
                               # (NVIDIA data sheet)
SMEM_PER_SM = 228 * 1024       # shared memory per SM, bytes (Hopper tuning
                               # guide; up to 227 KB of it to one block)
