"""Roofline terms of a step on one H100 (reference `repro.launch.roofline`,
whose terms come from compiled HLO on TPU v5e constants).

Terms per (arch × shape × mesh), in seconds, on `utils.hw.H100_SXM`:

  compute    = Σ FLOPs of each peak class / that class's peak FLOP/s
  memory     = bytes / HBM bandwidth
  collective = 0: the port's steps run on one card and move nothing
               between chips (`coll_bytes` stays 0)

The reference walks optimized HLO text (`HloAnalyzer`). The port has no
compiled graph; `OpCounter` counts the aten ops a step runs, eagerly, on
`meta` tensors (shapes only, nothing allocated):

  FLOPs   2·|out|·Πcontract for the GEMM ops (`mm`, `addmm`, `bmm`,
          `baddbmm`, `addbmm`, `mv`, `addmv`, `dot`, `convolution` and its
          backward), by peak class: 16-bit operands at the dense bf16
          tensor peak, f32 at the FFMA peak (the TF32 tensor peak when
          `torch.backends.cuda.matmul.allow_tf32` is set). Elementwise
          work is not counted, as in the reference.
  bytes   operands plus outputs of every op that is not a view (views
          count zero; an expanded operand counts its distinct elements);
          gathers count their output twice and the index, scatters their
          source twice and the index (slices moved, as the reference's
          dynamic-slice rule); `copy_` / `fill_` do not read their
          destination. Eager has no fusion, so this is eager's HBM
          traffic.
  peak    the most bytes of storages the step created alive at once (its
          outputs included): the counterpart of `temp_size_in_bytes`.

Eager runs every layer, so there is no trip-count scaling; the recompute
of `torch.utils.checkpoint` runs under the counter and is counted, as the
reference's HLO counts remat (`useful_flops_ratio` shows it).

A call of `kernels.ops.flash_attention` or `kernels.ops.wkv` on meta
tensors takes the wrappers' shapes-only route (no plain version runs)
and is counted by the work its kernel does: flash 2·b·h·(hd + dv) per
visible (query, key) pair at the bf16 tensor peak (the FFMA peak in
f32), wkv 5·hd² + 5·hd per token and head at the TF32 tensor peak. These
are the formulas `chip_smoke.py`'s bounds use.

`xla_flops` keeps the reference's cross-check key: it holds
`torch.utils.flop_counter.FlopCounterMode`'s total over the same trace
(which sees no kernel call), and `xla_bytes` holds 0.0 (torch counts no
bytes).
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass, field

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.kernels import ops as kernel_ops
from repro_torch.utils.hw import H100_SXM, ChipSpec

_COLL_KINDS = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute",
)
PEAK_CLASSES = ("bf16", "tf32", "fp32")


def peak_flops(chip: ChipSpec, peak_class: str) -> float:
    return {"bf16": chip.peak_flops_bf16, "tf32": chip.peak_flops_tf32,
            "fp32": chip.peak_flops_fp32}[peak_class]


# ---------------------------------------------------------------------------
# the kernels' work
# ---------------------------------------------------------------------------

def visible_pairs(sq, skv, *, causal, window, q_offset) -> int:
    """(query, key) pairs the mask keeps: the work attention must do."""
    rows = np.arange(sq, dtype=np.int64) + q_offset
    hi = np.minimum(rows, skv - 1) if causal else np.full(sq, skv - 1)
    lo = np.maximum(rows - window + 1, 0) if window else np.zeros(sq,
                                                                  np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def flash_work(b, sq, skv, h, kh, hd, dv, itemsize, *, causal, window,
               q_offset) -> tuple:
    """→ (FLOPs, bytes) of one flash_attention call: q (b, sq, h, hd),
    k (b, skv, kh, hd), v (b, skv, kh, dv) read once, (b, sq, h, dv)
    written once; 2·(hd + dv) FLOPs per visible pair and head."""
    flops = 2.0 * b * h * (hd + dv) * visible_pairs(
        sq, skv, causal=causal, window=window, q_offset=q_offset)
    nbytes = (b * sq * h * hd + b * skv * kh * hd + b * skv * kh * dv
              + b * sq * h * dv) * itemsize
    return flops, nbytes


def wkv_ops(b, s, h, hd) -> float:
    """Operations the WKV recurrence needs over the sequence, per token and
    head: r·S (2·hd²), the state's decay and k·vᵀ update (3·hd²), and the
    bonus r·(u⊙k)·v (5·hd). Fewer than the TPU kernel's chunked form does
    (its (C, C, hd) decay products and exps: 2.2× more at hd = C = 64)."""
    return float(b * s * h * (5 * hd * hd + 5 * hd))


def wkv_work(b, s, h, hd, itemsize, *, state: bool) -> tuple:
    """→ (FLOPs, bytes) of one wkv call: r, k, v and the output in the
    model dtype, w (b, s, h, hd) and u (h, hd) f32, the f32 state written
    (and read, given one)."""
    nbytes = 4 * b * s * h * hd * itemsize + b * s * h * hd * 4 + \
        h * hd * 4 + (2 if state else 1) * b * h * hd * hd * 4
    return wkv_ops(b, s, h, hd), nbytes


def _flash_call(q, k, v, *, causal, window, q_offset):
    b, sq, h, hd = q.shape
    skv, kh, dv = k.shape[1], k.shape[2], v.shape[3]
    flops, nbytes = flash_work(b, sq, skv, h, kh, hd, dv, q.element_size(),
                               causal=causal, window=window,
                               q_offset=q_offset)
    return flops, nbytes, "fp32" if q.dtype == torch.float32 else "bf16"


def _wkv_call(r, k, v, w, u, state):
    b, s, h, hd = r.shape
    flops, nbytes = wkv_work(b, s, h, hd, r.element_size(),
                             state=state is not None)
    return flops, nbytes, "tf32"


KERNEL_WORK = {"flash_attention": _flash_call, "wkv_chunked": _wkv_call}


# ---------------------------------------------------------------------------
# the op counter
# ---------------------------------------------------------------------------

VIEW_OPS = frozenset((
    "view", "_unsafe_view", "expand", "permute", "transpose", "t", "slice",
    "select", "as_strided", "alias", "detach", "unsqueeze", "squeeze",
    "_reshape_alias", "lift_fresh", "unfold", "diagonal", "split",
    "split_with_sizes", "unbind", "chunk", "narrow", "view_as_real",
    "view_as_complex", "_neg_view", "_conj", "expand_as", "view_as",
))
NO_TRAFFIC_OPS = frozenset((
    "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "sym_size", "sym_stride", "sym_numel",
    "sym_storage_offset", "is_same_size", "_local_scalar_dense",
))
GATHER_OPS = frozenset(("index", "_unsafe_index", "gather", "index_select",
                        "embedding", "take"))
SCATTER_OPS = frozenset(("scatter_", "scatter_add_", "scatter_reduce_",
                         "index_put_", "_index_put_impl_", "index_add_",
                         "index_copy_"))
OVERWRITE_OPS = frozenset(("copy_", "fill_", "zero_", "normal_", "uniform_",
                           "random_", "bernoulli_", "exponential_"))


def _tensors(tree) -> list:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _distinct_bytes(t) -> int:
    """Bytes of the distinct elements a tensor reads: an expanded
    (stride-0) dim counts once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _out_bytes(t) -> int:
    return t.numel() * t.element_size()


def _gemm(name: str, args, out) -> tuple:
    """(2·|out|·Πcontract, the operand whose dtype picks the peak) of a
    GEMM aten op; (0.0, None) for any other op."""
    if name in ("mm", "bmm"):
        return 2.0 * out.numel() * args[0].shape[-1], args[0]
    if name in ("addmm", "baddbmm"):
        return 2.0 * out.numel() * args[1].shape[-1], args[1]
    if name == "addbmm":
        b1 = args[1]
        return 2.0 * out.numel() * b1.shape[0] * b1.shape[-1], b1
    if name in ("mv", "dot", "vdot"):
        return 2.0 * args[0].numel(), args[0]
    if name == "addmv":
        return 2.0 * args[1].numel(), args[1]
    if name == "convolution":
        w = args[1]
        return 2.0 * out.numel() * (w.numel() // w.shape[0]), args[0]
    if name == "convolution_backward":
        grad_out, w, mask = args[0], args[2], args[-1]
        per = 2.0 * grad_out.numel() * (w.numel() // w.shape[0])
        return per * (int(mask[0]) + int(mask[1])), grad_out
    return 0.0, None


def _gemm_class(t) -> str:
    if t.dtype in (torch.bfloat16, torch.float16):
        return "bf16"
    if t.dtype == torch.float32 and torch.backends.cuda.matmul.allow_tf32:
        return "tf32"
    return "fp32"


class OpCounter(TorchDispatchMode):
    """FLOPs, HBM bytes and peak live bytes of the aten ops run under it
    (see the module docstring), plus the kernel calls reported by
    `kernels.ops` on meta tensors. Not reentrant."""

    def __init__(self):
        super().__init__()
        self.flops_by_peak = {c: 0.0 for c in PEAK_CLASSES}
        self.bytes = 0.0
        self.kernel_calls = {}
        self.live_bytes = 0
        self.peak_live_bytes = 0
        self.non_meta_bytes = 0   # bytes of outputs not on the meta device
        self._live = {}

    @property
    def flops(self) -> float:
        return sum(self.flops_by_peak.values())

    def __enter__(self):
        kernel_ops.META_OBSERVERS.append(self._kernel_call)
        return super().__enter__()

    def __exit__(self, *exc):
        kernel_ops.META_OBSERVERS.remove(self._kernel_call)
        return super().__exit__(*exc)

    def _kernel_call(self, name, *args, **kwargs):
        flops, nbytes, peak_class = KERNEL_WORK[name](*args, **kwargs)
        self.flops_by_peak[peak_class] += flops
        self.bytes += nbytes
        self.kernel_calls[name] = self.kernel_calls.get(name, 0) + 1

    def _free(self, key, nbytes):
        if self._live.pop(key, None) is not None:
            self.live_bytes -= nbytes

    def _track(self, outs, operand_storages):
        for t in outs:
            s = t.untyped_storage()
            key = s._cdata
            if key in self._live or key in operand_storages:
                continue
            nbytes = s.nbytes()
            self._live[key] = nbytes
            self.live_bytes += nbytes
            weakref.finalize(s, self._free, key, nbytes)
        self.peak_live_bytes = max(self.peak_live_bytes, self.live_bytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        if func.is_view or name in VIEW_OPS:
            return out
        outs = _tensors(out)
        self._track(outs, {t.untyped_storage()._cdata
                           for t in _tensors((args, kwargs))})
        if name in NO_TRAFFIC_OPS:
            return out
        operands = _tensors((args, {k: v for k, v in kwargs.items()
                                    if k != "out"}))
        flops, operand = _gemm(name, args, outs[0]) if outs else (0.0, None)
        if flops:
            self.flops_by_peak[_gemm_class(operand)] += flops
        if name in GATHER_OPS:
            nbytes = sum(_distinct_bytes(t) for t in operands[1:]) + \
                2 * sum(_out_bytes(t) for t in outs)
        elif name in SCATTER_OPS:
            rest = operands[1:]
            written = _distinct_bytes(rest[-1]) if len(rest) >= 2 else \
                rest[0].numel() * operands[0].element_size()
            nbytes = sum(_distinct_bytes(t) for t in rest) + written
        else:
            reads = operands[1:] if name in OVERWRITE_OPS else operands
            nbytes = sum(_distinct_bytes(t) for t in reads) + \
                sum(_out_bytes(t) for t in outs)
        self.bytes += nbytes
        self.non_meta_bytes += sum(_out_bytes(t) for t in outs
                                   if not t.is_meta)
        return out


# ---------------------------------------------------------------------------
# report
# ---------------------------------------------------------------------------

def _no_collectives() -> dict:
    return {**{k: 0.0 for k in _COLL_KINDS}, "total": 0.0, "count": 0.0}


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float          # per device: the counter's FLOPs
    hlo_bytes: float          # per device: the counter's bytes
    coll_bytes: float = 0.0   # per device; 0 on one card
    coll_detail: dict = field(default_factory=_no_collectives)
    model_flops: float = 0.0  # analytic 6·N·D (global)
    xla_flops: float = 0.0    # FlopCounterMode's total (cross-check)
    xla_bytes: float = 0.0    # torch counts no bytes: 0.0
    chip: ChipSpec = H100_SXM
    # hlo_flops split by peak class; empty → all at the bf16 tensor peak
    flops_by_peak: dict = field(default_factory=dict)

    @property
    def t_compute(self) -> float:
        by = self.flops_by_peak or {"bf16": self.hlo_flops}
        return sum(f / peak_flops(self.chip, c) for c, f in by.items())

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / self.chip.hbm_bandwidth

    @property
    def t_collective(self) -> float:
        """0.0: one card, no collective (`coll_bytes` is 0)."""
        return 0.0

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / (global counted FLOPs) — remat/redundancy waste."""
        total = self.hlo_flops * self.chips
        return self.model_flops / total if total else 0.0

    def to_dict(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "hlo_flops_per_dev": self.hlo_flops,
            "hlo_bytes_per_dev": self.hlo_bytes,
            "coll_bytes_per_dev": self.coll_bytes,
            "coll_detail": self.coll_detail,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops,
            "useful_flops_ratio": self.useful_flops_ratio,
            "xla_flops_per_dev": self.xla_flops,
            "xla_bytes_per_dev": self.xla_bytes,
            "flops_by_peak": dict(self.flops_by_peak),
        }


def model_flops_for(cfg, shape) -> float:
    """Analytic MODEL_FLOPS = 6·N·D (dense) / 6·N_active·D (MoE).

    D = tokens processed by the step: B·S for train/prefill, B for decode.
    Train counts fwd+bwd (6·N·D); prefill/decode are forward-only (2·N·D).
    """
    n = cfg.active_param_count() if cfg.num_experts else cfg.param_count()
    if shape.kind == "train":
        # the PFedDST pair step runs phase-e + phase-h = 2 fwd + 2 bwd
        return 2 * 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch  # decode: one token per sequence


def report_from_counter(arch, shape_name, mesh_name, chips, counter, cfg,
                        shape, *, xla_flops: float = 0.0) -> RooflineReport:
    """A report from an `OpCounter` that ran the step (and the
    FlopCounterMode total of the same run)."""
    return RooflineReport(
        arch=arch, shape=shape_name, mesh=mesh_name, chips=chips,
        hlo_flops=counter.flops, hlo_bytes=counter.bytes,
        model_flops=model_flops_for(cfg, shape),
        xla_flops=float(xla_flops),
        flops_by_peak={c: f for c, f in counter.flops_by_peak.items() if f},
    )
