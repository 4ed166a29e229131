"""Tiny versions of the cells and configurations, for the CPU checks:
the same files with the sizes cut so a check runs in seconds."""
from __future__ import annotations

import sys
import time

from gpubench.harness import spec

SRC = spec.ROOT / "src"
if str(SRC) not in sys.path:
    sys.path.insert(0, str(SRC))


def model(name: str, dtype: str = "float32", *, cnn_depth=(2, 2)) -> dict:
    """cnn_depth: the ResNet's blocks per stage (the control check keeps
    all four stages: at two the fp8 rounding of fewer layers can stay
    under the limit set at full size)."""
    m = spec.config(name)
    if m["family"] == "dense":
        m.update(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                 d_ff=128, vocab_size=512)
    else:   # 64 channels: GroupNorm's groups keep 8 channels, as at full width
        m.update(cnn_stages=list(cnn_depth), image_size=8)
    m["dtype"] = dtype
    return m


def cell(name: str) -> dict:
    c = spec.cell(name)
    if c["data"]["kind"] == "tokens":
        c["data"].update(seq_len=16, seqs_per_client=20, held_out=4)
        c["fl"]["batch_size"] = 2
    else:
        # lr 0.01: at 0.1 the tiny network's training amplifies float32
        # rounding past the checks' 1e-4 within three rounds
        c["fl"].update(num_clients=12, batch_size=8, probe_size=4,
                       client_sample_ratio=0.34, peers_per_round=3, lr=0.01)
        c["data"]["num_clients"] = 12
    c["trace"] = {"rounds": 1, "stage_rounds": 1}
    return c


def run(name: str, *, dtype="float32", seed=2 ** 33 + 7, program=None,
        c=None, m=None, metrics=None):
    """One CPU run of the tiny cell -> the result dict."""
    import torch

    from gpubench import run as bench_run

    c = c or cell(name)
    m = m or model(c["config"], dtype)
    if metrics is None:
        metrics = spec.metrics_of(name, "end_to_end")
    return bench_run.run_cell(
        name, c, m, seed=seed, seconds=0.2, trace=False,
        device=torch.device("cpu"), metrics=metrics,
        t_start=time.perf_counter(), program=program)
