"""The frozen counts against hand counts at the cells' shapes, and the
window's round_s from a fake clock."""
from __future__ import annotations

import math

import pytest

from gpubench.checks import tiny
from gpubench.harness import counts, spec, window
from gpubench.reference import qwen2

QWEN = spec.config("qwen2-1.5b")
P_HEADER = 1536 * 152064 + 1536                  # lm_head + final_norm
LAYER = (1536 * 1536 * 2 + 2 * 1536 * 256 + 3 * 1536 * 8960 + 2 * 1536
         + 1536 + 2 * 256)
N = 28 * LAYER + P_HEADER                         # 1,543,910,912


def test_parameter_counts():
    c = counts.dense_params(QWEN)
    assert c["header"] == P_HEADER == 233_571_840
    assert c["n"] == N == 1_543_910_912
    specs = qwen2.param_specs(QWEN)
    total = sum(math.prod(s[0]) for s in specs.values())
    assert total == c["extractor"] + c["header"]


def test_select_topk_work_at_the_llm_header():
    nbytes, flops = counts.select_topk_work(4, P_HEADER, 2)
    assert nbytes == 4 * P_HEADER * 4 + 3 * 16 * 4 + 16 + 4 * 2 * 8 + 4 * 2 * 4
    assert flops == 2 * 16 * P_HEADER
    # bytes bound it: 1.1156 ms at 3.35 TB/s
    assert counts.roofline_s(nbytes, flops, counts.PEAK_FP32_FLOPS) == \
        pytest.approx(3_737_149_744 / 3.35e12)


def test_extractor_count():
    assert counts.dense_params(QWEN)["extractor"] == 1_543_909_376


def test_round_model_flops():
    cell = tiny.cell("qwen2-pfeddst")
    cell["data"]["seq_len"] = 512
    cell["fl"]["batch_size"] = 4
    tokens = 4 * 512
    nh = P_HEADER
    per = (5 * (6 * N - 2 * nh) + (2 * N + 4 * nh)) * tokens
    want = 4 * (per + 2 * N * 4 * 4 * 512)
    assert counts.round_model_flops(QWEN, cell) == pytest.approx(want)


def test_round_s_is_whole_rounds_over_their_wall():
    now = [0.0]
    syncs = []

    def one_round(i):
        now[0] += 0.3

    out = window.run_window(one_round, 1.0, sync=lambda: syncs.append(1),
                            clock=lambda: now[0])
    assert out["rounds"] == 4 and len(syncs) == 2
    assert out["wall_s"] == pytest.approx(1.2)
    assert out["round_s"] == pytest.approx(0.3)
    assert out["round_walls"] == pytest.approx([0.3] * 4)
