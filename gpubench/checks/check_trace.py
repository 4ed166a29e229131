"""The profiler's reduction on a made-up trace: busy time as the union of
device intervals, the idle gaps and their labels, kernel families."""
from __future__ import annotations

import pytest

from gpubench.harness import trace

MS = 1_000_000  # ns


def events():
    host = [("host", trace.WINDOW, 0, 100 * MS, 1),
            ("host", "stage:phase_e", 0, 60 * MS, 1),
            ("host", "aten::mm", 10 * MS, 40 * MS, 1),
            ("host", "stage:aggregate", 60 * MS, 100 * MS, 1),
            ("host", "aten::other_thread", 0, 100 * MS, 2)]
    dev = [("device", "gemm_kernel", 0, 10 * MS, 0),
           ("device", "gemm_kernel", 5 * MS, 12 * MS, 0),       # overlaps
           ("device", "gossip_mix_vec4_kernel", 50 * MS, 70 * MS, 0),
           ("annotation", "stage:phase_e", 0, 60 * MS, 0),
           ("device", "late_kernel", 95 * MS, 110 * MS, 0)]     # clipped
    return host + dev


def test_reduce_busy_gaps_labels_and_families():
    red = trace.reduce({"events": events(), "wall_s": 0.1},
                       {"mix": ("gossip_mix_vec4_kernel",)})
    assert red["window_s"] == pytest.approx(0.1)
    assert red["busy_s"] == pytest.approx((12 + 20 + 5) / 1e3)
    assert red["kernels"]["mix"] == {"launches": 1,
                                     "device_s": pytest.approx(0.02)}
    gaps = red["idle_gaps"]
    assert [g[1] for g in gaps] == pytest.approx([0.038, 0.025])
    assert gaps[0][0] == "stage:phase_e > aten::mm"    # 12..50 ms, mid 31
    assert gaps[1][0] == "stage:aggregate"             # 70..95 ms
    assert red["device_ops"][0][0] == "gossip_mix_vec4_kernel"


def test_reduce_device_alone_takes_the_host_wall():
    dev = [e for e in events() if e[0] != "host"]
    red = trace.reduce({"events": dev, "wall_s": 0.11}, {})
    assert red["window_s"] == pytest.approx(0.11)
    assert red["busy_s"] == pytest.approx((12 + 20 + 15) / 1e3)
