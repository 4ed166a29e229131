"""Host-side stage timing with a first/steady split (reference
`repro.obs.timers.StageTimes`).

The clock is the host's; PyTorch queues CUDA work asynchronously, so a
caller that times device work ends the timed block with
`torch.cuda.synchronize()` (where the reference calls
`block_until_ready`). The rest of the reference's `obs` is ROADMAP queue 1
item 10.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field


@dataclass
class StageTimes:
    """Per-label wall-time accumulator with a first/steady split.

    first[label]    wall of the label's first observed call (kernel
                    builds, cuBLAS and allocator warm-up land here)
    steady[label]   list of subsequent call walls
    """
    first: dict = field(default_factory=dict)
    steady: dict = field(default_factory=dict)

    def add(self, label: str, dt: float):
        """Record one observed call of `label` taking `dt` seconds."""
        if label not in self.first:
            self.first[label] = dt
        else:
            self.steady.setdefault(label, []).append(dt)

    @contextmanager
    def timed(self, label: str):
        t0 = time.perf_counter()
        yield
        self.add(label, time.perf_counter() - t0)

    def summary(self) -> dict:
        """{label: {first_s, steady_s, compile_s, calls}}; compile_s is
        the first-call wall minus the steady mean, floored at 0."""
        out = {}
        for label, first in self.first.items():
            steady = self.steady.get(label, [])
            steady_s = sum(steady) / len(steady) if steady else 0.0
            out[label] = {
                "first_s": round(first, 6),
                "steady_s": round(steady_s, 6),
                "compile_s": round(max(first - steady_s, 0.0), 6),
                "calls": 1 + len(steady),
            }
        return out
