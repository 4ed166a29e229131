"""Host-side stage timing with a compile/steady split — reference
`repro.obs.timers`.

PyTorch queues CUDA work asynchronously, so a host clock attributes
device time to whichever call happens to wait. These helpers make the
attribution explicit, with `torch.cuda.synchronize(device)` as the fence
where the reference calls `block_until_ready` (on the CPU nothing is
queued and the fence is a no-op):

* `StageTimes` — per-label walls, the FIRST call (kernel builds, cuBLAS
  and allocator warm-up, cuDNN autotuning) apart from the steady mean.
* `instrument_stages` — wraps engine stages with fences, timing and a
  profiler span each, so a round attributes host wall to its stages.
* `RoundClock` — the whole-round variant `run_experiment` threads
  through: round 0's wall (or, chunked, the first chunk's) lands in
  `compile_s`, later rounds in `steady_s`.
* `annotate` — a `torch.profiler.record_function` span; the engine puts
  one around every stage (`stage:<name>`), so a torch.profiler trace
  groups a round's kernels by stage.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field

import torch


def stage_name(stage) -> str:
    """Display name of an engine stage: its `stage_name` attribute, else
    its function name."""
    return getattr(stage, "stage_name", getattr(stage, "__name__", "stage"))


@contextmanager
def annotate(name: str):
    """A profiler span (`torch.profiler.record_function`) around a block;
    inert unless a profiler is recording."""
    with torch.profiler.record_function(name):
        yield


@dataclass
class StageTimes:
    """Per-label wall-time accumulator with a first/steady split.

    first[label]    wall of the label's first observed call (kernel
                    builds, cuBLAS and allocator warm-up land here)
    steady[label]   list of subsequent call walls

    (The reference's `add/timed(rounds=)`, which spreads a chunked call
    over its rounds, comes with the first chunked caller of StageTimes.)
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


def fence(device):
    """Wait for the work queued on `device` (a CUDA card); nothing on the
    CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def instrument_stages(stages, times: StageTimes):
    """Wrap each engine stage with fences, timing and a profiler span.

    Returns a stage tuple for `engine.run_round`. Each wrapped stage
    fences the round's device (`ctx.active`'s) before starting its clock
    and after the stage returns, so queued work of stage N cannot leak
    into stage N+1's wall. The fences serialise host and device: a
    profiled round is slower than a plain one."""

    def wrap(stage):
        name = stage_name(stage)

        def timed(state, ctx):
            device = ctx.active.device
            fence(device)
            t0 = time.perf_counter()
            with annotate(f"stage:{name}"):
                out = stage(state, ctx)
            fence(device)
            times.add(name, time.perf_counter() - t0)
            return out

        timed.stage_name = name
        return timed

    return tuple(wrap(s) for s in stages)


@dataclass
class RoundClock:
    """Whole-round wall clock with the first-call split: the first
    context's wall lands in `compile_s`, every later one accumulates into
    `steady_s`; `elapsed()` is the steady wall only. The caller fences
    inside the context.

    `chunk(n)` times `n` rounds run as one chunk (`engine.make_multi_round`):
    the first chunk's whole wall is `compile_s` (the first-call costs and
    n executed rounds), later chunks add to `steady_s`. `last_s` is the
    latest context's per-round wall (chunk wall / n), what the trace
    records for each of its rounds. `round()` is `chunk(1)`."""
    compile_s: float = 0.0
    steady_s: float = 0.0
    rounds: int = 0
    last_s: float = 0.0

    @contextmanager
    def chunk(self, n: int):
        t0 = time.perf_counter()
        yield
        wall = time.perf_counter() - t0
        self.last_s = wall / n
        if self.rounds == 0:
            self.compile_s = wall
        else:
            self.steady_s += wall
        self.rounds += n

    @contextmanager
    def round(self):
        with self.chunk(1):
            yield

    def elapsed(self) -> float:
        return self.steady_s
