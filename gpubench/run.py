#!/usr/bin/env python3
"""Run one cell of the benchmark of `repro_torch` on one card.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up builds the cell's population (`strat.init(seed)`, every parameter
then drawn by the benchmark), makes the traffic from the seed and runs
the rounds the reference follows (the window's own call and feed). The
window then runs whole rounds back to back for `--seconds`. With
`--trace 1` it is followed by rounds under the profiler, one round under
the CUDA sync debug mode and rounds with fenced, timed stages. Last, the
program's state is freed and the plain reference reruns the followed
rounds in float32; their comparison decides `correct`.

The last line of standard output is the result's JSON; the numbers
compared, each beside its limit, are the last lines of standard error
and the result's last key. Without a card, without the program beside
this folder, or with JAX or the JAX package loaded, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
sys.path.insert(0, str(ROOT))


def log(*args):
    print(*args, file=sys.stderr, flush=True)


class ForbiddenImport(RuntimeError):
    pass


def assert_clean():
    from gpubench.harness.imports import forbidden_loaded

    found = forbidden_loaded()
    if found:
        raise ForbiddenImport(f"loaded in this process: {found}")


def card_line(torch, device) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", str(device.index or 0)],
            capture_output=True, text=True, timeout=30)
        log("card:", out.stdout.strip())
    except (OSError, subprocess.SubprocessError) as exc:
        log("card: nvidia-smi unavailable:", exc)
    return info


class Inputs:
    """A cell's inputs, all from the seed: the initial parameters (any
    leaf drawn again on demand), the clients' rows on the device and each
    round's draws."""

    def __init__(self, cell: dict, model: dict, seed: int, device):
        from gpubench.harness import traffic
        from gpubench.reference import fl as ref_fl

        self.cell, self.model, self.seed, self.device = (cell, model, seed,
                                                         device)
        self.ref_model = ref_fl.model_module(model)
        self.specs = self.ref_model.param_specs(model)
        self.dtype = ref_fl.storage_dtype(model)
        rows = traffic.client_rows(seed, cell, model)
        self.data = {k: v.to(device) for k, v in rows.items()}
        self.n_rows = next(iter(rows.values())).shape[1]

    def initial(self, client: int, name: str):
        from gpubench.harness import weights

        return weights.draw_leaf(self.seed, client, name, self.specs[name],
                                 self.dtype, self.device)

    def draws(self, r: int) -> dict:
        from gpubench.harness import traffic

        return traffic.round_draws(self.cell, self.seed, r, self.n_rows)

    def in_header(self, name: str) -> bool:
        return name.split("/")[0].split(".")[0] in self.ref_model.HEADER

    def extractor(self) -> list:
        return [n for n in self.specs if not self.in_header(n)]

    def header_params(self) -> int:
        return sum(math.prod(s[0]) for n, s in self.specs.items()
                   if self.in_header(n))


def follow_program(port, inp: Inputs):
    """The program's state after the rounds the reference follows, their
    readings, and the seconds the readings took."""
    state = port.init(inp.seed, inp.specs, inp.initial)
    followed = inp.cell["reference"]["rounds"]
    prog, t_read = {"rounds": []}, 0.0
    for r in range(followed):
        draws = inp.draws(r)
        watch = (port.first_steps(draws["act"].tolist(), inp.extractor())
                 if r == 0 else contextlib.nullcontext())
        with watch as first:
            state, metrics, scalars = port.round(state, inp.data,
                                                 (inp.seed, r), draws)
        t0 = time.perf_counter()
        if r == 0:
            prog["first"] = first
        prog["rounds"].append(port.round_reading(state, metrics, scalars))
        if r == 0:
            prog["mom0"] = port.momentum_norms(state)
        if r == followed - 1:
            prog["delta"] = port.change_norms(state, inp.initial)
        del metrics
        t_read += time.perf_counter() - t0
    return state, prog, t_read


def run_cell(name: str, cell: dict, model: dict, *, seed: int,
             seconds: float, trace: bool, device, metrics: list,
             t_start: float, program=None) -> dict:
    """One run of a cell -> the result dict. metrics: the BENCHMARK.json
    entries to report (end-to-end without trace, per-layer with it).
    program: a callable (cell, model, device) -> Port, for the checks
    that break the timed path underneath."""
    import torch

    from gpubench.harness import check, spec, window
    from gpubench.harness import trace as tracing
    from gpubench.harness.program import STAGES, Port

    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    inp = Inputs(cell, model, seed, device)
    data, draws = inp.data, inp.draws
    port = (program or Port)(cell, model, device)
    # set-up: the rounds the reference follows, then any further warm-up
    state, prog, t_read = follow_program(port, inp)
    followed = cell["reference"]["rounds"]
    counter = {"r": followed, "bad": 0}

    def next_round(round_fn=None):
        nonlocal state
        r = counter["r"]
        state, _, scalars = port.round(state, data, (seed, r), draws(r),
                                       round_fn)
        counter["r"] += 1
        if not all(math.isfinite(v) for k, v in scalars.items()
                   if "loss" in k):
            counter["bad"] += 1

    for _ in range(cell.get("warmup_rounds", 0)):
        next_round()
    counter["bad"] = 0

    # the window
    sync()
    mem0 = torch.cuda.memory_stats(device) if cuda else {}
    peak_setup = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    t_window = time.perf_counter()
    setup_s = t_window - t_start - t_read
    win = window.run_window(lambda i: next_round(), seconds, sync=sync)
    peak_window = torch.cuda.max_memory_allocated(device) if cuda else 0
    mem1 = torch.cuda.memory_stats(device) if cuda else {}
    failed = counter["bad"]
    for key in ("num_alloc_retries", "num_ooms"):
        log(f"allocator {key} over the window: "
            f"{mem1.get(key, 0) - mem0.get(key, 0)}")
    log(f"window: {win['rounds']} rounds in {win['wall_s']:.3f} s; set-up "
        f"{setup_s:.3f} s (check readings {t_read:.3f} s left out)")
    log("round walls (s):", " ".join(f"{w:.3f}" for w in win["round_walls"]))

    rec = {"cell": cell, "model": model, "setup_s": setup_s,
           "round_s": win["round_s"], "rounds": win["rounds"],
           "window_s": win["wall_s"], "peak_mem_gb": peak_window / 1e9,
           "header_params": inp.header_params(),
           "params": {n: math.prod(s[0]) for n, s in inp.specs.items()}}
    readers = {m["name"]: spec.reader(m["name"]) for m in metrics}
    breakdown = None
    device_info = card_line(torch, device)
    if trace:
        families = {n: r.KERNELS for n, r in readers.items()
                    if getattr(r, "KERNELS", None)}
        port.ops.reset_launch_counts()
        n_traced = cell["trace"]["rounds"]

        def traced():
            for _ in range(n_traced):
                next_round()
            return n_traced

        raw = tracing.profile(traced, sync, host=False)
        launches = dict(port.ops.launch_counts())
        red = tracing.reduce(raw, families)
        raw = tracing.profile(lambda: next_round() or 1, sync, host=True)
        gaps = tracing.reduce(raw, {})["idle_gaps"]
        del raw
        syncs = tracing.count_syncs(next_round) if cuda else 0
        fn, times = port.instrumented()
        for _ in range(cell["trace"]["stage_rounds"]):
            next_round(fn)
        stage_ms = {}
        for label, first in times.first.items():
            walls = [first] + times.steady.get(label, [])
            stage_ms[label] = 1e3 * sum(walls) / len(walls)
        rec.update(busy_s=red["busy_s"], trace_window_s=red["window_s"],
                   trace_rounds=n_traced, kernels=red["kernels"],
                   launches=launches, syncs_per_round=syncs,
                   stage_ms=stage_ms,
                   stage_sums={k: sum(stage_ms.get(s, 0.0) for s in v)
                               for k, v in STAGES.items()},
                   stages_seen=sorted(stage_ms))
        breakdown = {"device_ops": red["device_ops"], "idle_gaps": gaps}
        device_info.update(busy_s=red["busy_s"], window_s=red["window_s"])
        log("stage ms per round:", json.dumps(stage_ms))
        log("launches in the traced rounds:",
            json.dumps({k: v for k, v in launches.items() if v}))
    memory_peak = max(peak_setup,
                      torch.cuda.max_memory_allocated(device) if cuda else 0)
    device_info["memory_peak_bytes"] = memory_peak
    assert_clean()

    # the reference, once the program's state is freed
    del state, port
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_ref = time.perf_counter()
    ref = reference_readings(inp, prog)
    torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32 = tf32
    log(f"reference: {time.perf_counter() - t_ref:.1f} s")
    worst = {}
    numbers = check.gaps(prog, ref, cell, worst)
    log("worst leaves:", json.dumps(worst))
    correct, table = check.decide(numbers, cell["limits"])
    assert_clean()

    values = {}
    for m in metrics:
        v = readers[m["name"]].read(rec)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    result = {"correct": correct, "attempted": win["rounds"],
              "failed": failed, "metrics": values, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checked"] = table
    return result


def reference_readings(inp: Inputs, prog=None, *, precision="float32",
                       fault=None) -> dict:
    """The reference's readings of the followed rounds, following the
    program's selections (with prog None, its own)."""
    from gpubench.harness import weights
    from gpubench.reference import fl as ref_fl

    cell = inp.cell
    params = [weights.draw_client(inp.seed, c, inp.specs, inp.dtype,
                                  inp.device)
              for c in range(cell["fl"]["num_clients"])]
    pop = ref_fl.RefPopulation(inp.model, cell, params, inp.data,
                               precision=precision, fault=fault)
    out = {"rounds": []}
    for r in range(cell["reference"]["rounds"]):
        follow = None if prog is None else prog["rounds"][r]["mask"]
        out["rounds"].append(pop.round(inp.draws(r), follow_mask=follow))
        if r == 0:
            out["mom0"] = pop.momentum_norms()
            out["first"] = pop.first
    out["mom_end"] = pop.momentum_norms()
    out["delta"] = pop.change_norms(inp.initial)
    return out


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from gpubench.harness import spec

    try:
        cell = spec.cell(args.workload)
        model = spec.config(cell["config"])
    except FileNotFoundError as exc:
        log(f"gpubench: {exc}")
        return 2
    cache = ROOT / ".gpubench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(cache / sub)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        log(f"gpubench: cell {args.workload} needs {cell['chips']} CUDA "
            f"card(s); torch.cuda.is_available() is "
            f"{torch.cuda.is_available()}")
        return 2
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        log(f"gpubench: the program is not in this checkout ({src})")
        return 2
    sys.path.insert(0, str(src))
    torch.set_num_threads(2)
    kind = "per_layer" if args.trace else "end_to_end"
    try:
        result = run_cell(args.workload, cell, model, seed=args.seed,
                          seconds=args.seconds, trace=bool(args.trace),
                          device=torch.device("cuda", 0),
                          metrics=spec.metrics_of(args.workload, kind),
                          t_start=T_START)
    except ForbiddenImport as exc:
        log(f"gpubench: {exc}")
        return 3
    for name, row in result["checked"].items():
        log(f"check {name}: {row['value']!r} limit {row['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
