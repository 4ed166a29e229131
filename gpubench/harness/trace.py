"""The traced run's readings: rounds under `torch.profiler` reduced to the
device's busy time, the kernels' device time by family, the busiest
device operations and the longest idle gaps, each gap named by what the
host was doing then (the innermost host operation at the gap's middle,
under its `stage:` span); host synchronisations counted per round by
`torch.cuda.set_sync_debug_mode`.

Recording the host's operations doubles an LLM round's wall here, so the
busy and idle times come from rounds traced on the device alone; a round
traced on both sides names the gaps."""
from __future__ import annotations

import time
import warnings

WINDOW = "gpubench:window"
TOP = 10


def profile(run, sync, *, host: bool) -> dict:
    """Run `run()` (whole rounds; returns how many) under the profiler,
    between fences, inside a span named WINDOW; the host's operations
    recorded too where `host`. -> the raw events and the window's host
    wall."""
    import torch
    from torch.profiler import ProfilerActivity, record_function

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host
                                      else [])
    sync()
    with torch.profiler.profile(activities=acts) as prof:
        with record_function(WINDOW):
            t0 = time.perf_counter()
            rounds = run()
            sync()
            wall = time.perf_counter() - t0
    events = [(_kind(e), e.name(), e.start_ns(),
               e.start_ns() + e.duration_ns(), e.start_thread_id())
              for e in prof.profiler.kineto_results.events()]
    return {"events": events, "rounds": rounds, "wall_s": wall}


def _kind(event) -> str:
    """"device" (a kernel, copy or fill on the card), "annotation" (a
    span's mirror on the card) or "host"."""
    if "CUDA" in str(event.device_type()):
        return "annotation" if event.is_user_annotation() else "device"
    return "host"


def merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce(raw: dict, families: dict) -> dict:
    """busy_s, window_s, device time by kernel family ({family: [names
    the family's kernels contain]}), and the breakdown."""
    events = raw["events"]
    win = [e for e in events if e[1] == WINDOW and e[0] == "host"]
    if win:
        w0, w1, main = win[0][2], win[0][3], win[0][4]
    else:   # the device alone: the host's wall, ending at the last event
        ends = [e[3] for e in events if e[0] == "device"]
        if not ends:
            raise RuntimeError("the profiler recorded no device operation")
        w1 = max(ends)
        w0, main = w1 - int(raw["wall_s"] * 1e9), None
    device, by_name = [], {}
    fam = {f: [0, 0.0] for f in families}
    for act, name, a, b, _ in events:
        if act != "device":
            continue
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        device.append((a, b))
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e9
        for f, parts in families.items():
            if any(p in name for p in parts):
                fam[f][0] += 1
                fam[f][1] += (b - a) / 1e9
    busy = merge(device)
    busy_s = sum(b - a for a, b in busy) / 1e9
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
    host = [e for e in events
            if e[0] == "host" and e[4] == main and e[1] != WINDOW]
    return {
        "busy_s": busy_s,
        "window_s": (w1 - w0) / 1e9,
        "kernels": {f: {"launches": n, "device_s": s}
                    for f, (n, s) in fam.items()},
        "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP],
        "idle_gaps": [[gap_label(host, (a + b) // 2), (b - a) / 1e9]
                      for a, b in gaps],
    }


def gap_label(host, t) -> str:
    """The stage span and the innermost host operation open at time t."""
    open_ = [e for e in host if e[2] <= t < e[3]]
    if not open_:
        return "host: between operations"
    stage = [e[1] for e in open_ if e[1].startswith("stage:")]
    inner = max(open_, key=lambda e: e[2])[1]
    label = stage[0] if stage else "host"
    return label if inner == label else f"{label} > {inner}"


def count_syncs(run) -> int:
    """Host synchronisations that `run()` makes, as the CUDA sync debug
    mode reports them."""
    import torch

    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in seen)
