#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`src/repro_torch`) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the script (non-zero exit) on any fault:

1. build    nvcc builds the port's CUDA kernels from `src/repro_torch/csrc`
            for sm_90a (timed); TF32 is switched off for matmuls and cuDNN.
2. kernels  each kernel against its plain PyTorch version on the card, at
            the PFedDST round's shapes (M=16 clients, P=5130 header
            elements, k=4) and at population scale (M=1024, 4096; k=10),
            with scalar and matrix Eq. 9 cost and a candidate mask.
            select_topk: indices exact (a flip is allowed only between
            scores within 1e-5 relative, and is counted), values rtol 1e-4,
            row stats rtol 1e-4 + atol 1e-6·M (sums of M cosines).
            raw_gram: error ≤ 1e-4 × the largest entry (fp32 sums of P
            products in another order). Times by CUDA events after warm-up.
3. path     `run_experiment("pfeddst")` and `run_experiment("pfeddst_random")`
            with use_score_kernel=True on full-width ResNet-18 in bf16 at the
            paper-scale settings of examples/fl_cifar_sim.py (M=16, 4 peers,
            batch 128, ratio 0.25, probe 16, 32×32 images, 120 samples per
            class, 2 steps per epoch), 3 rounds each. Launch counters are set
            to 0 just before and read just after; both kernels must have run.
            Losses must be finite and every active client must select
            exactly k peers.
4. agree    the same two strategies at a small f32 size on the card and on
            the CPU (plain versions, the path the CPU tests hold to the JAX
            reference) from the same parameters and draws: selection masks
            exact, loss matrices rtol 1e-3.
5. profile  one more pfeddst round under torch.profiler; the top CUDA
            kernels by time go to chiprun_out/chip_smoke_profile.txt.

Output: the card's name and power limit (nvidia-smi), one `kernels` JSON
line, the round walls, and last `{"ok": true, "device": {...}}`.
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"

# H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor cores, HBM3
FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def bound(bytes_moved: float, flops: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def select_case(m, p, k, *, matrix_cost, cand, seed, dev):
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((m, p), generator=g, device=dev)
    t = 5
    last = torch.randint(-1, t, (m, m), generator=g, device=dev,
                         dtype=torch.int32)
    s_l = torch.rand((m, m), generator=g, device=dev) * 3.0
    cost = (torch.rand((m, m), generator=g, device=dev) + 0.5
            if matrix_cost else 1.0)
    mask = (torch.rand((m, m), generator=g, device=dev) < 0.7) if cand \
        else None
    return x, last, s_l, t, cost, mask


def check_select(ops, ref, case, k, iters):
    import torch

    x, last, s_l, t, cost, mask = case
    m, p = x.shape
    kw = dict(k=k, alpha=1.0, lam=0.5)
    v, i, s = ops.select_topk(x, last, s_l, t, cost, mask, impl="cuda", **kw)
    pv, pi, ps = ops.select_topk(x, last, s_l, t, cost, mask, impl="plain",
                                 **kw)
    torch.cuda.synchronize()
    dense, _ = ref.select_score_ref(x, last, s_l, t, cost, mask, alpha=1.0,
                                    lam=0.5)
    bad = i != pi
    flips = 0
    if bad.any():
        rows, slots = bad.nonzero(as_tuple=True)
        sk = dense[rows, i[rows, slots].long()]
        sp = dense[rows, pi[rows, slots].long()]
        near = (sk - sp).abs() <= 1e-5 * sp.abs()
        if not bool(near.all()):
            raise AssertionError(
                f"select_topk M={m}: {int((~near).sum())} index mismatches "
                "beyond near-ties")
        flips = int(near.sum())
    torch.testing.assert_close(v, pv, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(s, ps, rtol=1e-4, atol=1e-6 * m)
    err = float((v - pv).abs().max())
    ms = time_ms(lambda: ops.select_topk(x, last, s_l, t, cost, mask,
                                         impl="cuda", **kw), iters)
    plain_ms = time_ms(lambda: ops.select_topk(x, last, s_l, t, cost, mask,
                                               impl="plain", **kw), iters)
    nbytes = m * p * 4 + 2 * m * m * 4 + m * k * 8 + m * 2 * 4
    if isinstance(cost, torch.Tensor):
        nbytes += m * m * 4
    if mask is not None:
        nbytes += m * m
    b_ms, b_by = bound(nbytes, 2.0 * m * m * p)
    return dict(m=m, p=p, k=k, matrix_cost=isinstance(cost, torch.Tensor),
                cand=mask is not None, flips=flips, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None)


def check_gram(ops, m, p, seed, dev, iters):
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((m, p), generator=g, device=dev)
    got = ops.raw_gram(x, impl="cuda")
    want = ops.raw_gram(x, impl="plain")
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    if not err <= 1e-4 * scale:
        raise AssertionError(f"raw_gram M={m}: max error {err} > 1e-4 × "
                             f"{scale}")
    ms = time_ms(lambda: ops.raw_gram(x, impl="cuda"), iters)
    plain_ms = time_ms(lambda: ops.raw_gram(x, impl="plain"), iters)
    library_ms = time_ms(lambda: torch.matmul(x, x.T), iters)
    b_ms, b_by = bound(m * p * 4 + m * m * 4, 2.0 * m * m * p)
    return dict(m=m, p=p, max_abs_err=err, rel_err=err / scale, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=library_ms)


# ---------------------------------------------------------------------------
# phase 3: the port's main path
# ---------------------------------------------------------------------------

def run_path(name, cfg, fl, data, rounds, dev, run_experiment):
    edge_checks = []

    def on_round(r, met):
        mask, active = met["select_mask"], met["active"]
        k = min(fl.peers_per_round, fl.num_clients - 1)
        per_row = mask.sum(dim=1)
        ok = bool((per_row[active] == k).all()) and \
            bool((per_row[~active] == 0).all()) and \
            not bool(mask.diagonal().any())
        edge_checks.append((int(mask.sum()), int(active.sum()) * k, ok))

    t0 = time.perf_counter()
    hist = run_experiment(name, cfg, fl, data, num_rounds=rounds,
                          eval_every=1, steps_per_epoch=2, seed=0,
                          verbose=False, device=dev, on_round=on_round)
    total = time.perf_counter() - t0
    h = hist.to_dict()
    # round 0's wall is compile_s; wall_s is the cumulative steady wall
    # after each round (eval_every=1), 0 after round 0
    steady = h["wall_s"]
    walls = [h["compile_s"]] + [b - a for a, b in zip(steady, steady[1:])]
    for key in ("train_loss_e", "train_loss_h", "s_l_mean",
                "mean_selected_score"):
        vals = h["extra"][key]
        if len(vals) != rounds or not all(math.isfinite(v) for v in vals):
            raise AssertionError(f"{name}: {key} not finite: {vals}")
    if not all(math.isfinite(a) for a in h["accuracy"]):
        raise AssertionError(f"{name}: accuracy not finite")
    for got, want, ok in edge_checks:
        if not ok or got != want:
            raise AssertionError(f"{name}: {got} selected edges, expected "
                                 f"{want} (k per active row, none else)")
    return dict(name=name, round_walls_s=walls, total_s=total,
                accuracy=h["accuracy"], edges=[e[0] for e in edge_checks],
                train_loss_e=h["extra"]["train_loss_e"])


# ---------------------------------------------------------------------------
# phase 4: the card agrees with the CPU path at a small size
# ---------------------------------------------------------------------------

def check_agreement(dev):
    import torch

    from repro_torch.configs import FLConfig, get_config
    from repro_torch.core.partial_freeze import make_phase_steps
    from repro_torch.core.rounds import PFEDDST_STREAMS, make_pfeddst_stages
    from repro_torch.core.client_state import init_population
    from repro_torch.data.synthetic import client_datasets_cifar
    from repro_torch.fl.engine import run_round
    from repro_torch.optim.sgd import sgd
    from repro_torch.utils.pytree import tree_map

    # width 32: 4 channels per GroupNorm group keeps f32 training
    # well-conditioned (see tests/test_torch_round.py)
    cfg = dataclasses.replace(get_config("resnet18-cifar").reduced(),
                              dtype="float32", image_size=8, cnn_width=32)
    data = client_datasets_cifar(1, 6, samples_per_class=20, image_size=8)
    train = {"images": data["train_x"], "labels": data["train_y"]}
    worst = {}
    for selection in ("topk", "random"):
        fl = FLConfig(num_clients=6, peers_per_round=2, batch_size=8,
                      client_sample_ratio=0.5, epochs_extractor=1,
                      epochs_header=1, probe_size=4, use_score_kernel=True,
                      selection=selection)
        opt = sgd(fl.lr, momentum=fl.momentum, weight_decay=fl.weight_decay)
        stages = make_pfeddst_stages(cfg, fl, make_phase_steps(cfg, opt),
                                     steps_per_epoch=1, probe_size=4,
                                     use_score_kernel=True)
        cpu_state = init_population(cfg, torch.Generator().manual_seed(3), 6,
                                    opt, opt, "cpu")
        gpu_state = cpu_state._replace(**{
            f: tree_map(lambda t: t.to(dev), getattr(cpu_state, f))
            for f in ("extractor", "header", "opt_e", "opt_h", "loss_matrix",
                      "last_selected")})
        gpu_train = {k: v.to(dev) for k, v in train.items()}
        for r in range(2):
            # same key → same CPU-generator draws on both devices
            cpu_state, cm = run_round(stages, cpu_state, train, (7, r), m=6,
                                      ratio=0.5, key_streams=PFEDDST_STREAMS)
            gpu_state, gm = run_round(stages, gpu_state, gpu_train, (7, r),
                                      m=6, ratio=0.5,
                                      key_streams=PFEDDST_STREAMS)
            if not torch.equal(cm["select_mask"], gm["select_mask"].cpu()):
                raise AssertionError(f"{selection} round {r}: selection "
                                     "masks differ between card and CPU")
            torch.testing.assert_close(gpu_state.loss_matrix.cpu(),
                                       cpu_state.loss_matrix, rtol=1e-3,
                                       atol=1e-4)
        worst[selection] = float((gpu_state.loss_matrix.cpu()
                                  - cpu_state.loss_matrix).abs().max())
    return worst


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: {src / 'repro_torch'} not found; run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    from repro_torch.configs import FLConfig, get_config
    from repro_torch.data.synthetic import client_datasets_cifar
    from repro_torch.fl.simulator import run_experiment
    from repro_torch.kernels import build, ops, ref

    dev = torch.device("cuda", 0)
    print("torch", torch.__version__, "cuda", torch.version.cuda, flush=True)
    card = card_line()

    # ---- 1. build ---------------------------------------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}", flush=True)
    t0 = time.perf_counter()
    so = build.build()
    build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s -> {so.name}", flush=True)
    for line in build.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("  ptxas:", line.strip())

    # ---- 2. kernels against their plain versions ---------------------------
    p = 512 * 10 + 10          # ResNet-18 header: fc weight + bias
    main_sel = []
    for matrix_cost, cand in ((False, False), (True, False), (False, True)):
        main_sel.append(check_select(
            ops, ref, select_case(16, p, 4, matrix_cost=matrix_cost,
                                  cand=cand, seed=1, dev=dev), 4, 200))
    scale_sel = [
        check_select(ops, ref, select_case(1024, p, 10, matrix_cost=False,
                                           cand=False, seed=2, dev=dev),
                     10, 20),
        check_select(ops, ref, select_case(4096, p, 10, matrix_cost=False,
                                           cand=False, seed=3, dev=dev),
                     10, 5),
        check_select(ops, ref, select_case(4096, p, 10, matrix_cost=True,
                                           cand=True, seed=4, dev=dev),
                     10, 5),
    ]
    grams = [check_gram(ops, 16, p, 5, dev, 200),
             check_gram(ops, 1024, p, 6, dev, 20),
             check_gram(ops, 4096, p, 7, dev, 5)]
    for row in main_sel + scale_sel:
        print("select_topk", json.dumps(row), flush=True)
    for row in grams:
        print("raw_gram", json.dumps(row), flush=True)
    print("select_topk near-tie index flips:",
          sum(r["flips"] for r in main_sel + scale_sel), flush=True)

    # ---- 3. the main path ---------------------------------------------------
    cfg = get_config("resnet18-cifar")             # full width, bf16
    fl = FLConfig(num_clients=16, peers_per_round=4, batch_size=128,
                  client_sample_ratio=0.25, probe_size=16,
                  use_score_kernel=True)
    data = client_datasets_cifar(0, fl.num_clients,
                                 classes_per_client=fl.classes_per_client,
                                 samples_per_class=120, image_size=32)
    ops.reset_launch_counts()
    paths = [run_path("pfeddst", cfg, fl, data, 3, dev, run_experiment)]
    after_pfeddst = ops.launch_counts()
    paths.append(run_path("pfeddst_random", cfg, fl, data, 3, dev,
                          run_experiment))
    launches = ops.launch_counts()
    print("launches:", json.dumps(launches),
          "after pfeddst:", json.dumps(after_pfeddst), flush=True)
    if after_pfeddst["select_topk"] < 1:
        raise AssertionError("pfeddst did not launch select_topk")
    if launches["raw_gram"] - after_pfeddst["raw_gram"] < 1:
        raise AssertionError("pfeddst_random did not launch raw_gram")
    for run in paths:
        print("path", json.dumps(run), flush=True)

    # ---- 4. card against CPU at a small size -------------------------------
    agree = check_agreement(dev)
    print("agree: masks exact, loss_matrix max abs diff", json.dumps(agree),
          flush=True)

    # ---- 5. profile one steady pfeddst round --------------------------------
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.fl.strategies import make_strategy

    strat = make_strategy("pfeddst", cfg, fl, 2, device=dev)
    state = strat.init(0)
    train = {"images": data["train_x"].to(dev),
             "labels": data["train_y"].to(dev)}
    state, _ = strat.round(state, train, (0, 0))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = strat.round(state, train, (0, 1))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    # device time = the kernels' own rows (the operator rows repeat it)
    dev_us = sum(e.self_device_time_total for e in events
                 if e.device_type == DeviceType.CUDA)
    table = events.table(sort_by="self_device_time_total", row_limit=25)
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke_profile.txt").write_text(
        f"{card}\nround wall {wall:.4f} s, device time {dev_us / 1e6:.4f} s"
        f"\n{table}\n")
    print(f"profile: steady pfeddst round wall {wall:.4f} s (profiled), "
          f"device kernel time {dev_us / 1e6:.4f} s "
          f"(busy share {dev_us / 1e6 / wall:.3f})", flush=True)
    top = sorted(events, key=lambda e: e.self_device_time_total,
                 reverse=True)[:8]
    for e in top:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:5d}x  "
              f"{e.key[:90]}")

    # ---- output -------------------------------------------------------------
    k_main = main_sel[0]
    g_main = grams[0]
    kernels = [
        {"name": "select_topk", "route": "cuda",
         "source": "src/repro_torch/csrc/select_topk.cu",
         "replaces": "src/repro/kernels/select_score.py:152",
         "launches": launches["select_topk"],
         "max_abs_err": max(r["max_abs_err"] for r in main_sel),
         "ms": k_main["ms"], "plain_ms": k_main["plain_ms"],
         "bound_ms": k_main["bound_ms"], "bound_by": k_main["bound_by"],
         "library_ms": None},
        {"name": "raw_gram", "route": "cuda",
         "source": "src/repro_torch/csrc/raw_gram.cu",
         "replaces": "src/repro/kernels/peer_score.py:83",
         "launches": launches["raw_gram"],
         "max_abs_err": g_main["max_abs_err"],
         "ms": g_main["ms"], "plain_ms": g_main["plain_ms"],
         "bound_ms": g_main["bound_ms"], "bound_by": g_main["bound_by"],
         "library_ms": g_main["library_ms"]},
    ]
    print("round walls (s):", json.dumps(
        {r["name"]: r["round_walls_s"] for r in paths}), flush=True)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
