#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`src/repro_torch`) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the script (non-zero exit) on any fault:

1. build    nvcc builds the port's CUDA kernels from `src/repro_torch/csrc`
            for sm_90a (timed); TF32 is switched off for matmuls and cuDNN.
            ptxas's wgmma serialisation warnings, if any, and the HGMMA
            (wgmma) instructions of each flash kernel instance in the
            library's SASS (cuobjdump) are printed: evidence that the
            bf16/f16 route reaches the tensor cores (fails if one holds
            none). The ptxas lines (registers, spill bytes) of the
            select_topk kernels (tile, P-split partial, merge), the two
            mask_evolve kernels (histogram, apply) and the two wkv_chunked
            kernels are printed as JSON (a second run from the same
            checkout finds the library built and has no report to print);
            each of them must be in the library's SASS, built now or
            earlier.
2. kernels  each kernel against its plain PyTorch version on the card, at
            the rounds' shapes and at population scale. Times by CUDA
            events after warm-up.
            select_topk (M=16, P=5130 header elements, k=4: scalar or
            matrix Eq. 9 cost, with or without a candidate mask, the
            matrix cost with the mask being what the main path sends under
            a fabric; M=1024, 4096, k=10): indices
            exact (a flip is allowed only between scores within 1e-5
            relative, and is counted), values rtol 1e-4, row stats rtol
            1e-4 + atol 1e-6·M (sums of M cosines); each row names the
            split plan (`select_plan`), and the scalar-cost rows at M=16,
            1024 and 4096 and the M=16 row with cost matrix and mask give
            the device time from CUDA-graph replay and the host's own time
            a call beside the per-call time.
            raw_gram (M=16, 1024, 4096; P=5130): error ≤ 1e-4 × the
            largest entry (fp32 sums of P products in another order), a
            second launch bitwise equal (split-K sums its splits in a fixed
            order), the split count, and besides the per-call time the
            device time from CUDA-graph replay, for torch.matmul too.
            gossip_mix (a dfedpgp plan at M=16, F=11,167,040 — the
            ResNet-18 extractor — D=5; M=1024, F=65,536, D=11; M=16,
            F=1,000,003, D=5, whose odd width takes the phased path with
            4-byte loads): bitwise.
            mask_evolve (the dispfl round's largest and smallest stacked
            leaves, 16×2,359,296 and 16×10 in bf16, and 16×64; keep = n/2,
            regrow 0.02): threshold, mask and output bits equal. Edge
            cases, batched and one-leaf, bits equal too: float32 and
            bfloat16 leaves with NaNs covering the kth position (threshold
            bits NAN_END_BITS) and of subnormal magnitudes (a subnormal
            threshold). Then the
            whole stage: the round's 56 stacked leaves (178.8 M bf16
            weights, keep by dispfl_sparsity) in one call of
            `mask_evolve_leaves_cuda`, each leaf's threshold, mask and
            output bitwise equal to the plain version's and a second call
            equal to the first; timed beside the same leaves through the
            one-leaf entry point one by one and the plain version's loop.
            flash_attention, each case through its dtype's route (bf16 and
            f16: the wgmma kernel; f32: the FFMA kernel; the route counters
            must show it): qwen2-1.5b prefill, q (4, 4096, 12, 128), k/v
            (4, 4096, 2, 128) bf16, causal, within one bf16 ulp, SDPA
            beside it; five ragged cases (rep 1 and 6, hd 64 and 128,
            ragged lengths, a window, a q_offset, not causal) in f32
            (within 1e-5·max(1, max|out|)), bf16 and f16 (within one ulp of
            the dtype); the prefill_32k shape (1, 32768, 12/2, 128), kernel
            and library times only; recurrentgemma-2b's attention, q (1,
            4096, 10, 256), k/v (1, 4096, 1, 256) bf16, causal, window 2048
            (the hd-256 instance), within one bf16 ulp, SDPA with the window
            as a mask beside it; an f32 ragged case at hd 96, zero-padded to
            the hd-128 instance, within 1e-5·max(1, max|out|)); then the
            new serving paths' prefill shapes in bf16, each within one ulp
            of the plain version, SDPA beside it: recurrentgemma-2b (4,
            4096, 4096, 10/1, hd 256, causal, window 2048), qwen2.5-14b
            (4, 4096, 4096, 40/8, hd 128, causal), whisper-base's encoder
            (4, 1500, 1500, 8/8, hd 64, not causal), its cross-attention
            (4, 416 queries, 1500 keys, 8/8, hd 64, not causal),
            phi3.5-moe (4, 4096, 4096, 32/8, hd 128, causal) and
            internvl2-76b (4, 4096, 4096, 64/8, hd 128, causal);
            deepseek-v3's MLA prefill (4, 4096, 4096, 128/128; q/k head
            dim 192 and v's 128, all zero-padded to the hd-256 instance):
            within one ulp of the plain version, SDPA (Ev ≠ E, no GQA
            flag) beside it, its bound on the true dims (2·pairs·(192 +
            128) operations; the bytes of the unpadded q, k, v and out).
            wkv_chunked, its two kernels (state pass, output pass) per call
            (rwkv6-7b prefill: B=4, S=4096, H=64, hd=64, r/k/v bf16,
            w = exp(−exp(U[−6, −1])) f32: one bf16 ulp; an f32 case with
            strong decay, S = 4096 + 37 and a nonzero initial state: output
            within 1e-4·max|out|, state within 1e-5·max|S|, against the
            plain version; f32 and bf16 cases with w = 0 in a quarter of the
            channels and w down to e^{−90}, at the same tolerances against
            the per-token recurrence `ref.wkv_ref`: there the plain
            version's exp of log-w prefix-sum differences lies beyond
            them, the kernel's products of w do not; the plain version's
            distance is printed).
3. path     `run_experiment` for every ported strategy on full-width
            ResNet-18 in bf16 at the paper-scale settings of
            examples/fl_cifar_sim.py (M=16, 4 peers, batch 128, ratio 0.25,
            probe 16, 32×32 images, 120 samples per class, 2 steps per
            epoch, K_e=5): pfeddst (use_score_kernel=True), pfeddst_random,
            dfedpgp and dispfl 3 rounds each; dfedavgm, fedavg, fedper and
            fedbabu 2 rounds each. The six baselines run at lr 0.01, not
            the paper's 0.1: there their full-model SGD step diverges to
            NaN within a round, in the JAX reference too. Launch counters are set to 0 just before
            each run and read after each of its rounds: select_topk must
            run in every pfeddst round, raw_gram in every pfeddst_random
            round, gossip_mix in every dfedpgp round, and mask_evolve
            exactly once in every dispfl round, that call covering all 56
            parameter leaves (the `leaves` counter). Losses and
            accuracy must be finite; every active client must select
            exactly k peers (pfeddst, dfedpgp) or at least k (the
            undirected plans), inactive ones none. All of these run under
            the default comms fabric (full topology, uniform links, no
            events): every round must report nonzero `round_bytes`. Then
            pfeddst runs 3 rounds twice more with cuDNN deterministic,
            once with `comms=None` and once under the default fabric: the
            two must select the same peers in every round.
            Then `serve_requests` (launch/serve.py) at full width and
            depth in bf16 with random weights, batch 4, 32 greedy tokens
            (SERVE_RUNS): qwen2-1.5b, rwkv6-7b and recurrentgemma-2b
            (prompt 4096, 3 requests), qwen2.5-3b, qwen2.5-14b and
            starcoder2-7b (prompt 4096, 2 requests), whisper-base (1500
            zero frames, the driver's stub; prompt 416, 3 requests), and
            at full width but cut depth (SERVE_DEPTHS; the full depth does
            not fit one card) phi3.5-moe (16 of 32 layers), deepseek-v3
            (MLA; 2 of 61) and internvl2-76b (text tokens only; 16 of 80),
            prompt 4096, 2 requests each; the launch counters set to 0
            just before each: the prefill kernel must run once per
            attention layer per request, flash_attention (qwen2 28,
            recurrentgemma 8, qwen2.5-3b 36, qwen2.5-14b 48, starcoder2 32,
            whisper 6 + 6 + 6, phi3.5-moe 16, deepseek-v3 2, internvl2-76b
            16), all on the wgmma route, or
            wkv_chunked once per layer (32), the other one never; logits
            finite, tokens inside the vocabulary; peak memory printed. After the rwkv6-7b requests, one more
            steady prefill of the same model and prompts runs under
            torch.profiler: wkv_chunked's share of device time, the device
            idle share and the top kernels (chiprun_out/
            chip_smoke_rwkv_prefill_profile.txt).
4. agree    at a small f32 size, the card against the CPU (plain versions,
            the path the CPU tests hold to the JAX reference) from the same
            parameters and draws: pfeddst and pfeddst_random selection
            masks exact, loss matrices rtol 1e-3; dfedpgp (packed kernel mix
            on the card, dense mix on the CPU) edges exact, params rtol
            1e-3; dispfl edges exact, masks exact apart from counted
            entries within rtol 2e-3 of their leaf's threshold, the other
            params rtol 1e-3. Serving at the reduced qwen2-1.5b, rwkv6-7b,
            recurrentgemma-2b (its window of 16 wrapped by the prompt),
            whisper-base (random frames), phi3.5-moe (both dispatch
            modes), deepseek-v3 and internvl2-76b configs in f32 (batch 2,
            prompt 80, 8 tokens), the same weights on both: greedy tokens
            equal, prefill logits and the KV / MLA latent cache / rwkv
            state / LRU states and rings / cross k/v within 1e-4 of their
            scale; the MoE configs' routing choices (gate_idx, keep)
            all equal.
5. profile  one more pfeddst round under torch.profiler; the top CUDA
            kernels by time go to chiprun_out/chip_smoke_profile.txt (the
            engine's `stage:<name>` ranges are left out of the kernel
            sum).
6. fabric   the comms fabric at the settings of phase 3, 3 rounds each.
            On a ring with hetero links, 10% link drops, 90% availability
            and 10% staleness: pfeddst (select_topk, every call given the
            candidate mask and the (M, M) cost matrix), pfeddst_random
            (raw_gram), dfedpgp, dfedavgm and dispfl (gossip_mix; the
            undirected plans pack at the ring's D = 3) and fedavg (star
            accounting). Each round: online participants, edges inside the
            round's candidate mask, `round_bytes` and the network time
            equal to the host transport's price of the round's edges at one
            message's bytes drawn independently (dispfl's is 1 − sparsity
            of the extractor's), the path's kernel launched. dfedavgm's
            last plan mixed by the kernel at the model's width: within rtol
            1e-3 of the dense mix, bitwise equal to the plain version,
            timed. pfeddst on hier_ring (clusters of 4, k = 2) through the
            packed SparseFabric and the dense fabric (cuDNN deterministic):
            equal masks every round. The packed fabric at M = 65536
            (hier_ring of 16, hetero links, events), P = 5130 f32 headers:
            one round_slots, one score_topk_sparse (k = 4), one gossip_mix
            with D = 5; times, peak memory, selected peers checked against
            the live CSR edges, the mix bitwise against the plain version
            on 4096 rows, beside a CSR sparse × dense product.
7. async    semi-async rounds and the round trace, at the settings of
            phase 3. (a) identity: pfeddst_async with no device profile
            and deadline_s=inf against pfeddst from the same seed and
            keys, 3 rounds each (pfeddst twice), under
            torch.use_deterministic_algorithms (warn only; the warnings
            are printed) and cuDNN deterministic: selection masks equal in
            every round, eff_lag_mean 0 and no round_wall_s; extractor,
            header, loss_matrix and last_selected bitwise equal at the end,
            or, where two pfeddst runs differ too, within their spread.
            (b) stragglers: a bimodal profile (a quarter of the clients 4×
            slower: 1.7 s and 6.8 s a round at 12 local steps, periods 1
            and 4 under deadline_s=2.0) on phase 6's ring with
            stale_mode="serve", 4 rounds through `run_experiment`, the
            launch counters set to 0 just before. Each round against the
            host's own draws: active = sampled ∧ online ∧ completer,
            store.lag = the deadline misses, round_wall_s =
            min(straggler, 2.0), the headers select_topk scored equal to
            the live rows of the participants and the ring slots of the
            others bitwise, select_topk launched on the card with the
            candidate mask and the cost matrix; History's device columns
            equal the round metrics. The store's bytes and the peak
            memory are printed. (c) trace: (b) again with trace= and
            trace_stages=True (chiprun_out/chip_smoke_async_trace.jsonl);
            the trace passes the port's `validate_trace` (the card
            machine has no jax), its device walls equal History's; the
            stage profile (first and steady ms of each stage) is printed.
8. open     the open world (`repro_torch.openworld`) and checkpoints, at
   world    the settings of phase 3, the launch counters set to 0 before
            each run. (a) identity: make_open_spec returns the very stage
            objects for inert ThreatConfig() / ChurnConfig(); a churn that
            keeps every slot alive (init_alive 0.99) and a gaussian attack
            of std 0 wrap pfeddst and equal plain pfeddst over 3 rounds
            (deterministic algorithms, as in phase 7 (a)). (b) pfeddst
            under sign_flip with score gaming ("both") and the median
            defense, 3 rounds, each checked against the host: the cast is
            adversary_mask(16, 0.25, 0); select_topk gets the (M, M) cost
            (adversary columns max(c)·cost_gain, the rest the fabric's) and
            the spoofed header rows (−mean of the honest rows); the
            snapshot is untouched until the corruption; the byzantine rows
            are pre − scale·(post − pre) and the honest rows pass through,
            bitwise; the card's median aggregate equals the CPU's on the
            same tensors bitwise (the first 32768 columns of every leaf);
            adv_edge_frac, adv_base_frac and adv_isolation equal a float32
            numpy recomputation. Then one round each with trimmed_mean
            (rtol 1e-6 of the CPU) and norm_clip; the aggregate's ms and
            peak memory above its inputs are printed. (c) dfedavgm under
            the scale attack on a ring (packed plan), 2 rounds: gossip_mix
            once a round with no defense, never under trimmed_mean (the
            robust mixer runs instead). (d) churn (join 0.3, leave 0.2,
            half alive): pfeddst 4 rounds — select_topk given the churn
            candidate mask every round, no dead client selects or is
            selected, joined rows bootstrapped from the pre-churn alive
            mean bitwise with optimizer rows 0, loss row 0, recency −1, the
            telemetry equal to the masks' counts; dispfl 3 rounds —
            mask_evolve once a round over all 56 leaves; then
            `run_experiment` under the attack and churn with eval_mask =
            the honest cast and a trace (chiprun_out/
            chip_smoke_openworld_trace.jsonl): the selection graph names
            the adversaries, `validate_trace` passes. (e) checkpoints: (b)'s
            population after 2 rounds saved and restored on the card
            bitwise (file bytes, save and restore s); `launch/serve.py
            --ckpt-dir` for qwen2-1.5b at full width in bf16 (batch 4,
            prompt 512, 16 tokens, 1 request) serves the saved
            parameters' greedy tokens. The checkpoints go to the
            gitignored `.smoke_ckpt/` (GBs) and are removed.
9. driver   the experiment drivers and chunked rounds, the launch counters
            set to 0 just before each run and read just after. (a0) the
            user's command unpatched at the CLI's own lr 0.1:
            `--paper-scale --rounds 5 --strategies pfeddst`, one chunk;
            the eval at round 5 with a finite accuracy, the loss printed
            as read. (a) the CLI at full width: `repro_torch.examples.fl_cifar_sim.main` on
            `--paper-scale --rounds 6 --strategies pfeddst dfedpgp
            dispfl` (full ResNet-18, bf16, M=16, the default chunk of 5:
            two chunks a strategy, 5 rounds and 1; all three at the
            baselines' lr 0.01 of phase 3: over 10 rounds at 0.1 pfeddst
            diverges too, in both packages,
            tests/test_torch_lr_divergence.py): losses and accuracy
            finite at rounds 5 and 6, gossip_mix 6 launches in 6 dfedpgp
            rounds, mask_evolve 6 calls over 6 × 56 leaves in 6 dispfl
            rounds; the steady per-round wall (the second chunk's)
            beside phase 3's. (b) chunk parity
            under deterministic algorithms: `run_experiment("pfeddst")` at
            phase 3's settings (select_topk), 4 rounds, eval_every 4,
            chunk_rounds=4 against chunk_rounds=1, and dfedavgm on phase
            6's ring (gossip_mix) at 2 rounds: every History field but the
            walls equal, the final state bitwise equal, the kernel
            launched once a round in each run. (c) host synchronisations
            (torch.cuda.set_sync_debug_mode("warn")) for pfeddst and
            dfedpgp: 2 make_round calls against one make_multi_round
            chunk of 2 from the same state and keys (the chunk must add
            none; the per-round run's sync locations are printed), and
            whole runs per round against chunked. (d) the quickstart twin
            (`repro_torch.examples.quickstart`) on the card. (e) what a
            chunk costs: pfeddst at phase 3's settings, 2 rounds, per
            round and as one chunk of 2 in turns, 3 runs of each; the
            medians of the run's wall and of its rounds' wall, per round,
            and each back-to-back pair's chunked / per-round ratio.
10. hybrid  (a) `rglru.rg_lru_scan` at recurrentgemma-2b's full width
            (B=4, S=4096, W=2560, f32) against the recurrence run step by
            step in f64 from the scan's own (a, b): within 1e-5 of the
            scale; its time. (b) one steady recurrentgemma-2b prefill
            (bf16, B=4, S=4096) under torch.profiler: device time, idle
            share, flash_attention's share (8 launches), the f32 GEMMs'
            share (the RG-LRU gates) and the 16-bit GEMMs'; the gate GEMMs
            once more by CUDA events (chiprun_out/
            chip_smoke_hybrid_prefill_profile.txt).
11. moe     phi3.5-moe (16 layers) and deepseek-v3 (2 layers) at full
            width in bf16, B=4, S=4096: (b) each layer's share of dropped
            assignments, read in a first prefill; (a) two more identical
            prefills must give bitwise-equal logits (the combine sums a
            token's experts in a fixed order); (c) one more steady
            phi3.5-moe prefill under torch.profiler: device time, idle
            share, the expert GEMMs' share, route + dispatch + combine
            (the `moe:` ranges), flash's and lm_head's (CUDA events)
            (chiprun_out/chip_smoke_moe_prefill_profile.txt).
12. llm     federated LLM training. (a) pfeddst (select_topk), pfeddst_
            random (raw_gram), dfedpgp (gossip_mix, one call a column
            block of the packed extractor) and dispfl (mask_evolve, one
            call over every leaf, in place) through `run_experiment` over
            qwen2-1.5b at full width and all 28 layers in bf16: M = 4,
            k = 2, batch 8 × 64 tokens of `synth_tokens` (2 domains),
            probe 4, lr 0.05, 2 rounds, eval every round; the launch
            counters set to 0 just before each run and read just after;
            each kernel's first call on the path held to its plain
            version on copies of its inputs (`KernelCheck`: the selection
            mask exact, raw_gram within 1e-3 of its scale, gossip_mix and
            mask_evolve bitwise); each run's steady round wall, peak
            memory, finite losses and launches. (b) `launch.train`'s main
            at (a)'s settings (its own FLConfig defaults otherwise): its
            final-accuracy line. (c) one `make_train_pair_step(...,
            remat=True)` step for rwkv6-7b, recurrentgemma-2b,
            whisper-base, phi3.5-moe and internvl2-76b (with 256 prefix
            rows through vision_proj) at full width and TRAIN_DEPTHS,
            its peak beside `pair_step_gb`'s reckoning. (d) every
            family's reduced f32 loss, metrics and gradients, card
            against CPU. Then the four kernels at (a)'s shapes against
            their plain versions, timed beside the library call
            (select_topk's row statistics and raw_gram, sums over P =
            2.3e8, held within 1e-3 and reported against float64).
13. dryrun  (a) the serve_demo twin's `main` with its defaults (qwen2-1.5b,
            deepseek-v3-671b, rwkv6-7b, recurrentgemma-2b, each
            `.reduced()`; batch 4, prompt 16, 8 greedy tokens) on the
            card, the launch counters set to 0 just before and read just
            after (flash_attention and wkv_chunked must have launched),
            and on the CPU from the same weights and prompts; then both
            in float32 (`--dtype float32`), whose greedy tokens must be
            equal (in bf16 the card's rounding can part them: the
            first differing (row, step) is printed). (b) the one-card
            dry run (`launch.dryrun`, a meta trace) against the card at two
            cells that fit it: qwen2-1.5b's prefill at 4 × 4096 (phase
            3's serving shape) and its remat pair step at phase 12's 8 ×
            64; the dry run's `argument_size_in_bytes` must equal the
            real inputs' bytes, and the steady wall of the real step must
            be at least max(t_compute_s, t_memory_s); the ratio and the
            peak-live reckoning beside `torch.cuda.max_memory_allocated`
            above the inputs are printed.

Output: each phase's wall, the card's name and power limit (nvidia-smi),
one `kernels` JSON line (`launches` from phase 3's run of the kernel's
path, `launches_fabric` from each phase-6 run, select_topk's
`launches_async` from phase 7 (b); `launches_openworld` of select_topk,
gossip_mix and mask_evolve from each phase-8 run; `launches_driver` of
the same three from each phase-9 run; `launches_llm` and `llm_shape`
of select_topk, raw_gram, gossip_mix and mask_evolve from phase 12;
`launches_serve_demo` of flash_attention and wkv_chunked from phase 13;
flash's `hd256`, `mla` and
`serving_shapes` rows from phase 2, and `launches_serve`, each serving
run's launches, from phase 3; mask_evolve's count calls,
each of 3–5 kernel launches, and its row also gives the leaves those
calls covered and the whole stage's time and device time; select_topk's
times are those of the M=16 case with the cost matrix and candidate mask
the main path sends, device time included), the round walls, and last
`{"ok": true, "device": {...}}`.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"

BASELINE_LR = 0.01   # the six baselines' SGD rate in phase 3 (see there)


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


def chip():
    """The H100 SXM's data-sheet peaks (`repro_torch.utils.hw.H100_SXM`:
    fp32 FFMA, dense bf16/fp16 and TF32 tensor cores, HBM3)."""
    from repro_torch.utils.hw import H100_SXM

    return H100_SXM


def bound(bytes_moved: float, flops: float, peak: float | None = None):
    """ms: the larger of the bytes once at HBM bandwidth and the
    operations at `peak` (default the fp32 FFMA peak)."""
    h100 = chip()
    peak = h100.peak_flops_fp32 if peak is None else peak
    t_bytes = bytes_moved / h100.hbm_bandwidth * 1e3
    t_ops = flops / peak * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


WKV_KERNELS = ("wkv_state_kernel", "wkv_output_kernel")
# kernels whose ptxas lines (registers, spills) phase 1 prints as JSON and
# whose presence it checks in the library's SASS
PTXAS_KERNELS = WKV_KERNELS + ("histogram_kernel", "apply_kernel",
                               "select_tile_kernel", "select_partial_kernel",
                               "select_merge_kernel")


class deterministic:
    """torch.use_deterministic_algorithms (warn only) and cuDNN
    deterministic, the settings of phases 7 (a), 8 (a) and 9 (b);
    restored on exit."""

    def __enter__(self):
        import torch

        self.flags = (torch.are_deterministic_algorithms_enabled(),
                      torch.backends.cudnn.deterministic,
                      torch.backends.cudnn.benchmark)
        torch.use_deterministic_algorithms(True, warn_only=True)
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False

    def __exit__(self, *exc):
        import torch

        torch.use_deterministic_algorithms(self.flags[0])
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark \
            = self.flags[1:]


def ptxas_report(log: str) -> dict:
    """Registers and spill bytes of every instance of the PTXAS_KERNELS in
    an `nvcc -Xptxas -v` log, by demangled-enough name. Fails if one of
    them is missing."""
    import re

    report, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            hit = [k for k in PTXAS_KERNELS if k in m.group(1)]
            name = f"{hit[0]} {m.group(1)}" if hit else None
            if name:
                report[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            report[name]["spill_stores"] = int(m.group(1))
            report[name]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            report[name]["registers"] = int(m.group(1))
    missing = [k for k in PTXAS_KERNELS
               if not any(n.startswith(k + " ") for n in report)]
    if missing:
        raise AssertionError(f"ptxas report lacks {missing}")
    return report


def tensor_core_evidence(so) -> dict:
    """HGMMA (wgmma) instructions in each flash kernel instance and HMMA
    (mma.sync) instructions in each wkv_chunked kernel instance of the
    built library's SASS, by the cuobjdump next to nvcc. Fails if there is
    no cuobjdump, a wgmma instance holds no HGMMA, or one of the two wkv
    kernels is missing or an instance of it holds no HMMA, or one of the
    PTXAS_KERNELS is not in the SASS (so a library built by an earlier run
    is checked too)."""
    import re

    from repro_torch.kernels import build

    cuobj = Path(build.nvcc_path()).parent / "cuobjdump"
    if not cuobj.exists():
        raise FileNotFoundError(f"{cuobj} not found: the SASS of the flash "
                                "kernels cannot be read")
    sass = subprocess.run([cuobj, "-sass", str(so)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    wkv_dtypes = {"f": "f32", "13__nv_bfloat16": "bf16", "6__half": "f16"}
    counts, hmma, name, op = {}, {}, None, None
    functions = []
    for line in sass.splitlines():
        if "Function :" in line:
            functions.append(line)
            m = re.search(r"flash_(wgmma|ffma)_kernelI(?:Lb([01])E)?Li(\d+)E",
                          line)
            mw = re.search(r"(wkv_(?:state|output)_kernel)I([^E]*)E", line)
            name = op = None
            if m is not None:
                kind, is_bf16, hd = m.groups()
                dtype = "" if kind == "ffma" else (
                    "bf16 " if is_bf16 == "1" else "f16 ")
                name, op, table = f"{kind} {dtype}hd{hd}", "HGMMA", counts
            elif mw is not None:
                kind, arg = mw.groups()
                name = f"{kind} {wkv_dtypes.get(arg, arg)}"
                op, table = "HMMA", hmma
            if name is not None:
                table[name] = 0
        elif name and op in line:
            table[name] += 1
    wgmma = {k: n for k, n in counts.items() if k.startswith("wgmma")}
    if not wgmma or not all(wgmma.values()):
        raise AssertionError(f"no HGMMA in the wgmma flash kernels: {counts}")
    if not all(any(k.startswith(w) for k in hmma) for w in WKV_KERNELS) \
            or not all(hmma.values()):
        raise AssertionError(f"wkv kernels missing or without HMMA: {hmma}")
    absent = [k for k in PTXAS_KERNELS if not any(k in f for f in functions)]
    if absent:
        raise AssertionError(f"kernels missing from the library: {absent}")
    return {"cuobjdump": str(cuobj), "hgmma": counts, "wkv_hmma": hmma}


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


def check_select(ops, ref, case, k, iters, *, graph=False, stats_rtol=1e-4,
                 f64=False):
    """select_topk against the plain version; times per call and, with
    `graph`, on the device alone (CUDA-graph replay) and on the host alone
    (the calls issued without waiting). stats_rtol: the row statistics'
    tolerance (sums of M cosines, each a ratio of P-term f32 sums: 1e-4
    at the rounds' P; the LLM headers' P = 2.3e8 states its own). f64:
    also report both routes' statistics against float64's."""
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
    stats_f64 = None
    if f64:
        xd = x.double()
        gram = xd @ xd.T
        inv = 1.0 / (gram.diagonal().sqrt() + 1e-12)
        cos = (gram * inv[:, None] * inv[None, :]).clamp(-1.0, 1.0)
        exact = torch.stack([cos.sum(1), cos.diagonal()], 1)
        del xd, gram
        stats_f64 = dict(kernel=float((s.double() - exact).abs().max()),
                         plain=float((ps.double() - exact).abs().max()))
    torch.testing.assert_close(s, ps, rtol=stats_rtol, atol=1e-6 * m)
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
    device_ms = host_ms = None
    if graph:
        def call():
            ops.select_topk(x, last, s_l, t, cost, mask, impl="cuda", **kw)

        device_ms = graph_ms(call, iters)
        # the host's own time a call: issue `iters` calls, then wait
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            call()
        host_ms = (time.perf_counter() - t0) / iters * 1e3
        torch.cuda.synchronize()
    return dict(m=m, p=p, k=k, matrix_cost=isinstance(cost, torch.Tensor),
                cand=mask is not None,
                plan=list(ops.KERNELS["select_topk"].last_plan),
                flips=flips, max_abs_err=err, stats_rtol=stats_rtol,
                stats_err_vs_f64=stats_f64, ms=ms, device_ms=device_ms,
                host_ms=host_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None)


def graph_ms(fn, reps: int, per_graph: int = 20) -> float:
    """Device time of one call of `fn`: `per_graph` calls captured in a
    CUDA graph and replayed, so the host's per-call overhead is left out."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                  # warm up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    return time_ms(graph.replay, max(1, reps // per_graph)) / per_graph


def check_gram(ops, m, p, seed, dev, iters, *, rtol=1e-4, f64=False):
    """raw_gram against the plain version (≤ rtol × the largest entry:
    1e-4 at the rounds' P; the LLM headers' P = 2.3e8 states its own; with
    `f64` both routes' errors against float64 reported), a second launch
    bitwise equal to the first (split-K sums the splits in a fixed order), times
    per call and, from CUDA-graph replay, on the device alone, beside
    torch.matmul's."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((m, p), generator=g, device=dev)
    got = ops.raw_gram(x, impl="cuda")
    # the (tile, splits, chunk) the wrapper passed to the kernel
    tile, splits, chunk = ops.KERNELS["raw_gram"].last_plan
    again = ops.raw_gram(x, impl="cuda")
    want = ops.raw_gram(x, impl="plain")
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    err_f64 = None
    if f64:
        exact = x.double() @ x.double().T
        err_f64 = dict(kernel=float((got.double() - exact).abs().max()),
                   plain=float((want.double() - exact).abs().max()),
                   scale=float(exact.abs().max()))
        del exact
    if not err <= rtol * scale:
        raise AssertionError(f"raw_gram M={m}: max error {err} > {rtol} × "
                             f"{scale}")
    if not torch.equal(got.view(torch.int32), again.view(torch.int32)):
        raise AssertionError(f"raw_gram M={m}: two launches differ")
    ms = time_ms(lambda: ops.raw_gram(x, impl="cuda"), iters)
    plain_ms = time_ms(lambda: ops.raw_gram(x, impl="plain"), iters)
    library_ms = time_ms(lambda: torch.matmul(x, x.T), iters)
    b_ms, b_by = bound(m * p * 4 + m * m * 4, 2.0 * m * m * p)
    return dict(m=m, p=p, tile=tile, splits=splits, chunk=chunk,
                bitwise_repeat=True, max_abs_err=err, rel_err=err / scale,
                rtol=rtol, err_vs_f64=err_f64,
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=library_ms,
                device_ms=graph_ms(lambda: ops.raw_gram(x, impl="cuda"),
                                   iters),
                library_device_ms=graph_ms(lambda: torch.matmul(x, x.T),
                                           iters))


def gossip_case(m, f, k, n_active, seed, dev):
    """A dfedpgp-shaped plan: directed k-peer picks of `n_active` sampled
    clients, the others keep themselves; packed lists (D = k + 1)."""
    import torch

    from repro_torch.core.aggregation import selection_to_weights
    from repro_torch.fl.engine import gossip_edges
    from repro_torch.kernels.gossip_mix import (gossip_degree_bound,
                                                weights_to_neighbors)

    g = torch.Generator(device=dev).manual_seed(seed)
    active = torch.zeros(m, dtype=torch.bool, device=dev)
    active[torch.randperm(m, generator=g, device=dev)[:n_active]] = True
    nbr = gossip_edges(torch.rand((m, m), generator=g, device=dev), k,
                       directed=True) & active[:, None]
    w = selection_to_weights(nbr, include_self=True)
    idx, wl = weights_to_neighbors(w, gossip_degree_bound(k, m,
                                                          directed=True))
    return torch.randn((m, f), generator=g, device=dev), idx, wl


def check_gossip(ops, ref, case, iters, plain_iters):
    import torch

    x, idx, w = case
    m, f = x.shape
    got = ops.gossip_mix(x, idx, w, impl="cuda")
    want = ops.gossip_mix(x, idx, w, impl="plain")
    torch.cuda.synchronize()
    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        raise AssertionError(
            f"gossip_mix M={m} F={f}: {int((got != want).sum())} entries "
            "differ from the plain version (bitwise)")
    err = float((got - want).abs().max())
    dense = ref.neighbors_to_dense(idx, w, m)
    ms = time_ms(lambda: ops.gossip_mix(x, idx, w, impl="cuda"), iters)
    plain_ms = time_ms(lambda: ops.gossip_mix(x, idx, w, impl="plain"),
                       plain_iters)
    library_ms = time_ms(lambda: torch.matmul(dense, x), iters)
    # the x rows the lists name with a nonzero weight, the lists, the output
    live = w != 0
    rows = int(torch.unique(idx[live]).numel())
    b_ms, b_by = bound(rows * f * 4 + idx.numel() * 8 + m * f * 4,
                       2.0 * int(live.sum()) * f)
    return dict(m=m, f=f, d=idx.shape[1], nonzero=int(live.sum()),
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=library_ms)


def check_evolve(me, shape, dtype, seed, dev, iters, *, lib_iters=None):
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn(shape, generator=g, device=dev) * 0.05).to(dtype)
    grow = torch.rand(shape, generator=g, device=dev) > 0.98
    n = x.numel()
    keep = max(int(n * 0.5), 1)
    out, mask, thr = me.mask_evolve_cuda(x, grow, keep=keep)
    p_out, p_mask, p_thr = me.mask_evolve_plain(x, grow, keep=keep)
    torch.cuda.synchronize()
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    for what, ok in (
            ("threshold", torch.equal(thr.view(torch.int32),
                                      p_thr.view(torch.int32))),
            ("mask", torch.equal(mask, p_mask)),
            ("output", torch.equal(out.view(bits), p_out.view(bits)))):
        if not ok:
            raise AssertionError(f"mask_evolve {tuple(shape)} {dtype}: "
                                 f"{what} differs from the plain version")
    err = float((out.float() - p_out.float()).abs().max())

    def library():
        t = torch.kthvalue(x.float().abs().reshape(-1), n - keep + 1).values
        mk = (x.float().abs() >= t) | grow
        return x * mk.to(x.dtype), mk

    ms = time_ms(lambda: me.mask_evolve_cuda(x, grow, keep=keep), iters)
    plain_ms = time_ms(lambda: me.mask_evolve_plain(x, grow, keep=keep),
                       iters)
    library_ms = (time_ms(library, iters) if lib_iters is None
                  else time_ms(library, lib_iters, warmup=1))
    # x and grow read once, out and mask written once; the work is a
    # comparison and a product per element
    b_ms, b_by = bound(n * (2 * x.element_size() + 2), 2.0 * n)
    return dict(shape=list(shape), dtype=str(dtype).split(".")[-1], n=n,
                keep=keep, thr=float(thr), kept=int(mask.sum()),
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=library_ms)


def evolve_edge_leaves(dev):
    """Leaves whose thresholds are the radix select's edge cases: float32
    and bfloat16 leaves with NaNs (of both signs) covering the kth
    position, so the threshold is the bisection's NaN end, and float32 and
    bfloat16 leaves of subnormal magnitudes, so the threshold is one.
    → (leaves, grows, keeps)."""
    import torch

    g = torch.Generator(device=dev).manual_seed(17)
    leaves, grows, keeps = [], [], []
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(20_000, generator=g, device=dev)
        x[::8] = torch.nan
        x[4::8] = -torch.nan
        leaves.append(x.to(dtype))
        keeps.append(x.numel() // 8)     # kth = 7n/8 lies in the NaNs
        x = torch.randn(20_000, generator=g, device=dev) * 1e-39
        x[::7] = 0.0
        leaves.append(x.to(dtype))
        keeps.append(x.numel() // 2)
    grows = [torch.rand(x.shape, generator=g, device=dev) > 0.98
             for x in leaves]
    return leaves, grows, keeps


def check_evolve_edges(me, dev):
    """The edge-case leaves in one batched call and through the one-leaf
    entry point: threshold, mask and output bits equal to the plain
    version's; the NaN leaves' threshold is NAN_END_BITS and the subnormal
    leaves' a subnormal, so the cases are what they claim."""
    import torch

    leaves, grows, keeps = evolve_edge_leaves(dev)
    got = me.mask_evolve_leaves_cuda(leaves, grows, keeps)
    thrs = []
    for i, (x, grow, keep, res) in enumerate(zip(leaves, grows, keeps, got)):
        bits = torch.int16 if x.dtype == torch.bfloat16 else torch.int32
        p_out, p_mask, p_thr = me.mask_evolve_plain(x, grow, keep=keep)
        for route, (out, mask, thr) in (
                ("batched", res),
                ("one-leaf", me.mask_evolve_cuda(x, grow, keep=keep))):
            for what, ok in (
                    ("threshold", torch.equal(thr.view(torch.int32),
                                              p_thr.view(torch.int32))),
                    ("mask", torch.equal(mask, p_mask)),
                    ("output", torch.equal(out.view(bits),
                                           p_out.view(bits)))):
                if not ok:
                    raise AssertionError(f"mask_evolve edge leaf {i} "
                                         f"{x.dtype} ({route}): {what} "
                                         "differs from the plain version")
        t = int(p_thr.view(torch.int32))
        if (i % 2 == 0) != (t == me.NAN_END_BITS) or \
                (i % 2 == 1 and not 0 < t < 0x00800000):
            raise AssertionError(f"mask_evolve edge leaf {i}: threshold "
                                 f"bits {t:#x} are not the case's")
        thrs.append(f"{t:#010x}")
    return dict(leaves=len(leaves), thr_bits=thrs)


def check_evolve_stage(me, shapes, keep_frac, seed, dev, iters):
    """The dispfl round's mask evolution: every stacked leaf (`shapes`,
    bfloat16, keep = max(int(n·keep_frac), 1), regrow 0.02) in one call
    of the batched kernel, each leaf's threshold, mask and output bits
    equal to the plain version's; a second call equal to the first. Times
    the call (and its kernels' device time under torch.profiler), the same
    leaves through the one-leaf entry point one by one, and the plain
    version's loop."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator(device=dev).manual_seed(seed)
    leaves = [(torch.randn(s, generator=g, device=dev) * 0.05).to(
        torch.bfloat16) for s in shapes]
    grows = [torch.rand(s, generator=g, device=dev) > 0.98 for s in shapes]
    keeps = [max(int(x.numel() * keep_frac), 1) for x in leaves]
    me.mask_evolve_cuda.launches = me.mask_evolve_cuda.leaves = 0
    got = me.mask_evolve_leaves_cuda(leaves, grows, keeps)
    again = me.mask_evolve_leaves_cuda(leaves, grows, keeps)
    calls = (me.mask_evolve_cuda.launches, me.mask_evolve_cuda.leaves)
    err = 0.0
    for x, grow, keep, (out, mask, thr), (out2, mask2, thr2) in zip(
            leaves, grows, keeps, got, again):
        p_out, p_mask, p_thr = me.mask_evolve_plain(x, grow, keep=keep)
        for what, ok in (
                ("threshold", torch.equal(thr.view(torch.int32),
                                          p_thr.view(torch.int32))),
                ("mask", torch.equal(mask, p_mask)),
                ("output", torch.equal(out.view(torch.int16),
                                       p_out.view(torch.int16))),
                ("repeat", torch.equal(out.view(torch.int16),
                                       out2.view(torch.int16))
                 and torch.equal(mask, mask2) and
                 torch.equal(thr.view(torch.int32), thr2.view(torch.int32)))):
            if not ok:
                raise AssertionError(f"mask_evolve stage, leaf "
                                     f"{tuple(x.shape)}: {what} differs")
        err = max(err, float((out.float() - p_out.float()).abs().max()))
    if calls != (2, 2 * len(leaves)):
        raise AssertionError(f"mask_evolve stage: (calls, leaves) {calls}")
    n = sum(x.numel() for x in leaves)

    def per_leaf():
        for x, grow, keep in zip(leaves, grows, keeps):
            me.mask_evolve_cuda(x, grow, keep=keep)

    def plain():
        for x, grow, keep in zip(leaves, grows, keeps):
            me.mask_evolve_plain(x, grow, keep=keep)

    ms = time_ms(lambda: me.mask_evolve_leaves_cuda(leaves, grows, keeps),
                 iters)
    # the call's device time: its kernels' own time under torch.profiler
    # (back to back, a call's host path can take longer than its kernels)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            me.mask_evolve_leaves_cuda(leaves, grows, keeps)
        torch.cuda.synchronize()
    device_ms = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA) / iters / 1e3
    per_leaf_ms = time_ms(per_leaf, iters)
    plain_ms = time_ms(plain, 2, warmup=1)
    b_ms, b_by = bound(n * (2 * 2 + 2), 2.0 * n)
    return dict(leaves=len(leaves), n=n, dtype="bfloat16",
                keep_frac=keep_frac, max_abs_err=err, ms=ms,
                device_ms=device_ms, one_leaf_calls_ms=per_leaf_ms,
                plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None)


def check_flash(ops, ref, case, dtype, dev, iters, *, plain=True,
                library=False, dv=None):
    """One flash_attention case: the kernel of its dtype's route (bf16,
    f16: wgmma; f32: FFMA) against the plain version (f32: 1e-5·max(1,
    max|out|); bf16, f16: one ulp), times, and the bound. `dv` is v's
    head dim where it is below q/k's (MLA: v zero-padded to hd by
    `ops.flash_attention`); the bound counts the true dims."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.roofline import flash_work

    b, sq, skv, h, kh, hd, causal, window, q_offset = case
    dv = dv or hd
    g = torch.Generator(device=dev).manual_seed(sum(case))
    q = torch.randn((b, sq, h, hd), generator=g, device=dev).to(dtype)
    k = torch.randn((b, skv, kh, hd), generator=g, device=dev).to(dtype)
    v = torch.randn((b, skv, kh, dv), generator=g, device=dev).to(dtype)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    routes = fa.flash_attention_cuda.route_launches
    before = dict(routes)
    got = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    route = [r for r in routes if routes[r] != before[r]]
    if route != [fa.ROUTES[dtype]]:
        raise AssertionError(f"flash_attention {case} {dtype}: launched "
                             f"{route}, expected {fa.ROUTES[dtype]}")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"flash_attention {case}: output not finite")
    row = dict(shape=list(case), dtype=str(dtype).split(".")[-1],
               route=route[0])
    if dv != hd:
        row["dv"] = dv
    if plain:
        want = ops.flash_attention(q, k, v, impl="plain", **kw)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        if dtype == torch.float32:
            scale = max(1.0, float(want.abs().max()))
            ok = err <= 1e-5 * scale
        else:
            ok = ref.within_ulps(got, want)
        if not ok:
            raise AssertionError(f"flash_attention {case} {dtype}: max "
                                 f"error {err} against the plain version")
        row.update(max_abs_err=err, plain_ms=time_ms(
            lambda: ops.flash_attention(q, k, v, impl="plain", **kw),
            max(1, iters // 2), warmup=1))
    else:
        row.update(max_abs_err=None, plain_ms=None,
                   plain_skipped="the plain version walks the "
                   f"{-(-sq // 128)}×{-(-skv // 128)} (q, kv) blocks in "
                   "eager PyTorch; the kernel is held to it at the path "
                   "shape")
    row["ms"] = time_ms(lambda: ops.flash_attention(q, k, v, **kw), iters,
                        warmup=1)
    row["library_ms"] = None
    if library:
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        # MLA (H = K, dv < hd) goes without the GQA flag, which keeps SDPA
        # off the backends that take Ev ≠ E
        gqa = dict(enable_gqa=True) if h != kh or dv == hd else {}
        if window or q_offset:      # SDPA's is_causal has no window
            mask = ref.attention_mask(sq, skv, causal=causal, window=window,
                                      q_offset=q_offset, device=dev)
            row["library_ms"] = time_ms(
                lambda: sdpa(qt, kt, vt, attn_mask=mask, **gqa),
                iters, warmup=1)
        else:
            row["library_ms"] = time_ms(
                lambda: sdpa(qt, kt, vt, is_causal=causal, **gqa),
                iters, warmup=1)
    flops, nbytes = flash_work(b, sq, skv, h, kh, hd, dv, q.element_size(),
                               **kw)
    peak = (chip().peak_flops_fp32 if dtype == torch.float32
            else chip().peak_flops_bf16)
    row["bound_ms"], row["bound_by"] = bound(nbytes, flops, peak)
    row["fp32_ffma_bound_ms"], _ = bound(nbytes, flops)
    row["tflops"] = flops / row["ms"] / 1e9
    inst = fa.padded_head_dim(hd)
    row["kernel_head_dim"] = inst
    if row["route"] == "wgmma":
        # what the tensor cores do: S = Q·Kᵀ once (twice at hd 256, one
        # per warpgroup), P·V twice (hi and lo), at the instance's hd
        qk = 2 if inst > 128 else 1
        row["tflops_tensor_work"] = (qk * 2 + 4) * inst / \
            (2 * (hd + dv)) * row["tflops"]
    return row


def check_wkv(ops, ref, b, s, h, dtype, hi, state, dev, iters,
              plain_iters, *, zero_w=False):
    """One wkv_chunked case: kernel against the plain version (output
    1e-4·max|out| at f32 or one ulp at bf16 and f16; state 1e-5·max|S|),
    times, and the bound at the TF32 tensor peak (the fp32 FFMA bound
    beside it).
    w = exp(−exp(U[−6, hi])); `zero_w` sets w = 0 in a quarter of the
    channels, and the kernel is then held at the same tolerances to the
    per-token recurrence `ref.wkv_ref` instead: there the plain version
    (exps of log-w prefix-sum differences, |cum| up to 64·87.5) is itself
    further from it than these tolerances (its distance is printed)."""
    import torch

    from repro_torch.launch.roofline import wkv_work

    hd = 64
    g = torch.Generator(device=dev).manual_seed(s + h + b)
    r, k, v = (torch.randn((b, s, h, hd), generator=g, device=dev).to(dtype)
               for _ in range(3))
    w = torch.exp(-torch.exp(torch.rand((b, s, h, hd), generator=g,
                                        device=dev) * (hi + 6.0) - 6.0))
    if zero_w:
        w[..., ::4] = 0.0
    u = torch.randn((h, hd), generator=g, device=dev) * 0.3
    s0 = torch.randn((b, h, hd, hd), generator=g, device=dev) if state \
        else None
    out, sf = ops.wkv(r, k, v, w, u, s0)
    p_out, p_sf = ops.wkv(r, k, v, w, u, s0, impl="plain")
    want, want_s = (ref.wkv_ref(r, k, v, w, u, s0) if zero_w
                    else (p_out, p_sf))
    torch.cuda.synchronize()
    err = float((out.float() - want.float()).abs().max())
    s_err = float((sf - want_s).abs().max())
    s_scale = float(want_s.abs().max())
    ok = (err <= 1e-4 * float(want.abs().max())
          if dtype == torch.float32 else ref.within_ulps(out, want))
    if not ok or not s_err <= 1e-5 * s_scale:
        raise AssertionError(f"wkv_chunked B={b} S={s} H={h} {dtype} "
                             f"zero_w={zero_w}: output error {err}, state "
                             f"error {s_err} (state scale {s_scale})")
    extra = {}
    if zero_w:
        extra = dict(
            held_to="ref.wkv_ref",
            plain_vs_oracle_rel_err=float(
                (p_out.float() - want.float()).abs().max()
                / want.float().abs().max()),
            plain_vs_oracle_state_rel_err=float(
                (p_sf - want_s).abs().max()) / s_scale)
    ms = time_ms(lambda: ops.wkv(r, k, v, w, u, s0), iters, warmup=1)
    plain_ms = time_ms(lambda: ops.wkv(r, k, v, w, u, s0, impl="plain"),
                       plain_iters, warmup=1)
    flops, nbytes = wkv_work(b, s, h, hd, r.element_size(), state=state)
    b_ms, b_by = bound(nbytes, flops, chip().peak_flops_tf32)
    ffma_ms, _ = bound(nbytes, flops)
    return dict(b=b, s=s, h=h, hd=hd, dtype=str(dtype).split(".")[-1],
                w_min=float(w.min()), state=state, zero_w=zero_w,
                max_abs_err=err, state_err=s_err, state_scale=s_scale,
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                fp32_ffma_bound_ms=ffma_ms, library_ms=None, **extra)


# ---------------------------------------------------------------------------
# phase 3: the port's main path
# ---------------------------------------------------------------------------

# the kernel each path must launch, and how often per round at least
PATH_KERNELS = {"pfeddst": "select_topk", "pfeddst_random": "raw_gram",
                "dfedpgp": "gossip_mix", "dispfl": "mask_evolve"}


def check_edges(name, met, k, n_active):
    """The round's plan: k picks per active row (pfeddst, dfedpgp), at
    least k for the undirected plans, none for inactive rows, no self;
    the star plans carry the sampled clients only."""
    active = met["active"]
    if int(active.sum()) != n_active:
        raise AssertionError(f"{name}: {int(active.sum())} active clients, "
                             f"expected {n_active}")
    if name in ("fedavg", "fedper", "fedbabu"):
        if "comm_edges" in met:
            raise AssertionError(f"{name}: a star round reported edges")
        return 0
    mask = met["select_mask" if name.startswith("pfeddst") else "comm_edges"]
    per_row = mask.sum(dim=1)
    exact = name in ("pfeddst", "pfeddst_random", "dfedpgp")
    ok = bool((per_row[active] == k).all() if exact
              else (per_row[active] >= k).all())
    if not ok or bool((per_row[~active] != 0).any()) or \
            bool(mask.diagonal().any()):
        raise AssertionError(f"{name}: edges per row {per_row.tolist()} "
                             f"(active {active.tolist()}, k={k})")
    return int(mask.sum())


def run_path(name, cfg, fl, data, rounds, dev, run_experiment, ops,
             n_leaves):
    """One strategy's run; the launch counters are set to 0 just before
    it and read after each of its rounds. Each kernel of the path must
    launch in every round; mask_evolve exactly once a dispfl round, over
    all `n_leaves` leaves. Under the default fabric every round must
    report bytes."""
    k = min(fl.peers_per_round, fl.num_clients - 1)
    n_active = max(1, int(round(fl.num_clients * fl.client_sample_ratio)))
    edges, counts = [], []
    evolve = ops.KERNELS["mask_evolve"]

    def on_round(r, met):
        counts.append({**ops.launch_counts(), "leaves": evolve.leaves})
        edges.append(check_edges(name, met, k, n_active))

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    hist = run_experiment(name, cfg, fl, data, num_rounds=rounds,
                          eval_every=1, steps_per_epoch=2, seed=0,
                          verbose=False, device=dev, on_round=on_round)
    total = time.perf_counter() - t0
    launches = ops.launch_counts()
    kernel = PATH_KERNELS.get(name)
    if kernel is not None:
        per_round = [b[kernel] - a[kernel]
                     for a, b in zip([{kernel: 0}] + counts, counts)]
        if min(per_round) < 1:
            raise AssertionError(f"{name}: {kernel} launches per round "
                                 f"{per_round}, expected at least 1")
    if kernel == "mask_evolve":
        leaves = [b["leaves"] - a["leaves"]
                  for a, b in zip([{"leaves": 0}] + counts, counts)]
        if set(per_round) != {1} or set(leaves) != {n_leaves}:
            raise AssertionError(
                f"{name}: mask_evolve calls per round {per_round} covering "
                f"{leaves} leaves, expected 1 call over {n_leaves}")
        launches["mask_evolve_leaves"] = evolve.leaves
    h = hist.to_dict()
    # round 0's wall is compile_s; wall_s is the cumulative steady wall
    # after each round (eval_every=1), 0 after round 0
    steady = h["wall_s"]
    walls = [h["compile_s"]] + [b - a for a, b in zip(steady, steady[1:])]
    loss_keys = (("train_loss_e", "train_loss_h", "s_l_mean",
                  "mean_selected_score") if name.startswith("pfeddst")
                 else ("train_loss",))
    for key in loss_keys:
        vals = h["extra"][key]
        if len(vals) != rounds or not all(math.isfinite(v) for v in vals):
            raise AssertionError(f"{name}: {key} not finite: {vals}")
    if not all(math.isfinite(a) for a in h["accuracy"]):
        raise AssertionError(f"{name}: accuracy not finite")
    if fl.comms is not None and min(h["round_bytes"]) <= 0:
        raise AssertionError(f"{name}: round_bytes {h['round_bytes']}")
    return dict(name=name, round_walls_s=walls, total_s=total,
                accuracy=h["accuracy"], edges=edges, launches=launches,
                round_bytes=h["round_bytes"],
                **{key: h["extra"][key] for key in loss_keys[:1]})


# arch → (the kernel its prefill launches, requests, prompt length)
SERVE_RUNS = {"qwen2-1.5b": ("flash_attention", 3, 4096),
              "rwkv6-7b": ("wkv_chunked", 3, 4096),
              "recurrentgemma-2b": ("flash_attention", 3, 4096),
              "qwen2.5-3b": ("flash_attention", 2, 4096),
              "qwen2.5-14b": ("flash_attention", 2, 4096),
              "starcoder2-7b": ("flash_attention", 2, 4096),
              # whisper's 448-token decoder context: 416 prompt + 32 new
              "whisper-base": ("flash_attention", 3, 416),
              # full width at the depths that fit the card (SERVE_DEPTHS)
              "phi3.5-moe-42b-a6.6b": ("flash_attention", 2, 4096),
              "deepseek-v3-671b": ("flash_attention", 2, 4096),
              "internvl2-76b": ("flash_attention", 2, 4096)}
# arch → the layers served where the full depth does not fit one 80 GB
# card (bf16 weights 42.1, 49.7 and 31.7 GB at these depths); every layer
# of these uniform stacks has one shape, so the cut changes only L
SERVE_DEPTHS = {"phi3.5-moe-42b-a6.6b": 16, "deepseek-v3-671b": 2,
                "internvl2-76b": 16}
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN, SERVE_REQUESTS = 4, 4096, 32, 3
# the reduced configs phase 4 serves on the card and on the CPU
AGREE_ARCHS = ("qwen2-1.5b", "rwkv6-7b", "recurrentgemma-2b", "whisper-base",
               "phi3.5-moe-42b-a6.6b", "deepseek-v3-671b", "internvl2-76b")
MOE_ARCHS = ("phi3.5-moe-42b-a6.6b", "deepseek-v3-671b")


def serve_config(arch):
    """`arch`'s config at full width, its depth cut to SERVE_DEPTHS."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    if arch in SERVE_DEPTHS:
        cfg = dataclasses.replace(cfg, num_layers=SERVE_DEPTHS[arch])
    return cfg


def prefill_launches(cfg) -> int:
    """Launches of its prefill kernel per request: one per attention layer
    (flash_attention: the dense layers, the hybrid's local-attention
    layers, whisper's encoder, decoder self- and cross-attention layers)
    or per layer (wkv_chunked)."""
    if cfg.family == "hybrid":
        return cfg.block_pattern.count("attn")
    if cfg.family == "audio":
        return cfg.encoder_layers + 2 * cfg.num_layers
    return cfg.num_layers


def profile_prefill(cfg, params, prompts, dev):
    """One steady prefill of `prompts` under torch.profiler: wall, device
    kernel time, the device's idle share, wkv_chunked's share of the
    device time and the top kernels (the table goes to chiprun_out/)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.serve import make_serving_fns

    prefill_fn, _ = make_serving_fns(cfg, prompt_len=SERVE_PROMPT,
                                     gen_tokens=SERVE_GEN)
    prefill_fn(params, prompts)                  # warm, as the steady ones
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prefill_fn(params, prompts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in events)
    wkv_us = sum(e.self_device_time_total for e in events
                 if any(k in e.key for k in WKV_KERNELS))
    top = sorted(events, key=lambda e: e.self_device_time_total,
                 reverse=True)[:12]
    lines = [f"{e.self_device_time_total / 1e3:10.3f} ms {e.count:6d}x  "
             f"{e.key[:100]}" for e in top]
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke_rwkv_prefill_profile.txt").write_text(
        f"{card_line()}\n{cfg.name} prefill B={SERVE_BATCH} "
        f"S={SERVE_PROMPT}: wall {wall:.4f} s, device {dev_us / 1e6:.4f} s"
        f"\n" + "\n".join(lines) + "\n")
    return dict(wall_s=wall, device_s=dev_us / 1e6,
                idle_share=1.0 - dev_us / 1e6 / wall,
                wkv_device_s=wkv_us / 1e6, wkv_share=wkv_us / dev_us,
                top=[(e.key[:60], e.self_device_time_total / 1e3, e.count)
                     for e in top[:6]])


def run_serve(arch, dev, ops):
    """`serve_requests` at the full width of `arch` (and its full depth,
    or SERVE_DEPTHS's) in bf16 with random weights (SERVE_RUNS: requests,
    prompt length; whisper from the driver's zero frames); the launch
    counters are set to 0 just before it and read just after: the arch's
    prefill kernel `prefill_launches` times per request, the other
    serving kernel never. For rwkv6-7b one more prefill of the last
    prompts is profiled. The weights are freed before returning."""
    import torch

    from repro_torch.convert import flatten_tree
    from repro_torch.launch.serve import serve_requests
    from repro_torch.models import model as model_mod

    cfg = serve_config(arch)
    kernel, requests, prompt_len = SERVE_RUNS[arch]
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = model_mod.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    n_params = sum(t.numel() for t in flatten_tree(params).values())

    def prompts_fn(i):
        g = torch.Generator(device=dev).manual_seed(100 + i)
        return torch.randint(0, cfg.vocab_size, (SERVE_BATCH, prompt_len),
                             generator=g, device=dev, dtype=torch.int32)

    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out, stats = serve_requests(cfg, params, prompts_fn,
                                num_requests=requests,
                                prompt_len=prompt_len,
                                gen_tokens=SERVE_GEN)
    total = time.perf_counter() - t0
    launches = ops.launch_counts()
    flash_routes = dict(ops.KERNELS["flash_attention"].route_launches)
    per_request = prefill_launches(cfg)
    want = {name: (per_request * requests if name == kernel else 0)
            for name in ("flash_attention", "wkv_chunked")}
    got = {name: launches[name] for name in want}
    if got != want:
        raise AssertionError(f"{arch}: serving launches {got}, expected "
                             f"{want}")
    if flash_routes["ffma"]:      # bf16 serving takes the wgmma kernel
        raise AssertionError(f"{arch}: flash routes {flash_routes}")
    if not all(stats["logits_finite"]):
        raise AssertionError(f"{arch}: logits not finite "
                             f"{stats['logits_finite']}")
    new = out[:, prompt_len:]
    if out.shape != (SERVE_BATCH, prompt_len + SERVE_GEN) or \
            int(new.min()) < 0 or int(new.max()) >= cfg.vocab_size:
        raise AssertionError(f"{arch}: tokens {tuple(out.shape)} in "
                             f"[{int(new.min())}, {int(new.max())}]")
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    prof = (profile_prefill(cfg, params, prompts_fn(requests - 1), dev)
            if kernel == "wkv_chunked" else None)
    del params, out, new
    torch.cuda.empty_cache()
    st = stats["stages"]
    pre, dec = st["prefill"], st["decode"]
    print(f"serve {arch}: {n_params / 1e9:.3f} B parameters, prefill "
          f"steady {pre['steady_s']:.4f} s, decode step "
          f"{dec['steady_s'] / SERVE_GEN * 1e3:.2f} ms, {kernel} "
          f"{launches[kernel]} launches, peak {peak_gb:.2f} GB (init "
          f"{init_peak_gb:.2f} GB)", flush=True)
    return dict(
        arch=arch, layers=cfg.num_layers, params=n_params, init_s=init_s,
        total_s=total,
        requests=requests, prompt_len=prompt_len, kernel=kernel,
        launches_per_request=per_request,
        launches=launches, flash_routes=flash_routes,
        requests_s=stats["requests"],
        prefill_first_s=pre["first_s"], prefill_steady_s=pre["steady_s"],
        decode_first_s=dec["first_s"], decode_steady_s=dec["steady_s"],
        prefill_tok_per_s=SERVE_BATCH * prompt_len / pre["steady_s"],
        decode_tok_per_s=SERVE_BATCH * SERVE_GEN / dec["steady_s"],
        decode_step_ms=dec["steady_s"] / SERVE_GEN * 1e3,
        peak_mem_gb=peak_gb, init_peak_mem_gb=init_peak_gb,
        prefill_profile=prof)


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


def check_baseline_agreement(dev):
    """dfedpgp and dispfl rounds on the card and on the CPU from the same
    state and draws (dispfl's regrow planes drawn on the CPU and injected
    into both). dispfl runs each round in two parts, the second from the
    mask evolution on, to read the parameters the masks evolve from."""
    import torch

    from repro_torch.configs import FLConfig, get_config
    from repro_torch.data.synthetic import client_datasets_cifar
    from repro_torch.fl.engine import run_round
    from repro_torch.fl.strategies import make_strategy
    from repro_torch.kernels.mask_evolve import magnitude_threshold_plain
    from repro_torch.utils.pytree import tree_map

    cfg = dataclasses.replace(get_config("resnet18-cifar").reduced(),
                              dtype="float32", image_size=8, cnn_width=32)
    data = client_datasets_cifar(1, 6, samples_per_class=20, image_size=8)
    train = {"images": data["train_x"], "labels": data["train_y"]}
    gpu_train = {k: v.to(dev) for k, v in train.items()}
    fl = FLConfig(num_clients=6, peers_per_round=2, batch_size=8,
                  client_sample_ratio=0.5, epochs_extractor=1,
                  epochs_header=1)

    def to_card(state):
        return tree_map(lambda t: t.to(dev) if t.dim() else t, state)

    def run(strat, stages, state, train, r, draws):
        return run_round(stages, state, train, (7, r), m=6, ratio=0.5,
                         key_streams=strat.key_streams, draws=draws)

    out = {}
    for name in ("dfedpgp", "dispfl"):
        strat = make_strategy(name, cfg, fl, 1, device="cpu")
        split = len(strat.stages) - 2 if name == "dispfl" else \
            len(strat.stages)
        cpu_state = strat.init(3)
        gpu_state = to_card(cpu_state)
        worst, flips = 0.0, 0
        for r in range(2):
            draws = {}
            if name == "dispfl":
                g = torch.Generator().manual_seed(100 + r)
                draws["grow"] = {
                    n: torch.rand(p.shape, generator=g)
                    > 1.0 - fl.dispfl_regrow
                    for n, p in cpu_state["params"].items()}
            cpu_mid, cm = run(strat, strat.stages[:split], cpu_state, train,
                              r, draws)
            gpu_mid, gm_ = run(strat, strat.stages[:split], gpu_state,
                               gpu_train, r, draws)
            cpu_state, _ = run(strat, strat.stages[split:], cpu_mid, train,
                               r, draws)
            gpu_state, _ = run(strat, strat.stages[split:], gpu_mid,
                               gpu_train, r, draws)
            if not torch.equal(cm["comm_edges"], gm_["comm_edges"].cpu()):
                raise AssertionError(f"{name} round {r}: edges differ "
                                     "between card and CPU")
            round_flips = 0
            for n, want in cpu_state["params"].items():
                got = gpu_state["params"][n].cpu()
                keep = torch.ones_like(want, dtype=torch.bool)
                if name == "dispfl":
                    flip = gpu_state["mask"][n].cpu() != cpu_state["mask"][n]
                    if flip.any():
                        x = cpu_mid["params"][n]
                        n_keep = max(int(x.numel() * 0.5), 1)
                        thr = float(magnitude_threshold_plain(
                            x, x.numel() - n_keep))
                        near = (x[flip].abs() - thr).abs() <= 2e-3 * thr
                        if not bool(near.all()):
                            raise AssertionError(
                                f"dispfl round {r} {n}: masks differ away "
                                f"from the threshold {thr}")
                        round_flips += int(flip.sum())
                        keep = ~flip
                scale = float(want.abs().max())
                torch.testing.assert_close(got[keep], want[keep], rtol=1e-3,
                                           atol=max(1e-5, 1e-3 * scale))
                worst = max(worst, float((got[keep] - want[keep]).abs().max())
                            / max(scale, 1e-30))
            flips += round_flips
            if round_flips:
                gpu_state = to_card(cpu_state)   # start round 2 level
        out[name] = dict(max_rel_param_diff=worst, mask_flips=flips)
    return out


def check_serve_agreement(dev):
    """The reduced qwen2-1.5b, rwkv6-7b, recurrentgemma-2b (window 16, so
    the 80-token prompt wraps its ring), whisper-base (random frames for
    the prefill, the driver's zero frames for generation), phi3.5-moe (in
    both dispatch modes), deepseek-v3 (MLA) and internvl2-76b in f32 from
    the same weights and prompts on the card (kernels) and the CPU (plain
    versions): greedy tokens equal; prefill logits and the KV / MLA latent
    cache / rwkv state / LRU states and rings / cross k/v within 1e-4 of
    their scale; for the MoE configs every routing choice of the prefill
    (gate_idx, keep, read by `moe.recording_routes`) equal on both
    devices."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.convert import flatten_tree
    from repro_torch.launch.serve import generate
    from repro_torch.models import model as model_mod
    from repro_torch.models import moe as moe_mod
    from repro_torch.utils.pytree import tree_map

    out = {}
    runs = [(arch, None) for arch in AGREE_ARCHS] + [
        ("phi3.5-moe-42b-a6.6b", "einsum")]
    for arch, dispatch in runs:
        cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
        if dispatch:
            cfg = dataclasses.replace(cfg, moe_dispatch=dispatch)
        params = model_mod.init_params(cfg, torch.Generator().manual_seed(7),
                                       "cpu")
        card = tree_map(lambda t: t.to(dev), params)
        gen = torch.Generator().manual_seed(8)
        toks = torch.randint(0, cfg.vocab_size, (2, 80), dtype=torch.int32,
                             generator=gen)
        batch = {"tokens": toks}
        if cfg.family == "audio":
            batch["frames"] = torch.randn(
                (2, cfg.encoder_seq, cfg.d_model), generator=gen)
        res = {}
        with moe_mod.recording_routes() as rc:
            lc, cc = model_mod.prefill(cfg, params, batch, max_seq=88)
        with moe_mod.recording_routes() as rg:
            lg, cg = model_mod.prefill(cfg, card, tree_map(
                lambda t: t.to(dev), batch), max_seq=88)
        pairs = [("logits", lg.cpu(), lc)] + [
            (name, t.cpu(), flatten_tree(cc)[name])
            for name, t in flatten_tree(cg).items()]
        for name, got, want in pairs:
            scale = max(1.0, float(want.abs().max()))
            err = float((got - want).abs().max())
            if not err <= 1e-4 * scale:
                raise AssertionError(f"{arch} prefill {name}: card and CPU "
                                     f"differ by {err} (scale {scale})")
            res[name] = err
        tc = generate(cfg, params, toks, gen_tokens=8)
        tg = generate(cfg, card, toks.to(dev), gen_tokens=8)
        if not torch.equal(tc, tg.cpu()):
            raise AssertionError(f"{arch}: greedy tokens differ between card "
                                 f"and CPU: {tg[:, 80:].tolist()} vs "
                                 f"{tc[:, 80:].tolist()}")
        name = f"{arch} {dispatch}" if dispatch else arch
        out[name] = {"logits": res["logits"], "max_err": max(res.values()),
                     "leaves": len(res)}
        if cfg.num_experts:
            assert len(rc) == len(rg) == cfg.num_layers
            share = {what: sum(float((a[i] == b[i].cpu()).float().mean())
                               for a, b in zip(rc, rg)) / len(rc)
                     for i, what in enumerate(("gate_idx", "keep"))}
            out[name]["routing_equal_share"] = share
            if share != {"gate_idx": 1.0, "keep": 1.0}:
                raise AssertionError(f"{name}: the prefill's routing differs "
                                     f"between card and CPU: {share}")
    return out


# ---------------------------------------------------------------------------
# phase 6: the comms fabric
# ---------------------------------------------------------------------------

# the dense fabric's network: a ring with hetero links and every event
FABRIC_NET = dict(topology="ring", link_model="hetero", p_link_drop=0.1,
                  availability=0.9, p_stale=0.1)
# the kernel each strategy must launch in every round on the ring (the
# undirected plans pack at D = degree + 1 = 3 there)
FABRIC_KERNELS = {"pfeddst": "select_topk", "pfeddst_random": "raw_gram",
                  "dfedpgp": "gossip_mix", "dfedavgm": "gossip_mix",
                  "dispfl": "gossip_mix"}
MODEL_F = 11_172_170       # ResNet-18: extractor + the 512×10 head and bias


def message_bytes(cfg, name, fl, dev) -> int:
    """One message of `name`, from one client's freshly drawn parameters
    (independent of the simulator's own accounting): the model for fedavg
    and dfedavgm, the extractor otherwise, dispfl's (1 − sparsity) of it."""
    import torch

    from repro_torch.models import model as model_mod
    from repro_torch.models.split import split_params
    from repro_torch.utils.pytree import tree_bytes

    params = model_mod.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    tree = params if name in ("fedavg", "dfedavgm") else \
        split_params(cfg, params)[0]
    fraction = 1 - fl.dispfl_sparsity if name == "dispfl" else 1.0
    return int(round(tree_bytes(tree) * fraction))


def run_fabric_path(name, cfg, fl, data, rounds, dev, run_experiment, ops):
    """One strategy's run on a fabric; the launch counters are set to 0 just
    before it and read after each round. Each round: the active clients
    are online and the edges lie inside the round's candidate mask (both
    drawn again on the host from the round's network streams); round_bytes
    and the network time equal the host transport's price of the round's
    edges (or the star's uploads and downloads) at `message_bytes`, and
    the bytes are messages × that payload; the path's kernel launched.
    pfeddst's select_topk calls must all take the candidate mask and the
    (M, M) cost matrix."""
    import torch

    from repro_torch.comms import make_fabric
    from repro_torch.fl.engine import net_streams

    host = make_fabric(fl.comms, fl.num_clients, cost_scale=fl.comm_cost,
                       device="cpu")
    packed = hasattr(host, "round_slots")
    star = name in ("fedavg", "fedper", "fedbabu")
    payload = message_bytes(cfg, name, fl, dev)
    want, counts, calls, masks = [], [], [], []
    original = ops.select_topk

    def spy(x, last, s_l, t, cost, cand=None, **kw):
        calls.append([x.is_cuda, isinstance(cost, torch.Tensor)
                      and cost.dim() == 2, cand is not None])
        return original(x, last, s_l, t, cost, cand, **kw)

    def on_round(r, met):
        counts.append(ops.launch_counts())
        first, avail, _ = (host.round_slots(net_streams((0, r))) if packed
                           else host.round_masks(net_streams((0, r))))
        cand = host.cand_dense(first) if packed else first
        active = met["active"].cpu()
        if bool((active & ~avail).any()):
            raise AssertionError(f"{name} round {r}: an offline client "
                                 "trained")
        if star:
            msgs = 2 * int(active.sum())
            stats = host.account_round("star", {"active": active}, payload)
        else:
            edges = met["select_mask" if name.startswith("pfeddst")
                        else "comm_edges"].cpu()
            masks.append(edges)
            if bool((edges & ~cand).any()):
                raise AssertionError(f"{name} round {r}: edges outside the "
                                     "round's candidate mask")
            msgs = int(edges.sum())
            stats = host.account_round("p2p", {"comm_edges": edges}, payload)
        if stats.total_bytes != msgs * payload:
            raise AssertionError(f"{name} round {r}: {stats.total_bytes} "
                                 f"bytes for {msgs} messages of {payload}")
        want.append((stats.total_bytes, stats.sim_time_s))

    ops.select_topk = spy
    ops.reset_launch_counts()
    try:
        hist = run_experiment(name, cfg, fl, data, num_rounds=rounds,
                              eval_every=rounds, steps_per_epoch=2, seed=0,
                              verbose=False, device=dev, on_round=on_round)
    finally:
        ops.select_topk = original
    h = hist.to_dict()
    got = list(zip(h["round_bytes"], h["round_net_time_s"]))
    if got != want:
        raise AssertionError(f"{name}: History (bytes, net s) {got}, the "
                             f"host transport {want}")
    kernel = FABRIC_KERNELS.get(name)
    per_round = {}
    for k in ops.KERNELS:
        per_round[k] = [b[k] - a[k] for a, b in
                        zip([dict.fromkeys(ops.KERNELS, 0)] + counts, counts)]
    if kernel is not None and min(per_round[kernel]) < 1:
        raise AssertionError(f"{name}: {kernel} launches per round "
                             f"{per_round[kernel]}")
    if name == "pfeddst" and (len(calls) != rounds or
                              not all(all(c) for c in calls)):
        raise AssertionError(f"pfeddst: select_topk calls (on the card, "
                             f"matrix cost, candidates) {calls}")
    if not all(math.isfinite(a) for a in h["accuracy"]):
        raise AssertionError(f"{name}: accuracy not finite")
    steady = h["wall_s"]
    return dict(name=name, payload_bytes=payload, round_bytes=h["round_bytes"],
                round_net_time_s=h["round_net_time_s"],
                round_stale_lag=h["round_stale_lag"],
                energy_j=h["energy_j"], compile_s=h["compile_s"],
                steady_s=steady[-1], launches=ops.launch_counts(),
                select_calls=calls, masks=masks)


def check_ring_mix(ops, ref, edges, k, dev, f=MODEL_F):
    """dfedavgm's plan of a ring round packed at the topology bound (D =
    3) and mixed by the kernel, against the dense mix of the same plan
    (phase 4's f32 tolerance: rtol 1e-3, atol 1e-3 × scale) and bitwise
    against the plain version, at the model's width; timed (`check_gossip`)."""
    import torch

    from repro_torch.core.aggregation import selection_to_weights
    from repro_torch.kernels.gossip_mix import (gossip_degree_bound,
                                                weights_to_neighbors)

    m = edges.shape[0]
    w = selection_to_weights(edges.to(dev), include_self=True)
    idx, wl = weights_to_neighbors(w, gossip_degree_bound(
        k, m, directed=False, topo_degree=2))
    x = torch.randn((m, f), generator=torch.Generator(
        device=dev).manual_seed(31), device=dev)
    packed = ops.gossip_mix(x, idx, wl)
    dense = w @ x
    scale = float(dense.abs().max())
    torch.testing.assert_close(packed, dense, rtol=1e-3, atol=1e-3 * scale)
    row = check_gossip(ops, ref, (x, idx, wl), 20, 3)
    row["max_abs_diff_dense"] = float((packed - dense).abs().max())
    return row


def pfeddst_masks(cfg, fl, data, dev, run_experiment, ops, rounds):
    """pfeddst's selection mask of every round, and the run's launch
    counts (set to 0 just before it), with cuDNN held deterministic so
    that two runs meant to select alike can be compared round by round."""
    import torch

    got = []
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    try:
        ops.reset_launch_counts()
        run_experiment("pfeddst", cfg, fl, data, num_rounds=rounds,
                       eval_every=rounds, steps_per_epoch=2, seed=0,
                       verbose=False, device=dev,
                       on_round=lambda r, met: got.append(
                           met["select_mask"].cpu()))
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark \
            = flags
    return got, ops.launch_counts()


def compare_masks(what, a, b):
    for r, (x, y) in enumerate(zip(a, b, strict=True)):
        if not x.equal(y):
            raise AssertionError(
                f"{what} round {r}: masks differ in rows "
                f"{(x != y).any(1).nonzero().flatten().tolist()}")


def check_packed_vs_dense(cfg, fl, data, dev, run_experiment, ops, rounds):
    """pfeddst on hier_ring (clusters of 4, availability and staleness
    events, no link drops) through the packed SparseFabric and through
    the dense fabric: the same selection masks every round. k = 2 of at
    most 4 neighbours, so rows rank their candidates (at k = 4 every row
    would take all of them). cuDNN is held deterministic for both runs."""
    from repro_torch.configs import CommsConfig

    net = dict(topology="hier_ring", hier_cluster=4, link_model="hetero",
               availability=0.9, p_stale=0.1)
    masks, launches = {}, {}
    for sparse in (False, True):
        flp = dataclasses.replace(fl, peers_per_round=2,
                                  comms=CommsConfig(sparse=sparse, **net))
        kind = "packed" if sparse else "dense"
        masks[sparse], launches[kind] = pfeddst_masks(
            cfg, flp, data, dev, run_experiment, ops, rounds)
    compare_masks("packed vs dense fabric", masks[False], masks[True])
    if launches["dense"]["select_topk"] != rounds or \
            launches["packed"]["select_topk"] != 0:
        raise AssertionError(f"select_topk launches {launches}")
    return dict(rounds=rounds, edges=[int(m.sum()) for m in masks[True]],
                launches=launches)


def check_packed_scale(ops, ref, dev, m=65536, p=5130):
    """The packed fabric at its own scale: M = 65536 on hier_ring (clusters
    of 16, hetero links, 10% link drops, 90% availability), ResNet-18's
    header width P = 5130 in f32 (1.34 GB). One round_slots, one
    score_topk_sparse (k = 4) and one gossip_mix over the headers with
    D = k + 1 = 5 (self first), each timed after; the peak memory of
    the three. The launch counters are set to 0 just before round_slots
    and read after the mix (`launches`). Checks: every selected peer is a
    live CSR edge of its row; the mix equals gossip_mix's plain version
    bitwise on 4096 rows."""
    import numpy as np
    import torch

    from repro_torch.comms import make_fabric
    from repro_torch.configs import CommsConfig
    from repro_torch.core.scoring import score_topk_sparse
    from repro_torch.core.selection import NEG
    from repro_torch.fl.engine import net_streams
    from repro_torch.kernels.gossip_mix import gossip_mix_plain

    k = 4
    t0 = time.perf_counter()
    fab = make_fabric(CommsConfig(topology="hier_ring", hier_cluster=16,
                                  link_model="hetero", p_link_drop=0.1,
                                  availability=0.9, sparse=True), m,
                      device=dev)
    build_s = time.perf_counter() - t0
    d = fab.nbr_idx.shape[1]
    g = torch.Generator(device=dev).manual_seed(21)
    x = torch.randn((m, p), generator=g, device=dev)
    last = torch.randint(-1, 8, (m, d), generator=g, device=dev,
                         dtype=torch.int32)
    s_l = torch.rand((m, d), generator=g, device=dev) * 3.0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)

    def slots():
        return fab.round_slots(net_streams((0, 0)))

    def score(slot_mask):
        return score_topk_sparse(x, last, s_l, 7, nbr_idx=fab.nbr_idx,
                                 nbr_valid=slot_mask, alpha=1.0, lam=0.5,
                                 comm_cost=fab.slot_cost, k=k)

    walls = {}
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    slot_mask, _, _ = slots()
    torch.cuda.synchronize()
    walls["round_slots"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    vals, idx, _ = score(slot_mask)
    torch.cuda.synchronize()
    walls["score_topk_sparse"] = time.perf_counter() - t0
    sel = vals > NEG / 2
    rows = torch.arange(m, device=dev, dtype=torch.int32)[:, None]
    inv = 1.0 / (sel.sum(1, keepdim=True) + 1.0)
    idx_mix = torch.cat([rows, idx], 1)
    w_mix = torch.cat([inv, torch.where(sel, inv, 0.0)], 1)
    t0 = time.perf_counter()
    mixed = ops.gossip_mix(x, idx_mix, w_mix)
    torch.cuda.synchronize()
    walls["gossip_mix"] = time.perf_counter() - t0
    launches = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    if launches["gossip_mix"] != 1:
        raise AssertionError(f"packed scale: launches {launches}")
    # every selected peer is a live edge slot of its row
    sel_np, idx_np = sel.cpu().numpy(), idx.long().cpu().numpy()
    r_sel = np.repeat(np.arange(m), k).reshape(m, k)[sel_np]
    c_sel = idx_np[sel_np]
    keys = r_sel * m + c_sel
    all_keys = fab.topo.edge_rows().astype(np.int64) * m + fab.topo.indices
    pos = np.searchsorted(all_keys, keys)
    pos_c = np.clip(pos, 0, len(all_keys) - 1)
    if not (all_keys[pos_c] == keys).all():
        raise AssertionError("packed scale: a selected peer is no CSR edge")
    slot = pos_c - fab.topo.indptr[r_sel]
    if not slot_mask.cpu().numpy()[r_sel, slot].all():
        raise AssertionError("packed scale: a selected edge is not live")
    n_live = int(slot_mask.sum())
    if int(sel.sum()) != int(np.minimum(
            slot_mask.sum(1).cpu().numpy(), k).sum()):
        raise AssertionError("packed scale: a row selected fewer than "
                             "min(k, live neighbours) peers")
    sub = torch.randperm(m, generator=torch.Generator().manual_seed(5))[
        :min(m, 4096)].to(dev)
    want = gossip_mix_plain(x, idx_mix[sub], w_mix[sub])
    err = float((mixed[sub] - want).abs().max())
    if not torch.equal(mixed[sub].view(torch.int32), want.view(torch.int32)):
        raise AssertionError("packed scale: gossip_mix differs from the "
                             "plain version")
    # times (CUDA events), the mix beside its plain version, its bound and
    # one library call (a CSR sparse × dense product)
    ms = time_ms(lambda: ops.gossip_mix(x, idx_mix, w_mix), 10)
    plain_ms = time_ms(lambda: gossip_mix_plain(x, idx_mix, w_mix), 1, 1)
    live = w_mix != 0
    coo = torch.sparse_coo_tensor(
        torch.stack([rows.expand_as(idx_mix)[live].long(),
                     idx_mix[live].long()]), w_mix[live], (m, m))
    w_csr = coo.coalesce().to_sparse_csr()
    library_ms = time_ms(lambda: torch.sparse.mm(w_csr, x), 10)
    lib = torch.sparse.mm(w_csr, x)
    lib_err = float((lib - mixed).abs().max())
    n_rows = int(torch.unique(idx_mix[live]).numel())
    b_ms, b_by = bound(n_rows * p * 4 + idx_mix.numel() * 8 + m * p * 4,
                       2.0 * int(live.sum()) * p)
    return dict(m=m, p=p, d_topology=d, d_mix=idx_mix.shape[1], k=k,
                fabric_build_s=build_s, edges=fab.topo.num_edges,
                live_slots=n_live, selected=int(sel.sum()),
                walls_s=walls, launches=launches,
                round_slots_ms=time_ms(slots, 5),
                score_topk_sparse_ms=time_ms(lambda: score(slot_mask), 3),
                peak_mem_gb=peak_gb,
                peak_above_inputs_gb=peak_gb - base / 1e9,
                gossip_mix=dict(m=m, f=p, d=idx_mix.shape[1],
                                nonzero=int(live.sum()), max_abs_err=err,
                                ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                bound_by=b_by, library_ms=library_ms,
                                library_max_abs_diff=lib_err))


def fabric_phase(cfg, fl, data, dev, run_experiment, ops, ref) -> dict:
    """Phase 6 (module docstring); prints its rows and returns each run's
    launch counts by run name."""
    from repro_torch.configs import CommsConfig

    fl_ring = dataclasses.replace(fl, comms=CommsConfig(**FABRIC_NET))
    runs = [run_fabric_path(name, cfg, fl_ring if name.startswith("pfeddst")
                            else dataclasses.replace(fl_ring,
                                                     lr=BASELINE_LR),
                            data, 3, dev, run_experiment, ops)
            for name in ("pfeddst", "pfeddst_random", "dfedpgp", "dfedavgm",
                         "dispfl", "fedavg")]
    launches = {r["name"] + "[ring]": r["launches"] for r in runs}
    for run in runs:
        print("fabric", json.dumps({k: v for k, v in run.items()
                                    if k != "masks"}), flush=True)
    ring_edges = next(r["masks"] for r in runs if r["name"] == "dfedavgm")[-1]
    ring_mix = check_ring_mix(ops, ref, ring_edges, fl.peers_per_round, dev)
    print("fabric ring mix (dfedavgm's plan at D = 3, model width; packed "
          "kernel against the dense mix and the plain version)",
          json.dumps(ring_mix), flush=True)
    packed = check_packed_vs_dense(cfg, fl, data, dev, run_experiment, ops,
                                   3)
    launches.update({f"pfeddst[hier_ring, {kind}]": counts
                     for kind, counts in packed["launches"].items()})
    print("fabric packed vs dense (hier_ring, pfeddst): masks equal",
          json.dumps(packed), flush=True)
    scale = check_packed_scale(ops, ref, dev)
    launches["packed_65536"] = scale["launches"]
    print("fabric packed scale", json.dumps(scale), flush=True)
    return launches


# ---------------------------------------------------------------------------
# phase 7: semi-async rounds and the round trace
# ---------------------------------------------------------------------------

ASYNC_PROFILE = dict(family="bimodal", straggler_fraction=0.25,
                     straggler_slowdown=4.0)
ASYNC_DEADLINE_S = 2.0


def _tree_diff(a: dict, b: dict) -> float:
    """Largest |a − b| over the leaves of two same-shaped dicts (f32)."""
    return max(float((a[n].float() - b[n].float()).abs().max()) for n in a)


def check_async_identity(cfg, fl, train, dev, rounds=3) -> dict:
    """Phase 7 (a): pfeddst_async without a profile and with an infinite
    deadline against pfeddst, same seed and keys, `rounds` rounds under
    torch.use_deterministic_algorithms and cuDNN deterministic. Masks
    equal every round; extractor, header, loss_matrix and last_selected
    bitwise equal at the end unless two pfeddst runs differ too (a library
    call that is not deterministic): the async run is then held to the
    spread of the two pfeddst runs. eff_lag_mean 0, no round_wall_s."""
    import warnings

    import torch

    from repro_torch.fl.strategies import make_strategy

    walls = {}

    def run(name, label):
        strat = make_strategy(name, cfg, fl, 2, device=dev)
        state, masks, mets = strat.init(0), [], []
        torch.cuda.synchronize()
        for r in range(rounds):
            t0 = time.perf_counter()
            state, met = strat.round(state, train, (0, r))
            torch.cuda.synchronize()
            walls.setdefault(label, []).append(time.perf_counter() - t0)
            masks.append(met["select_mask"].cpu())
            mets.append(met)
        return state, masks, mets

    with deterministic(), warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        sync1, masks1, _ = run("pfeddst", "pfeddst")
        asyn, masks_a, mets_a = run("pfeddst_async", "pfeddst_async")
        sync2, masks2, _ = run("pfeddst", "pfeddst_again")
    compare_masks("pfeddst_async against pfeddst", masks1, masks_a)
    compare_masks("pfeddst against pfeddst", masks1, masks2)
    for met in mets_a:
        if float(met["eff_lag_mean"]) != 0.0 or "round_wall_s" in met:
            raise AssertionError("pfeddst_async without a profile: "
                                 f"eff_lag_mean {float(met['eff_lag_mean'])}"
                                 f", round_wall_s {'round_wall_s' in met}")
    fields = {"extractor": (sync1.extractor, sync2.extractor,
                            asyn.extractor),
              "header": (sync1.header, sync2.header, asyn.header),
              "loss_matrix": ({"l": sync1.loss_matrix},
                              {"l": sync2.loss_matrix},
                              {"l": asyn.loss_matrix}),
              "last_selected": ({"t": sync1.last_selected},
                                {"t": sync2.last_selected},
                                {"t": asyn.last_selected})}
    spread, diff = {}, {}
    for name, (a, b, c) in fields.items():
        spread[name], diff[name] = _tree_diff(a, b), _tree_diff(a, c)
        if diff[name] > spread[name]:
            raise AssertionError(
                f"pfeddst_async {name} differs from pfeddst by {diff[name]}"
                f", two pfeddst runs by {spread[name]}")
    bitwise = all(v == 0.0 for v in diff.values())
    return dict(rounds=rounds, masks_equal=True,
                edges=[int(m.sum()) for m in masks_a], bitwise=bitwise,
                max_abs_diff=diff, pfeddst_spread=spread,
                round_walls_s=walls,
                nondeterministic_warnings=sorted({str(w.message)[:120]
                                                  for w in caught}))


def run_async_path(cfg, fl, data, rounds, dev, run_experiment, ops,
                   trace=None):
    """Phase 7 (b), and (c) with `trace`: pfeddst_async through
    `run_experiment` under the bimodal profile, the deadline and the ring
    with stale serving, the launch counters set to 0 just before. The
    strategy's rounds are observed (a wrapper around the one
    `run_experiment` makes) to check, each round, against the host's own
    draws: active = sampled ∧ online ∧ completer (`completion_schedule`),
    store.lag = the deadline misses, round_wall_s = min(straggler, deadline),
    every column the kernel scored equals the live header (participants)
    or its ring slot (the rest) bitwise, select_topk launched once on the
    card with the candidate mask and the cost matrix; History's device
    columns equal the round metrics."""
    import numpy as np
    import torch

    from repro_torch.comms import make_fabric
    from repro_torch.core.scoring import flatten_headers
    from repro_torch.core.rounds import PFEDDST_STREAMS
    from repro_torch.fl import hetero, simulator
    from repro_torch.fl.engine import (named_streams, net_streams,
                                       sample_participants)
    from repro_torch.fl.strategies import local_train_steps, make_strategy

    m = fl.num_clients
    rt = hetero.make_hetero_runtime(fl, m, local_train_steps(
        "pfeddst_async", fl, 2))
    periods, offsets = hetero.completion_schedule(rt)
    rates = hetero.sample_device_vectors(fl.device_profile, m).channel_rate
    host = make_fabric(fl.comms, m, cost_scale=fl.comm_cost,
                       channel_rate=rates, device="cpu")
    seen, calls, mets, counts = [], [], [], []
    strats = []

    def observed(*args, **kw):
        strat = make_strategy(*args, **kw)
        inner = strat.round

        def round_fn(state, data_, key, draws=None):
            before = dict(rnd=int(state.round), header=state.header,
                          ring_h={n: t.clone() for n, t in
                                  state.store.params["h"].items()},
                          lag=state.store.lag.cpu())
            new, met = inner(state, data_, key, draws)
            before["after_lag"] = new.store.lag.cpu()
            seen.append(before)
            strats.append(new)
            return new, met

        strat.round = round_fn
        return strat

    original = ops.select_topk

    def spy(x, last, s_l, t, cost, cand=None, **kw):
        calls.append(dict(x=x.clone(), cuda=x.is_cuda,
                          matrix=isinstance(cost, torch.Tensor)
                          and cost.dim() == 2, cand=cand is not None))
        return original(x, last, s_l, t, cost, cand, **kw)

    def on_round(r, met):
        counts.append(ops.launch_counts()["select_topk"])
        mets.append({k: met[k].cpu() if isinstance(met[k], torch.Tensor)
                     else met[k] for k in met})

    make = simulator.make_strategy
    simulator.make_strategy = observed
    ops.select_topk = spy
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    try:
        t0 = time.perf_counter()
        hist = run_experiment("pfeddst_async", cfg, fl, data,
                              num_rounds=rounds, eval_every=rounds,
                              steps_per_epoch=2, seed=0, verbose=False,
                              device=dev, on_round=on_round, trace=trace,
                              trace_stages=trace is not None)
        total = time.perf_counter() - t0
    finally:
        simulator.make_strategy = make
        ops.select_topk = original
    peak = torch.cuda.max_memory_allocated()
    h = hist.to_dict()
    # the stage profile's rounds (trace_stages) call select_topk first
    calls = calls[len(calls) - rounds:]
    v = rt.depth
    lag_want = torch.zeros(m, dtype=torch.int32)
    per_round = []
    for r in range(rounds):
        met, obs, call = mets[r], seen[r], calls[r]
        streams = named_streams((0, r), PFEDDST_STREAMS)
        _, sampled = sample_participants(
            streams["act"], m, fl.client_sample_ratio, device="cpu")
        _, avail, stale = host.round_masks(net_streams((0, r)))
        done = torch.from_numpy(hetero.completers(periods, offsets, r))
        pre = sampled & avail
        active = met["active"]
        if not torch.equal(active, pre & done):
            raise AssertionError(f"async round {r}: active {active.tolist()}"
                                 f", sampled ∧ online ∧ completer "
                                 f"{(pre & done).tolist()}")
        if not torch.equal(met["stale"], stale):
            raise AssertionError(f"async round {r}: stale draws differ")
        blocked = pre & ~done
        lag_want = torch.where(active, 0, torch.where(
            blocked, lag_want + 1, lag_want)).to(torch.int32)
        if not torch.equal(obs["after_lag"], lag_want):
            raise AssertionError(f"async round {r}: store.lag "
                                 f"{obs['after_lag'].tolist()}, deadline "
                                 f"misses {lag_want.tolist()}")
        wall = torch.from_numpy(rt.wall_s)
        straggler = float(torch.where(pre, wall, 0.0).max())
        if float(met["straggler_wall_s"]) != straggler or \
                float(met["round_wall_s"]) != min(straggler,
                                                  ASYNC_DEADLINE_S):
            raise AssertionError(
                f"async round {r}: round_wall_s {float(met['round_wall_s'])}"
                f", straggler {float(met['straggler_wall_s'])}, want "
                f"{straggler} capped at {ASYNC_DEADLINE_S}")
        if not (call["cuda"] and call["matrix"] and call["cand"]):
            raise AssertionError(f"async round {r}: select_topk call "
                                 f"{ {k: call[k] for k in call if k != 'x'} }")
        idx = (obs["rnd"] - 1 - stale.clamp(0, v - 1).long()) % v
        cols = torch.arange(m)
        slot = {n: t[idx.to(t.device), cols.to(t.device)]
                for n, t in obs["ring_h"].items()}
        act = active.to(dev)
        view = {n: torch.where(act.reshape((-1,) + (1,) * (t.dim() - 1)),
                               obs["header"][n], slot[n])
                for n, t in slot.items()}
        if not torch.equal(call["x"], flatten_headers(view)):
            raise AssertionError(f"async round {r}: the scored headers are "
                                 "not the live and served rows")
        mask = met["select_mask"]
        if bool(mask[~active].any()) or bool(mask.diagonal().any()):
            raise AssertionError(f"async round {r}: inactive rows select")
        per_round.append(dict(
            active=int(active.sum()), blocked=int(blocked.sum()),
            served_stale=int((~active & (stale > 0)).sum()),
            edges=int(mask.sum()),
            eff_lag_mean=float(met["eff_lag_mean"]),
            serve_age_mean=float(met["serve_age_mean"]),
            round_wall_s=float(met["round_wall_s"])))
    launches = [b - a for a, b in zip([0] + counts, counts)]
    if min(launches) < 1:
        raise AssertionError(f"async: select_topk launches per round "
                             f"{launches}")
    for col, key in (("round_device_wall_s", "round_wall_s"),
                     ("round_straggler_wall_s", "straggler_wall_s"),
                     ("round_eff_lag", "eff_lag_mean")):
        if h[col] != [float(met[key]) for met in mets]:
            raise AssertionError(f"async History {col} {h[col]} against "
                                 "the round metrics")
    if not math.isclose(h["device_time_s"][-1], sum(h["round_device_wall_s"]),
                        rel_tol=1e-9):
        raise AssertionError(f"async device_time_s {h['device_time_s']}")
    if not all(math.isfinite(a) for a in h["accuracy"]):
        raise AssertionError("async: accuracy not finite")
    store = strats[-1].store
    store_bytes = sum(t.numel() * t.element_size() for d in
                      store.params.values() for t in d.values()) + \
        store.pub_round.numel() * 4 + store.lag.numel() * 4
    steady = h["wall_s"][-1] / max(rounds - 1, 1)
    return dict(rounds=rounds, periods=sorted(set(periods.tolist())),
                wall_s={"fast": float(np.min(rt.wall_s)),
                        "slow": float(np.max(rt.wall_s))},
                per_round=per_round, launches=ops.launch_counts(),
                select_topk_per_round=launches,
                device_wall_s=h["round_device_wall_s"],
                device_time_s=h["device_time_s"][-1],
                compile_s=h["compile_s"], steady_round_s=steady,
                total_s=total, store_bytes=store_bytes, peak_bytes=peak)


def async_phase(cfg, fl, data, dev, run_experiment, ops) -> dict:
    """Phase 7 (module docstring); prints its rows and returns the
    stragglers run's select_topk launches."""
    from repro_torch.configs import CommsConfig, DeviceProfile
    from repro_torch.obs.trace import validate_trace

    train = {"images": data["train_x"].to(dev),
             "labels": data["train_y"].to(dev)}
    ident = check_async_identity(cfg, fl, train, dev)
    print("async (a) identity: pfeddst_async = pfeddst "
          f"({'bitwise' if ident['bitwise'] else 'within the pfeddst spread'}"
          ")", json.dumps(ident), flush=True)
    fl_async = dataclasses.replace(
        fl, device_profile=DeviceProfile(**ASYNC_PROFILE),
        deadline_s=ASYNC_DEADLINE_S,
        comms=CommsConfig(stale_mode="serve", **FABRIC_NET))
    strag = run_async_path(cfg, fl_async, data, 4, dev, run_experiment, ops)
    print("async (b) stragglers: schedule, lags, served columns bitwise, "
          "select_topk every round", json.dumps(strag), flush=True)
    print(f"async store: {strag['store_bytes']} B "
          f"({strag['store_bytes'] / 1e9:.3f} GB), peak memory "
          f"{strag['peak_bytes'] / 1e9:.3f} GB", flush=True)
    OUT_DIR.mkdir(exist_ok=True)
    path = OUT_DIR / "chip_smoke_async_trace.jsonl"
    traced = run_async_path(cfg, fl_async, data, 4, dev, run_experiment,
                            ops, trace=str(path))
    records, errors = validate_trace(str(path))
    if errors:
        raise AssertionError(f"async (c) trace invalid: {errors[:5]}")
    rounds = [r for r in records if r["type"] == "round"]
    if [r["device"]["wall_s"] for r in rounds] != traced["device_wall_s"]:
        raise AssertionError("async (c) trace device walls differ from "
                             "History")
    profile = next(r["stages"] for r in records
                   if r["type"] == "stage_profile")
    print(f"async (c) trace: {len(records)} records valid "
          f"({path.name}); steady round {traced['steady_round_s']:.4f} s",
          flush=True)
    print("async stage profile (ms, first / steady):", json.dumps(
        {k: [round(v["first_s"] * 1e3, 3), round(v["steady_s"] * 1e3, 3)]
         for k, v in profile.items()}), flush=True)
    return dict(identity=ident, stragglers=strag, traced=traced,
                stage_profile=profile)


# ---------------------------------------------------------------------------
# phase 8: the open world and checkpoints
# ---------------------------------------------------------------------------

OW_ATTACK = dict(adversary_fraction=0.25, attack="sign_flip",
                 score_game="both")
OW_CHURN = dict(join_rate=0.3, leave_rate=0.2, init_alive=0.5)
# columns of each leaf on which the CPU recomputes the card's robust
# aggregate (each coordinate's order statistic is independent)
OW_CPU_COLUMNS = 32768
# phase 8's checkpoints (GBs: too large for chiprun_out); gitignored and
# removed after use
CKPT_DIR = ROOT / ".smoke_ckpt"


def observe(stages, name, before=None, after=None):
    """The stages with the one named `name` wrapped: `before(state, ctx)`
    runs first, its result goes to `after(token, out, ctx)`, which runs
    on the stage's output; the stage keeps its name."""
    from repro_torch.obs.timers import stage_name

    out, hit = [], False
    for stage in stages:
        if stage_name(stage) != name:
            out.append(stage)
            continue
        hit = True

        def wrapped(state, ctx, _stage=stage):
            token = before(state, ctx) if before else None
            new = _stage(state, ctx)
            if after:
                after(token, new, ctx)
            return new

        wrapped.stage_name = name
        out.append(wrapped)
    if not hit:
        raise AssertionError(f"no stage named {name!r}")
    return tuple(out)


def drive(strat, stages, fl, train, rounds, seed=0, on_round=None):
    """`rounds` rounds of `stages` (the strategy's, some observed) as its
    own `round` runs them; → (state, metrics of each round)."""
    from repro_torch.fl.engine import run_round

    state, mets = strat.init(seed), []
    for r in range(rounds):
        aff = None if strat.affinity is None else strat.affinity(state)
        state, met = run_round(stages, state, train, (seed, r),
                               m=fl.num_clients,
                               ratio=fl.client_sample_ratio,
                               key_streams=strat.key_streams,
                               fabric=strat.fabric, affinity=aff)
        mets.append(met)
        if on_round is not None:
            on_round(r, met)
    return state, mets


def _same(a, b) -> bool:
    """Two tensors bit for bit (bf16 through its int16 view)."""
    import torch

    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return bool(torch.equal(a, b))


def _state_fields(state) -> dict:
    """A pfeddst state's (plain or wrapped) compared fields."""
    inner = state["inner"] if isinstance(state, dict) else state
    return {"extractor": inner.extractor, "header": inner.header,
            "loss_matrix": {"l": inner.loss_matrix},
            "last_selected": {"t": inner.last_selected}}


def check_open_identity(cfg, fl, train, dev, rounds=3) -> dict:
    """Phase 8 (a): inert configs return the unwrapped stage objects; the
    wrapping zero-rate churn (init_alive 0.99: every slot alive) and the
    std-0 gaussian attack run `rounds` pfeddst rounds against plain
    pfeddst from the same seed under deterministic algorithms (as phase 7
    (a)): masks equal every round, the state bitwise equal at the end (or
    within the spread of two plain runs)."""
    import warnings

    from repro_torch.configs import ChurnConfig, ThreatConfig
    from repro_torch.fl import strategies
    from repro_torch.obs.timers import stage_name
    from repro_torch.openworld import make_open_spec

    inert = dataclasses.replace(fl, threat=ThreatConfig(),
                                churn=ChurnConfig())
    spec = strategies._pfeddst_spec(cfg, inert, 2, "pfeddst", dev)
    got = make_open_spec(spec, inert, device=dev)
    if not (got is spec and got.init is spec.init
            and got.stages is spec.stages):
        raise AssertionError("open world: inert configs wrapped the spec")
    plain_names = [stage_name(s) for s in strategies.make_strategy(
        "pfeddst", cfg, fl, 2, device=dev).stages]
    if [stage_name(s) for s in strategies.make_strategy(
            "pfeddst", cfg, inert, 2, device=dev).stages] != plain_names:
        raise AssertionError("open world: inert make_strategy stages")
    wraps = {"churn": dataclasses.replace(
                 fl, churn=ChurnConfig(init_alive=0.99)),
             "gaussian_std0": dataclasses.replace(
                 fl, threat=ThreatConfig(adversary_fraction=0.25,
                                         attack="gaussian", noise_std=0.0))}

    def run(fl_run):
        strat = strategies.make_strategy("pfeddst", cfg, fl_run, 2,
                                         device=dev)
        state, masks = strat.init(0), []
        for r in range(rounds):
            state, met = strat.round(state, train, (0, r))
            masks.append(met["select_mask"].cpu())
        return state, masks, [stage_name(s) for s in strat.stages]

    with deterministic(), warnings.catch_warnings(record=True):
        warnings.simplefilter("always")
        base, masks0, _ = run(fl)
        outs = {k: run(v) for k, v in wraps.items()}
        again, masks1, _ = run(fl)
    compare_masks("pfeddst against pfeddst", masks0, masks1)
    spread = {f: _tree_diff(a, _state_fields(again)[f])
              for f, a in _state_fields(base).items()}
    result = dict(rounds=rounds, pfeddst_spread=spread)
    for label, (state, masks, names) in outs.items():
        if len(names) <= len(plain_names) or not isinstance(state, dict):
            raise AssertionError(f"open world (a) {label}: not wrapped "
                                 f"({names})")
        if not bool(state["alive"].all()):
            raise AssertionError(f"open world (a) {label}: a slot died")
        compare_masks(f"open world (a) {label}", masks0, masks)
        diff = {f: _tree_diff(a, _state_fields(state)[f])
                for f, a in _state_fields(base).items()}
        if any(diff[f] > spread[f] for f in diff):
            raise AssertionError(f"open world (a) {label}: state differs "
                                 f"by {diff}, two plain runs by {spread}")
        result[label] = dict(stages=names, masks_equal=True,
                             bitwise=all(v == 0.0 for v in diff.values()),
                             max_abs_diff=diff)
    return result


def _numpy_isolation(edges, cand, adv, active):
    """The isolation scalars in float32 numpy (the module's formulas)."""
    import numpy as np

    f32 = np.float32
    honest = ~adv & active
    sel = edges & honest[:, None]
    frac = f32((sel & adv[None, :]).sum()) / max(f32(sel.sum()), f32(1))
    reach = cand & honest[:, None]
    base = f32((reach & adv[None, :]).sum()) / max(f32(reach.sum()), f32(1))
    iso = f32(1) - frac / max(base, f32(1e-8)) if base > 0 else f32(0)
    return {"adv_edge_frac": frac, "adv_base_frac": base,
            "adv_isolation": iso}


def run_attacked(cfg, fl, train, dev, ops, defense, rounds) -> dict:
    """Phase 8 (b): pfeddst under sign_flip with score gaming ("both") and
    `defense`, `rounds` rounds with the launch counters set to 0 just
    before, each round checked against the host: the cast, select_topk's
    (M, M) cost (adversary columns max(c)·cost_gain, the others the
    fabric's) and spoofed headers, the snapshot untouched until the
    corruption, the byzantine rows pre − scale·(post − pre) and the
    honest rows passed through bitwise, the robust aggregate against the
    CPU's on the same tensors (median bitwise, trimmed mean rtol 1e-6),
    the isolation scalars against numpy. Times the aggregate and its
    peak memory above its inputs."""
    import numpy as np
    import torch

    from repro_torch.configs import ThreatConfig
    from repro_torch.core import rounds as rounds_mod
    from repro_torch.core.scoring import flatten_headers
    from repro_torch.fl.strategies import make_strategy
    from repro_torch.openworld import adversary_mask
    from repro_torch.openworld.lifecycle import population_params

    fl_b = dataclasses.replace(fl, threat=ThreatConfig(**OW_ATTACK,
                                                       defense=defense))
    m = fl.num_clients
    adv = adversary_mask(m, OW_ATTACK["adversary_fraction"], 0)
    adv_t = torch.from_numpy(adv).to(dev)
    strat = make_strategy("pfeddst", cfg, fl_b, 2, device=dev)
    c = strat.fabric.cost
    log = {"agg": [], "byz": [], "select": [], "cand": [], "header": []}

    def threat_after(_, state, ctx):
        if not np.array_equal(ctx.threat.adversaries.cpu().numpy(), adv):
            raise AssertionError("open world (b): the cast is not "
                                 "adversary_mask(16, 0.25, 0)")
        return None

    def score_before(state, ctx):
        log["header"].append(flatten_headers(state["inner"].header))

    def snap_after(_, state, ctx):
        log["snap"] = {p: {n: t.clone() for n, t in part.items()}
                       for p, part in ctx.aux["ow_pre"].items()}

    def byz_before(state, ctx):
        pre = ctx.aux["ow_pre"]
        for p, part in pre.items():
            for n, t in part.items():
                if not _same(t, log["snap"][p][n]):
                    raise AssertionError(f"open world (b): the snapshot's "
                                         f"{p}/{n} changed before the "
                                         "corruption")
        return pre, population_params(state["inner"]), ctx.active.clone()

    def byz_after(token, state, ctx):
        pre, post, active = token
        out = population_params(state["inner"])
        hit = (adv_t & active).reshape(-1)
        for p in ("e", "h"):
            for n, q in post[p].items():
                pf = pre[p][n].float()
                want = (pf - fl_b.threat.attack_scale
                        * (q.float() - pf)).to(q.dtype)
                got = out[p][n]
                if not (_same(got[hit], want[hit])
                        and _same(got[~hit], q[~hit])):
                    raise AssertionError(f"open world (b): byzantine rows "
                                         f"of {p}/{n}")
        log["byz"].append(int(hit.sum()))

    def metrics_before(state, ctx):
        log["cand"].append(ctx.cand.cpu().numpy())

    stages = observe(strat.stages, "ow_threat", after=threat_after)
    stages = observe(stages, "score_select", before=score_before)
    stages = observe(stages, "ow_snapshot", after=snap_after)
    stages = observe(stages, "ow_byzantine", before=byz_before,
                     after=byz_after)
    stages = observe(stages, "ow_metrics", before=metrics_before)

    real_agg, real_sel = rounds_mod.robust_row_aggregate, ops.select_topk

    def agg_spy(tree, edges, weights, m_, **kw):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = real_agg(tree, edges, weights, m_, **kw)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated() - base
        err = 0.0
        for n, x in tree.items():
            cols = x.reshape(m_, -1)[:, :OW_CPU_COLUMNS]
            want = real_agg({n: cols.cpu()}, edges.cpu(), weights.cpu(),
                            m_, **kw)[n]
            got = out[n].reshape(m_, -1)[:, :OW_CPU_COLUMNS].cpu()
            if kw["defense"] == "median":
                if not torch.equal(got, want):
                    raise AssertionError(f"open world (b): median of {n} "
                                         "differs from the CPU's")
            elif kw["defense"] == "trimmed_mean":
                if not torch.allclose(got.float(), want.float(), rtol=1e-6,
                                      atol=0.0):
                    raise AssertionError(f"open world (b): trimmed mean of "
                                         f"{n} beyond rtol 1e-6 of the CPU")
            err = max(err, float((got.float() - want.float()).abs().max()))
        log["agg"].append(dict(ms=ms, peak_above_inputs_bytes=peak,
                               cpu_max_abs_diff=err))
        return out

    def sel_spy(x, last, s_l, t, cost, cand=None, **kw):
        log["select"].append(dict(x=x, cost=cost, cand=cand))
        return real_sel(x, last, s_l, t, cost, cand, **kw)

    rounds_mod.robust_row_aggregate, ops.select_topk = agg_spy, sel_spy
    ops.reset_launch_counts()
    try:
        t0 = time.perf_counter()
        _, mets = drive(strat, stages, fl_b, train, rounds)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        rounds_mod.robust_row_aggregate, ops.select_topk = real_agg, real_sel
    launches = ops.launch_counts()
    if launches["select_topk"] != rounds or len(log["select"]) != rounds:
        raise AssertionError(f"open world (b): select_topk {launches}")
    if defense != "none" and len(log["agg"]) != rounds:
        raise AssertionError("open world (b): the robust aggregate ran "
                             f"{len(log['agg'])} times")
    cmax = float(c.max())
    iso = []
    for r, met in enumerate(mets):
        call = log["select"][r]
        cost = call["cost"]
        if not (isinstance(cost, torch.Tensor) and cost.shape == (m, m)
                and call["cand"] is not None
                and call["x"].device.type == torch.device(dev).type):
            raise AssertionError(f"open world (b) round {r}: select_topk "
                                 "was not given the (M, M) cost and mask")
        if not (bool((cost[:, adv_t] == cmax * 1.0).all())
                and torch.equal(cost[:, ~adv_t], c[:, ~adv_t].float())):
            raise AssertionError(f"open world (b) round {r}: cost columns")
        flat = log["header"][r]
        x = call["x"]
        honest = flat[~adv_t].double()
        spoof = -(honest.sum(0) / honest.shape[0])
        if not (torch.equal(x[~adv_t], flat[~adv_t]) and torch.allclose(
                x[adv_t].double(), spoof.expand(int(adv.sum()), -1),
                rtol=1e-5, atol=1e-6)):
            raise AssertionError(f"open world (b) round {r}: spoofed "
                                 "header rows")
        want = _numpy_isolation(met["select_mask"].cpu().numpy(),
                                log["cand"][r], adv,
                                met["active"].cpu().numpy())
        got = {k: float(met[k]) for k in want}
        if any(got[k] != float(want[k]) for k in want):
            raise AssertionError(f"open world (b) round {r}: isolation "
                                 f"{got}, numpy {want}")
        iso.append(got)
    return dict(defense=defense, rounds=rounds, total_s=total,
                launches=launches, byzantine_rows=log["byz"],
                aggregate=log["agg"], isolation=iso,
                adv_active_n=[int(met["adv_active_n"]) for met in mets])


def run_gossip_attack(cfg, fl_base, train, dev, ops, defense,
                      rounds=2) -> dict:
    """Phase 8 (c): dfedavgm under the scale attack on a ring (the packed
    plan, D = 3): with no defense gossip_mix mixes every round; under a
    defense the robust mixer runs and gossip_mix never launches."""
    from repro_torch.configs import CommsConfig, ThreatConfig
    from repro_torch.fl.strategies import make_strategy
    from repro_torch.openworld import defense as dmod

    fl_c = dataclasses.replace(
        fl_base, comms=CommsConfig(topology="ring"),
        threat=ThreatConfig(adversary_fraction=0.25, attack="scale",
                            attack_scale=2.0, defense=defense))
    strat = make_strategy("dfedavgm", cfg, fl_c, 2, device=dev)
    real = dmod.robust_row_aggregate
    mixers = []

    def spy(*args, **kw):
        mixers.append(1)
        return real(*args, **kw)

    counts = []
    dmod.robust_row_aggregate = spy
    ops.reset_launch_counts()
    try:
        state = strat.init(0)
        for r in range(rounds):
            state, met = strat.round(state, train, (0, r))
            counts.append(ops.launch_counts()["gossip_mix"])
    finally:
        dmod.robust_row_aggregate = real
    per_round = [b - a for a, b in zip([0] + counts, counts)]
    want = [0] * rounds if defense != "none" else [1] * rounds
    if per_round != want or len(mixers) != (rounds if defense != "none"
                                            else 0):
        raise AssertionError(f"open world (c) {defense}: gossip_mix per "
                             f"round {per_round}, robust mixer "
                             f"{len(mixers)} times")
    loss = float(met["train_loss"])
    if not math.isfinite(loss):
        raise AssertionError(f"open world (c) {defense}: loss {loss}")
    return dict(defense=defense, gossip_mix_per_round=per_round,
                robust_mixer_calls=len(mixers), launches=ops.launch_counts(),
                isolation=float(met["adv_isolation"]))


def run_churn(cfg, fl, fl_base, train, dev, ops, n_leaves) -> dict:
    """Phase 8 (d): pfeddst (4 rounds) and dispfl (3 rounds) under churn.
    pfeddst: select_topk given the churn candidate mask every round, no
    dead client selects or is selected, each joined row's parameters the
    pre-churn alive rows' mean bitwise, its optimizer rows 0, loss row 0,
    recency row −1, the telemetry the masks' counts. dispfl: mask_evolve
    once a round over every leaf."""
    from repro_torch.configs import ChurnConfig
    from repro_torch.fl.strategies import make_strategy
    from repro_torch.openworld import lifecycle

    churn = ChurnConfig(**OW_CHURN)
    fl_d = dataclasses.replace(fl, churn=churn)
    strat = make_strategy("pfeddst", cfg, fl_d, 2, device=dev)
    log = {"sel": [], "alive": [], "joined": []}

    def churn_before(state, ctx):
        return state["inner"], state["alive"].clone()

    def churn_after(token, state, ctx):
        inner0, alive0 = token
        alive = state["alive"]
        joined, left = alive & ~alive0, alive0 & ~alive
        boot = lifecycle._mean_over_active(
            lifecycle.population_params(inner0), alive0)
        inner = state["inner"]
        new = lifecycle.population_params(inner)
        old = lifecycle.population_params(inner0)
        for p in ("e", "h"):
            for n, t in new[p].items():
                if not (_same(t[joined], boot[p][n][joined])
                        and _same(t[~joined], old[p][n][~joined])):
                    raise AssertionError(f"open world (d): joined rows of "
                                         f"{p}/{n}")
        zero = all(not bool(t[joined].any()) for opt in
                   (inner.opt_e, inner.opt_h) for t in opt["mu"].values())
        if not (zero and not bool(inner.loss_matrix[joined].any())
                and bool((inner.last_selected[joined] == -1).all())):
            raise AssertionError("open world (d): joined rows not reset")
        if (float(ctx.metrics["alive_frac"]) != float(alive.float().mean())
                or int(ctx.metrics["joined_n"]) != int(joined.sum())
                or int(ctx.metrics["left_n"]) != int(left.sum())):
            raise AssertionError("open world (d): churn telemetry")
        log["alive"].append(alive.clone())
        log["joined"].append(int(joined.sum()))

    real = ops.select_topk

    def spy(x, last, s_l, t, cost, cand=None, **kw):
        log["sel"].append(cand)
        return real(x, last, s_l, t, cost, cand, **kw)

    stages = observe(strat.stages, "ow_churn", before=churn_before,
                     after=churn_after)
    ops.select_topk = spy
    ops.reset_launch_counts()
    try:
        _, mets = drive(strat, stages, fl_d, train, 4)
    finally:
        ops.select_topk = real
    sel_launches = ops.launch_counts()["select_topk"]
    for r, met in enumerate(mets):
        alive, cand = log["alive"][r], log["sel"][r]
        pair = alive[:, None] & alive[None, :]
        if cand is None or bool((cand & ~pair).any()):
            raise AssertionError(f"open world (d) round {r}: select_topk "
                                 "not given the churn mask")
        mask = met["select_mask"]
        if bool(mask[~alive].any()) or bool(mask[:, ~alive].any()) or \
                bool((met["active"] & ~alive).any()):
            raise AssertionError(f"open world (d) round {r}: a dead client "
                                 "selects or is selected")
    if sel_launches != 4:
        raise AssertionError(f"open world (d): select_topk {sel_launches}")
    pfeddst = dict(rounds=4, alive=[int(a.sum()) for a in log["alive"]],
                   joined=log["joined"], select_topk=sel_launches)

    evolve = ops.KERNELS["mask_evolve"]
    strat = make_strategy("dispfl", cfg, dataclasses.replace(
        fl_base, churn=churn), 2, device=dev)
    counts = []
    ops.reset_launch_counts()
    state = strat.init(0)
    for r in range(3):
        state, met = strat.round(state, train, (0, r))
        counts.append((ops.launch_counts()["mask_evolve"], evolve.leaves))
    calls = [b[0] - a[0] for a, b in zip([(0, 0)] + counts, counts)]
    leaves = [b[1] - a[1] for a, b in zip([(0, 0)] + counts, counts)]
    if set(calls) != {1} or set(leaves) != {n_leaves}:
        raise AssertionError(f"open world (d) dispfl: mask_evolve calls "
                             f"{calls} over {leaves} leaves")
    return dict(pfeddst=pfeddst, dispfl=dict(
        rounds=3, mask_evolve_calls=calls, leaves=leaves,
        alive=int(state["alive"].sum())))


def run_open_trace(cfg, fl, data, dev, run_experiment) -> dict:
    """Phase 8 (d), last: `run_experiment` under the attack and churn with
    `eval_mask` = the honest cast and a trace: the selection graph names
    the adversaries, the port's `validate_trace` passes."""
    import numpy as np

    from repro_torch.configs import ChurnConfig, ThreatConfig
    from repro_torch.obs.trace import validate_trace
    from repro_torch.openworld import adversary_mask

    fl_t = dataclasses.replace(fl, threat=ThreatConfig(**OW_ATTACK,
                                                       defense="median"),
                               churn=ChurnConfig(**OW_CHURN))
    adv = adversary_mask(fl.num_clients, OW_ATTACK["adversary_fraction"], 0)
    OUT_DIR.mkdir(exist_ok=True)
    path = OUT_DIR / "chip_smoke_openworld_trace.jsonl"
    hist = run_experiment("pfeddst", cfg, fl_t, data, num_rounds=2,
                          eval_every=1, steps_per_epoch=2, seed=0,
                          verbose=False, device=dev, trace=str(path),
                          eval_mask=~adv)
    records, errors = validate_trace(str(path))
    if errors:
        raise AssertionError(f"open world trace invalid: {errors[:5]}")
    graph = next(r for r in records if r["type"] == "selection_graph")
    if graph.get("adversaries") != [int(i) for i in np.flatnonzero(adv)]:
        raise AssertionError(f"open world trace adversaries "
                             f"{graph.get('adversaries')}")
    if not all(math.isfinite(a) for a in hist.accuracy):
        raise AssertionError(f"open world honest accuracy {hist.accuracy}")
    return dict(records=len(records), adversaries=graph["adversaries"],
                honest_accuracy=hist.accuracy,
                adv_isolation=hist.extra["adv_isolation"],
                alive_frac=hist.extra["alive_frac"])


def check_checkpoints(cfg, fl, train, dev) -> dict:
    """Phase 8 (e): (b)'s attacked population after 2 rounds saved with
    `save_checkpoint` and restored on the card bitwise (file bytes, save
    and restore seconds); then `launch/serve.py --ckpt-dir` for
    qwen2-1.5b at full width in bf16 (batch 4, prompt 512, 16 tokens, 1
    request): the restored parameters serve the greedy tokens of the
    parameters they were saved from."""
    import shutil

    import torch

    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.configs import ThreatConfig, get_config
    from repro_torch.fl.strategies import make_strategy
    from repro_torch.launch import serve
    from repro_torch.models import model as model_mod
    from repro_torch.utils.pytree import tree_paths

    out = {}
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    try:
        fl_b = dataclasses.replace(fl, threat=ThreatConfig(
            **OW_ATTACK, defense="median"))
        strat = make_strategy("pfeddst", cfg, fl_b, 2, device=dev)
        state = strat.init(0)
        for r in range(2):
            state, _ = strat.round(state, train, (0, r))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = save_checkpoint(str(CKPT_DIR / "population"), 2, state)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        restored, manifest = load_checkpoint(path, like=state, device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        pairs, want = tree_paths(restored), tree_paths(state)
        if [p for p, _ in pairs] != [p for p, _ in want] or not all(
                _same(a, b) for (_, a), (_, b) in zip(pairs, want)):
            raise AssertionError("checkpoint: the restored population "
                                 "differs")
        out["population"] = dict(
            leaves=len(pairs), file_bytes=Path(path).stat().st_size,
            save_s=save_s, restore_s=load_s, step=manifest["step"])
        del state, restored

        qcfg = get_config("qwen2-1.5b")
        params = model_mod.init_params(
            qcfg, torch.Generator(device=dev).manual_seed(11), dev)
        t0 = time.perf_counter()
        qpath = save_checkpoint(str(CKPT_DIR / "qwen"), 1, params)
        qsave = time.perf_counter() - t0
        args = ["--arch", "qwen2-1.5b", "--batch", "4", "--prompt-len",
                "512", "--gen", "16", "--requests", "1", "--seed", "0"]
        real = model_mod.init_params
        model_mod.init_params = lambda c, g, d: params
        try:
            want_tok = serve.main(args)
        finally:
            model_mod.init_params = real
        del params
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        got_tok = serve.main(args + ["--ckpt-dir", str(CKPT_DIR / "qwen")])
        serve_s = time.perf_counter() - t0
        if not torch.equal(got_tok, want_tok):
            raise AssertionError("serve --ckpt-dir: the restored parameters "
                                 "serve other tokens")
        out["serve_qwen2"] = dict(file_bytes=Path(qpath).stat().st_size,
                                  save_s=qsave, restore_and_serve_s=serve_s,
                                  tokens_equal=True,
                                  shape=list(got_tok.shape))
    finally:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
        torch.cuda.empty_cache()
    return out


def openworld_phase(cfg, fl, data, dev, run_experiment, ops,
                    n_leaves) -> dict:
    """Phase 8 (module docstring); prints its rows and returns the
    open-world launches of select_topk, gossip_mix and mask_evolve."""
    fl_base = dataclasses.replace(fl, lr=BASELINE_LR)
    train = {"images": data["train_x"].to(dev),
             "labels": data["train_y"].to(dev)}
    ident = check_open_identity(cfg, fl, train, dev)
    print("open world (a) identity: inert configs unwrapped; zero-rate "
          "churn and std-0 gaussian = pfeddst", json.dumps(ident),
          flush=True)
    attacked = [run_attacked(cfg, fl, train, dev, ops, "median", 3),
                run_attacked(cfg, fl, train, dev, ops, "trimmed_mean", 1),
                run_attacked(cfg, fl, train, dev, ops, "norm_clip", 1)]
    for row in attacked:
        print(f"open world (b) attacked pfeddst, defense {row['defense']}",
              json.dumps(row), flush=True)
    gossip = [run_gossip_attack(cfg, fl_base, train, dev, ops, d)
              for d in ("none", "trimmed_mean")]
    for row in gossip:
        print(f"open world (c) dfedavgm, defense {row['defense']}",
              json.dumps(row), flush=True)
    churn = run_churn(cfg, fl, fl_base, train, dev, ops, n_leaves)
    print("open world (d) churn", json.dumps(churn), flush=True)
    traced = run_open_trace(cfg, fl, data, dev, run_experiment)
    print("open world (d) traced run", json.dumps(traced), flush=True)
    ckpt = check_checkpoints(cfg, fl, train, dev)
    print("open world (e) checkpoints", json.dumps(ckpt), flush=True)
    return {
        "select_topk": {f"attacked_{r['defense']}":
                        r["launches"]["select_topk"] for r in attacked}
        | {"churn": churn["pfeddst"]["select_topk"]},
        "gossip_mix": {f"dfedavgm_{r['defense']}":
                       r["launches"]["gossip_mix"] for r in gossip},
        "mask_evolve": {"dispfl_churn": sum(
            churn["dispfl"]["mask_evolve_calls"])},
    }


# ---------------------------------------------------------------------------
# phase 9: the experiment drivers and chunked rounds
# ---------------------------------------------------------------------------

# 6 of the reference's 60 rounds: the first chunk of 5 and a second of 1
# (the CLI's eval_every is 5), so phase 9 keeps to its 120 s on a slow
# host
CLI_ROUNDS = 6
CLI_ARGV = ["--paper-scale", "--rounds", str(CLI_ROUNDS), "--strategies",
            "pfeddst", "dfedpgp", "dispfl"]
CLI_KERNELS = {"dfedpgp": "gossip_mix", "dispfl": "mask_evolve"}


def run_cli(ops, phase3_walls) -> dict:
    """Phase 9 (a): the driver's CLI at full width (`CLI_ARGV`: full
    ResNet-18, bf16, M=16, the default chunk of 5, so two chunks a
    strategy: 5 rounds, then 1). The driver's run_experiment is wrapped to set the launch
    counters to 0 just before each strategy's run and read them just after,
    and to run every strategy at BASELINE_LR: at the paper's 0.1,
    pfeddst's bf16 steps diverge within 10 rounds (on the card a
    10-round run reached NaN; (a0) reads the loss at round 5), and so
    they do at reduced depth in both packages on the CPU
    (tests/test_torch_lr_divergence.py: losses in the tens from round 1,
    then NaN or ~1e17–1e35 at round 10), so a finite-loss check needs the
    lower rate.
    Losses and accuracy finite at rounds 5 and 6; gossip_mix 6 launches
    in 6 dfedpgp rounds, mask_evolve 6 calls over 6 × 56 leaves in 6
    dispfl rounds. The steady per-round wall is the second chunk's wall
    over its rounds."""
    from repro_torch.examples import fl_cifar_sim

    real = fl_cifar_sim.run_experiment
    launches = {}

    def counted(name, cfg, fl, data, **kw):
        fl = dataclasses.replace(fl, lr=BASELINE_LR)
        ops.reset_launch_counts()
        hist = real(name, cfg, fl, data, **kw)
        launches[name] = {**ops.launch_counts(),
                          "leaves": ops.KERNELS["mask_evolve"].leaves}
        return hist

    fl_cifar_sim.run_experiment = counted
    try:
        t0 = time.perf_counter()
        hists = fl_cifar_sim.main(CLI_ARGV)
        total = time.perf_counter() - t0
    finally:
        fl_cifar_sim.run_experiment = real
    rows = {}
    for name, hist in hists.items():
        h = hist.to_dict()
        if h["rounds"] != [5, CLI_ROUNDS] or not all(
                math.isfinite(v) for v in h["train_loss"] + h["accuracy"]):
            raise AssertionError(f"cli {name}: rounds {h['rounds']}, loss "
                                 f"{h['train_loss']}, acc {h['accuracy']}")
        kernel = CLI_KERNELS.get(name)
        if kernel is not None and launches[name][kernel] != CLI_ROUNDS:
            raise AssertionError(f"cli {name}: {kernel} launched "
                                 f"{launches[name][kernel]} times in "
                                 f"{CLI_ROUNDS} rounds")
        if (kernel == "mask_evolve"
                and launches[name]["leaves"] != CLI_ROUNDS * 56):
            raise AssertionError(f"cli dispfl: mask_evolve covered "
                                 f"{launches[name]['leaves']} leaves, "
                                 f"expected {CLI_ROUNDS} × 56")
        steady = phase3_walls[name][1:]
        rows[name] = dict(
            accuracy=h["accuracy"], train_loss=h["train_loss"],
            first_chunk_s=h["compile_s"],
            steady_round_s=h["wall_s"][-1] / (CLI_ROUNDS - 5),
            phase3_steady_round_s=sum(steady) / len(steady),
            launches={k: v for k, v in launches[name].items() if v})
    return dict(argv=CLI_ARGV, lr=BASELINE_LR, total_s=total, runs=rows)


def run_cli_own_lr() -> dict:
    """Phase 9 (a0): the user's command itself, nothing patched:
    `--paper-scale --rounds 5 --strategies pfeddst` at the CLI's own lr
    (the paper's 0.1), one chunk of 5. Held to what that lr allows: the
    History's one eval point at round 5 with a finite accuracy in
    [0, 1]. Its train loss is printed, finite or not: at this lr the
    reduced-depth runs of both packages diverge
    (tests/test_torch_lr_divergence.py), so the card's loss is a reading,
    not a check."""
    from repro_torch.examples import fl_cifar_sim

    argv = ["--paper-scale", "--rounds", "5", "--strategies", "pfeddst"]
    t0 = time.perf_counter()
    h = fl_cifar_sim.main(argv)["pfeddst"].to_dict()
    total = time.perf_counter() - t0
    acc = h["accuracy"]
    if h["rounds"] != [5] or not all(math.isfinite(a) and 0 <= a <= 1
                                     for a in acc):
        raise AssertionError(f"cli at its own lr: rounds {h['rounds']}, "
                             f"accuracy {acc}")
    return dict(argv=argv, lr=0.1, accuracy=acc,
                train_loss=h["train_loss"],
                loss_finite=all(math.isfinite(v) for v in h["train_loss"]),
                total_s=total)


def chunk_cost(name, cfg, fl, data, dev, rounds=2, pairs=3) -> dict:
    """Phase 9 (e): what chunking costs or saves. The same cell
    (`run_experiment(name)` at phase 3's settings, `rounds` rounds, one
    eval at the end) per round and in one chunk of `rounds`, in turns
    (per round first in even pairs, chunked first in odd ones), `pairs`
    runs of each: the medians of the whole run's wall (init, rounds,
    readback, eval) and of the rounds' own wall (`History.compile_s` plus
    the steady wall), per round, and each pair's chunked / per-round
    ratio of the rounds' wall (the two runs of a pair are back to back,
    so a drift of the shared host across the pairs cancels)."""
    from repro_torch.fl.simulator import run_experiment

    walls = {1: [], rounds: []}
    for i in range(pairs):
        for chunk in ((1, rounds) if i % 2 == 0 else (rounds, 1)):
            t0 = time.perf_counter()
            h = run_experiment(name, cfg, fl, data, num_rounds=rounds,
                               eval_every=rounds, steps_per_epoch=2, seed=0,
                               verbose=False, device=dev,
                               chunk_rounds=chunk).to_dict()
            walls[chunk].append(dict(
                run_s=time.perf_counter() - t0,
                rounds_s=h["compile_s"] + h["wall_s"][-1]))

    def median_per_round(chunk, key):
        return statistics.median(w[key] for w in walls[chunk]) / rounds

    ratios = [c["rounds_s"] / p["rounds_s"]
              for c, p in zip(walls[rounds], walls[1])]
    return dict(name=name, rounds=rounds, pairs=pairs, walls=walls,
                pair_ratios=ratios,
                median_pair_ratio=statistics.median(ratios),
                median_run_s_per_round={
                    "per_round": median_per_round(1, "run_s"),
                    "chunked": median_per_round(rounds, "run_s")},
                median_rounds_s_per_round={
                    "per_round": median_per_round(1, "rounds_s"),
                    "chunked": median_per_round(rounds, "rounds_s")})


def _capture_final_state(simulator):
    """Wrap simulator.make_strategy so the strategy's params_for_eval keeps
    the last state it is given: with one eval point at the last round,
    that is the run's final state. → (restore function, holder)."""
    real = simulator.make_strategy
    held = {}

    def make(*args, **kw):
        strat = real(*args, **kw)
        inner = strat.params_for_eval

        def params_for_eval(state):
            held["state"] = state
            return inner(state)

        return dataclasses.replace(strat, params_for_eval=params_for_eval)

    simulator.make_strategy = make

    def restore():
        simulator.make_strategy = real

    return restore, held


def check_chunk_parity(name, cfg, fl, data, rounds, dev, ops,
                       kernel) -> dict:
    """Phase 9 (b): run_experiment with chunk_rounds=rounds against
    chunk_rounds=1 (eval_every=rounds), under deterministic algorithms:
    every History field but the walls equal, the final state bitwise
    equal, `kernel` launched once a round in each run."""
    import torch

    from repro_torch.fl import simulator
    from repro_torch.utils.pytree import tree_paths

    out = {}
    restore, held = _capture_final_state(simulator)
    try:
        with deterministic():
            for chunk in (rounds, 1):
                ops.reset_launch_counts()
                t0 = time.perf_counter()
                hist = simulator.run_experiment(
                    name, cfg, fl, data, num_rounds=rounds,
                    eval_every=rounds, steps_per_epoch=2, seed=0,
                    verbose=False, device=dev, chunk_rounds=chunk)
                out[chunk] = dict(hist=hist.to_dict(), state=held["state"],
                                  launches=ops.launch_counts()[kernel],
                                  wall_s=time.perf_counter() - t0)
    finally:
        restore()
    a, b = out[rounds], out[1]
    for key in set(a["hist"]) - {"wall_s", "compile_s"}:
        if a["hist"][key] != b["hist"][key]:
            raise AssertionError(f"{name}: chunked History {key} "
                                 f"{a['hist'][key]} != {b['hist'][key]}")
    pa, pb = tree_paths(a["state"]), tree_paths(b["state"])
    if [p for p, _ in pa] != [p for p, _ in pb]:
        raise AssertionError(f"{name}: final states differ in layout")
    for (path, x), (_, y) in zip(pa, pb):
        same = (torch.equal(x, y) if isinstance(x, torch.Tensor)
                else x == y)
        if not same:
            raise AssertionError(f"{name}: final state {path} differs "
                                 "between the chunked and per-round runs")
    for chunk in (rounds, 1):
        if out[chunk]["launches"] != rounds:
            raise AssertionError(f"{name}: {kernel} launched "
                                 f"{out[chunk]['launches']} times in "
                                 f"{rounds} rounds (chunk {chunk})")
    return dict(name=name, rounds=rounds, kernel=kernel,
                launches_chunked=a["launches"], launches_per_round=
                b["launches"], history_equal=True, state_bitwise=True,
                leaves=len(pa), accuracy=a["hist"]["accuracy"],
                wall_s={"chunked": a["wall_s"], "per_round": b["wall_s"]})


def count_syncs(fn):
    """Run fn() with torch.cuda.set_sync_debug_mode("warn"), catching the
    warnings: → (fn's result, the synchronising calls as "file:line")."""
    import warnings

    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    where = [f"{Path(w.filename).name}:{w.lineno}" for w in caught
             if "synchroniz" in str(w.message)]
    return out, where


def check_syncs(name, cfg, fl, data, dev, rounds=2) -> dict:
    """Phase 9 (c): host synchronisations counted in `rounds` make_round
    calls and in one make_multi_round chunk of `rounds` (same keys, fresh
    states): the chunk may add none. The same for whole run_experiment
    runs, per round and chunked (these include the init, the data's copy
    and one eval). Per-round locations of the make_round run are
    printed."""
    from collections import Counter

    from repro_torch.fl import engine
    from repro_torch.fl.simulator import run_experiment
    from repro_torch.fl.strategies import make_strategy

    strat = make_strategy(name, cfg, fl, 2, device=dev)
    train = {"images": data["train_x"].to(dev),
             "labels": data["train_y"].to(dev)}
    multi = engine.make_multi_round(strat.spec, fl, strat.fabric,
                                    chunk_rounds=rounds)

    def per_round(state):
        for r in range(rounds):
            state, _ = strat.round(state, train, (0, r))
        return state

    _, seq = count_syncs(lambda: per_round(strat.init(0)))
    state0 = strat.init(0)
    _, chunk = count_syncs(lambda: multi(state0, train, 0, 0))
    state0 = strat.init(0)
    _, seq_only = count_syncs(lambda: per_round(state0))
    runs = {}
    for c in (1, rounds):
        _, runs[c] = count_syncs(lambda c=c: run_experiment(
            name, cfg, fl, data, num_rounds=rounds, eval_every=rounds,
            steps_per_epoch=2, seed=0, verbose=False, device=dev,
            chunk_rounds=c))
    if len(chunk) > len(seq_only) or len(runs[rounds]) > len(runs[1]):
        raise AssertionError(
            f"{name}: the chunk adds host syncs: {len(chunk)} in a chunk "
            f"of {rounds} against {len(seq_only)} in {rounds} rounds; "
            f"runs {len(runs[rounds])} chunked against {len(runs[1])}")
    return dict(name=name, rounds=rounds,
                rounds_syncs=len(seq_only), chunk_syncs=len(chunk),
                per_round_syncs=len(seq_only) / rounds,
                run_syncs={"per_round": len(runs[1]),
                           "chunked": len(runs[rounds])},
                where=dict(Counter(seq_only).most_common()),
                where_chunk_only=sorted(set(chunk) - set(seq_only)),
                where_with_init=len(seq))


def driver_phase(cfg, fl, data, dev, ops, phase3_walls) -> dict:
    """Phase 9 (module docstring); prints its rows and returns the launch
    counts of each kernel in the driver runs."""
    from repro_torch.configs import CommsConfig
    from repro_torch.examples import quickstart

    own = run_cli_own_lr()
    print("driver cli at its own lr", json.dumps(own), flush=True)
    cli = run_cli(ops, phase3_walls)
    print("driver cli", json.dumps(cli), flush=True)
    for name, row in cli["runs"].items():
        steady, phase3 = row["steady_round_s"], row["phase3_steady_round_s"]
        print(f"driver cli {name}: steady round {steady:.4f} s (second "
              f"chunk, per round), phase 3's {phase3:.4f} s per round",
              flush=True)
    fl_ring = dataclasses.replace(fl, comms=CommsConfig(**FABRIC_NET),
                                  lr=BASELINE_LR)
    parity = [check_chunk_parity("pfeddst", cfg, fl, data, 4, dev, ops,
                                 "select_topk"),
              check_chunk_parity("dfedavgm", cfg, fl_ring, data, 2, dev, ops,
                                 "gossip_mix")]
    for row in parity:
        print("driver chunk parity", json.dumps(row), flush=True)
    syncs = [check_syncs("pfeddst", cfg, fl, data, dev),
             check_syncs("dfedpgp", cfg,
                         dataclasses.replace(fl, lr=BASELINE_LR), data, dev)]
    for row in syncs:
        print("driver host syncs", json.dumps(row), flush=True)
    t0 = time.perf_counter()
    quick = quickstart.main([])
    mask = quick["metrics"]["select_mask"]
    if not (math.isfinite(quick["accuracy"]) and mask.is_cuda
            and tuple(mask.shape) == (6, 6)):
        raise AssertionError(f"quickstart: accuracy {quick['accuracy']}, "
                             f"select_mask {tuple(mask.shape)} on "
                             f"{mask.device}")
    print("driver quickstart", json.dumps(
        {"accuracy": quick["accuracy"],
         "wall_s": time.perf_counter() - t0}), flush=True)
    cost = chunk_cost("pfeddst", cfg, fl, data, dev)
    print("driver chunk cost", json.dumps(cost), flush=True)
    for key in ("median_run_s_per_round", "median_rounds_s_per_round"):
        per_round, chunked = (cost[key]["per_round"], cost[key]["chunked"])
        print(f"driver chunk cost {key}: per round {per_round:.4f} s, "
              f"chunked {chunked:.4f} s ({chunked / per_round:.3f}x)",
              flush=True)
    print(f"driver chunk cost pair ratios (chunked / per round, rounds' "
          f"wall): {[round(r, 3) for r in cost['pair_ratios']]}, median "
          f"{cost['median_pair_ratio']:.3f}", flush=True)
    return {
        "select_topk": {"chunk_parity_chunked": parity[0][
            "launches_chunked"], "chunk_parity_per_round": parity[0][
            "launches_per_round"]},
        "gossip_mix": {"cli_dfedpgp": cli["runs"]["dfedpgp"]["launches"][
            "gossip_mix"], "chunk_parity_ring_chunked": parity[1][
            "launches_chunked"], "chunk_parity_ring_per_round": parity[1][
            "launches_per_round"]},
        "mask_evolve": {"cli_dispfl": cli["runs"]["dispfl"]["launches"][
            "mask_evolve"], "cli_dispfl_leaves": cli["runs"]["dispfl"][
            "launches"]["leaves"]},
    }


# ---------------------------------------------------------------------------
# phase 10: the hybrid family's recurrence and prefill
# ---------------------------------------------------------------------------

def check_lru_scan(dev):
    """`rglru.rg_lru_scan` at recurrentgemma-2b's full width (B=4, S=4096,
    W=2560, f32; a rec block's f32 weights and x ~ N(0, 1) from a seed)
    against h_t = a_t·h_{t−1} + b_t run step by step in f64 on the card
    from the scan's own (a, b) (`rglru.scan_inputs`): h and the last h
    within 1e-5·max(1, max|h|) (the CPU measures 5e-7 of the scale at
    B=1). The scan's time and its doubling part's, by CUDA events."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import rglru

    cfg = dataclasses.replace(get_config("recurrentgemma-2b"),
                              dtype="float32")
    g = torch.Generator(device=dev).manual_seed(11)
    p = rglru.init_rglru_block(g, cfg, dev)
    x = torch.randn((SERVE_BATCH, SERVE_PROMPT, cfg.lru_width), generator=g,
                    device=dev)
    h, last = rglru.rg_lru_scan(p, x)
    a, b = rglru.scan_inputs(p, x)
    a64, b64 = a.double(), b.double()
    want = torch.empty_like(b64)
    hh = torch.zeros_like(b64[:, 0])
    for t in range(b64.shape[1]):
        hh = a64[:, t] * hh + b64[:, t]
        want[:, t] = hh
    torch.cuda.synchronize()
    scale = max(1.0, float(want.abs().max()))
    err = float((h.double() - want).abs().max())
    last_err = float((last.double() - want[:, -1]).abs().max())
    if not (err <= 1e-5 * scale and last_err <= 1e-5 * scale):
        raise AssertionError(f"rg_lru_scan: error {err} (last {last_err}) "
                             f"against the f64 recurrence, scale {scale}")
    del a64, b64, want, hh
    ms = time_ms(lambda: rglru.rg_lru_scan(p, x), 5, warmup=1)
    scan_ms = time_ms(lambda: rglru.linear_scan(a, b), 5, warmup=1)
    return dict(shape=list(x.shape), max_abs_err=err, last_err=last_err,
                scale=scale, rel_err=err / scale, ms=ms,
                doubling_steps=math.ceil(math.log2(x.shape[1])),
                linear_scan_ms=scan_ms)


def _is_gemm(key: str) -> bool:
    """A cuBLAS GEMM kernel: `...gemm...`, or the `nvjet_...` kernels it
    takes for bf16 on the H100."""
    return "gemm" in key.lower() or key.startswith("nvjet")


def _is_f32_gemm(key: str) -> bool:
    """cuBLAS's f32 GEMM kernels without TF32 (`sgemm`, `f32f32_f32f32`)."""
    return "sgemm" in key or "f32f32_f32f32" in key


def profile_hybrid_prefill(dev, ops):
    """One steady recurrentgemma-2b prefill (bf16, full width and depth,
    B=4, S=4096) under torch.profiler, after a warm-up one: wall, device
    kernel time, the device's idle share, flash_attention's share (its 8
    launches, counted), the f32 GEMMs' share (the RG-LRU gates: two W×W
    products per rec layer, 36 in all), the 16-bit GEMMs' and the
    concatenations' (the doubling scan's `torch.cat`); the f32 gate GEMMs
    once more by CUDA events at their shape. The top kernels
    go to chiprun_out/chip_smoke_hybrid_prefill_profile.txt."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import make_serving_fns
    from repro_torch.models import model as model_mod

    cfg = get_config("recurrentgemma-2b")
    params = model_mod.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    prompts = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT),
                            generator=torch.Generator(device=dev).manual_seed(
                                5), device=dev, dtype=torch.int32)
    prefill_fn, _ = make_serving_fns(cfg, prompt_len=SERVE_PROMPT,
                                     gen_tokens=SERVE_GEN)
    prefill_fn(params, prompts)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prefill_fn(params, prompts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    n_flash = ops.launch_counts()["flash_attention"]
    if n_flash != prefill_launches(cfg):
        raise AssertionError(f"recurrentgemma-2b prefill: {n_flash} flash "
                             f"launches, expected {prefill_launches(cfg)}")
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in events)

    def share(pred):
        return sum(e.self_device_time_total for e in events if pred(e.key))

    flash_us = share(lambda k: "flash_" in k)
    gemm32_us = share(lambda k: _is_gemm(k) and _is_f32_gemm(k))
    gemm16_us = share(lambda k: _is_gemm(k) and not _is_f32_gemm(k))
    cat_us = share(lambda k: "CatArrayBatchedCopy" in k)
    n_rec = cfg.block_pattern.count("rec")
    xf = torch.randn((SERVE_BATCH * SERVE_PROMPT, cfg.lru_width),
                     device=dev)
    wf = torch.randn((cfg.lru_width, cfg.lru_width), device=dev)
    gate_ms = time_ms(lambda: xf @ wf, 10)
    del params, xf, wf
    torch.cuda.empty_cache()
    top = sorted(events, key=lambda e: e.self_device_time_total,
                 reverse=True)[:16]
    lines = [f"{e.self_device_time_total / 1e3:10.3f} ms {e.count:6d}x  "
             f"{e.key[:110]}" for e in top]
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke_hybrid_prefill_profile.txt").write_text(
        f"{card_line()}\n{cfg.name} prefill B={SERVE_BATCH} "
        f"S={SERVE_PROMPT}: wall {wall:.4f} s, device {dev_us / 1e6:.4f} s, "
        f"flash {flash_us / 1e6:.4f} s, f32 GEMMs {gemm32_us / 1e6:.4f} s, "
        f"16-bit GEMMs {gemm16_us / 1e6:.4f} s\n" + "\n".join(lines) + "\n")
    return dict(wall_s=wall, device_s=dev_us / 1e6,
                idle_share=1.0 - dev_us / 1e6 / wall,
                flash_launches=n_flash, flash_device_s=flash_us / 1e6,
                flash_share=flash_us / dev_us,
                gemm_f32_device_s=gemm32_us / 1e6,
                gemm_f32_share=gemm32_us / dev_us,
                gemm_16bit_device_s=gemm16_us / 1e6,
                gemm_16bit_share=gemm16_us / dev_us,
                cat_device_s=cat_us / 1e6, cat_share=cat_us / dev_us,
                gate_gemm_event_s=2 * n_rec * gate_ms / 1e3,
                gate_gemm_tflops=2.0 * SERVE_BATCH * SERVE_PROMPT
                * cfg.lru_width ** 2 / gate_ms / 1e9,
                top=[(e.key[:60], e.self_device_time_total / 1e3, e.count)
                     for e in top[:8]])


# ---------------------------------------------------------------------------
# phase 11: the MoE layer at full width
# ---------------------------------------------------------------------------

def _drop_share(route) -> float:
    """The share of a layer's (token, k) assignments dropped, from its
    `moe.recording_routes` entry."""
    return 1.0 - float(route[1].float().mean())


def profile_moe_prefill(cfg, params, prompts, dev, ops):
    """One steady prefill of `prompts` (phi3.5-moe at its served depth)
    under torch.profiler: wall, device kernel time and idle share; the
    shares of the expert GEMMs (the `moe:experts` ranges), of routing,
    dispatch and combine (the
    `moe:route`, `moe:dispatch`, `moe:combine` ranges: router GEMM,
    softmax, sort, one-hot, cumsum, slot scatter and the gathers), of
    flash_attention (its launches, counted) and of lm_head (its GEMM at
    this shape by CUDA events). The table goes to
    chiprun_out/chip_smoke_moe_prefill_profile.txt."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.serve import make_serving_fns

    prefill_fn, _ = make_serving_fns(cfg, prompt_len=SERVE_PROMPT,
                                     gen_tokens=SERVE_GEN)
    prefill_fn(params, prompts)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prefill_fn(params, prompts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    n_flash = ops.launch_counts()["flash_attention"]
    if n_flash != cfg.num_layers:
        raise AssertionError(f"{cfg.name} prefill: {n_flash} flash launches, "
                             f"expected {cfg.num_layers}")
    avg = prof.key_averages()
    on_device = [e for e in avg if e.device_type == DeviceType.CUDA]
    # the device time of the kernels launched inside each moe: range (its
    # host row)
    ranges = {e.key: getattr(e, "device_time_total", 0) for e in avg
              if e.key.startswith("moe:")
              and e.device_type == DeviceType.CPU}
    kernels = [e for e in on_device if not e.key.startswith(("moe:",
                                                             "stage:"))]
    dev_us = sum(e.self_device_time_total for e in kernels)

    def share(pred):
        return sum(e.self_device_time_total for e in kernels if pred(e.key))

    flash_us = share(lambda k: "flash_" in k)
    gemm_us = share(_is_gemm)
    x = torch.randn((SERVE_BATCH * SERVE_PROMPT, cfg.d_model), device=dev,
                    dtype=params["lm_head"].dtype)
    lm_head_ms = time_ms(lambda: x @ params["lm_head"], 5)
    del x
    dispatch_us = sum(ranges.get(f"moe:{n}", 0)
                      for n in ("route", "dispatch", "combine"))
    top = sorted(kernels, key=lambda e: e.self_device_time_total,
                 reverse=True)[:20]
    lines = [f"{e.self_device_time_total / 1e3:10.3f} ms {e.count:6d}x  "
             f"{e.key[:110]}" for e in top]
    lines += [f"{us / 1e3:10.3f} ms  range {key}"
              for key, us in sorted(ranges.items())]
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke_moe_prefill_profile.txt").write_text(
        f"{card_line()}\n{cfg.name} ({cfg.num_layers} layers) prefill "
        f"B={SERVE_BATCH} S={SERVE_PROMPT}: wall {wall:.4f} s, device "
        f"{dev_us / 1e6:.4f} s, lm_head "
        f"{lm_head_ms:.3f} ms (CUDA events)\n" + "\n".join(lines) + "\n")
    return dict(wall_s=wall, device_s=dev_us / 1e6,
                idle_share=1.0 - dev_us / 1e6 / wall,
                expert_gemm_device_s=ranges.get("moe:experts", 0) / 1e6,
                expert_gemm_share=ranges.get("moe:experts", 0) / dev_us,
                dispatch_combine_device_s=dispatch_us / 1e6,
                dispatch_combine_share=dispatch_us / dev_us,
                ranges_s={k: v / 1e6 for k, v in ranges.items()},
                gemm_share=gemm_us / dev_us,
                flash_launches=n_flash, flash_device_s=flash_us / 1e6,
                flash_share=flash_us / dev_us,
                lm_head_event_s=lm_head_ms / 1e3,
                lm_head_share=lm_head_ms / 1e3 / (dev_us / 1e6),
                top=[(e.key[:60], e.self_device_time_total / 1e3, e.count)
                     for e in top[:8]])


def moe_phase(dev, ops) -> dict:
    """For phi3.5-moe and deepseek-v3 at their served depths (bf16, full
    width, B=4, S=4096): (b) the share of each layer's real assignments
    the prefill drops, read in a warm-up prefill; (a) two more identical
    prefills give bitwise-equal logits (the combine sums in a fixed
    order); (c) for phi3.5-moe one more prefill profiled
    (`profile_moe_prefill`). Each model is freed before the next."""
    import torch

    from repro_torch.launch.serve import serving_batch
    from repro_torch.models import model as model_mod
    from repro_torch.models import moe as moe_mod

    out = {}
    for arch in MOE_ARCHS:
        cfg = serve_config(arch)
        params = model_mod.init_params(
            cfg, torch.Generator(device=dev).manual_seed(0), dev)
        prompts = torch.randint(
            0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT), device=dev,
            generator=torch.Generator(device=dev).manual_seed(11),
            dtype=torch.int32)

        def prefill():
            return model_mod.prefill(cfg, params,
                                     serving_batch(cfg, prompts),
                                     max_seq=SERVE_PROMPT + SERVE_GEN)[0]

        with moe_mod.recording_routes() as routes:
            prefill()
        drops = [_drop_share(r) for r in routes]
        del routes
        first = prefill()
        second = prefill()
        if not torch.equal(first, second):
            raise AssertionError(f"{arch}: two identical prefills differ by "
                                 f"{float((first - second).abs().max())}")
        del first, second
        row = dict(layers=cfg.num_layers, repeat_bitwise=True,
                   drop_share_per_layer=drops)
        print(f"moe {arch}: prefills bitwise equal; dropped share per "
              f"layer {[round(d, 4) for d in drops]}", flush=True)
        if arch == "phi3.5-moe-42b-a6.6b":
            row["profile"] = profile_moe_prefill(cfg, params, prompts, dev,
                                                 ops)
        del params
        torch.cuda.empty_cache()
        out[arch] = row
    return out


# ---------------------------------------------------------------------------
# phase 12: federated LLM training
# ---------------------------------------------------------------------------

# (a): PFedDST and three baselines over qwen2-1.5b at full width and depth
# (bf16), examples/federated_llm.py's settings with M cut from 6 to 4 (the
# population state is 10.7 GB a client: bf16 parameters, f32 momenta)
LLM_ARCH = "qwen2-1.5b"
LLM_FL = dict(num_clients=4, peers_per_round=2, batch_size=8,
              client_sample_ratio=1.0, lr=0.05, probe_size=4,
              use_score_kernel=True)
LLM_SEQ, LLM_SEQS, LLM_DOMAINS, LLM_ROUNDS = 64, 64, 2, 2
# each strategy, the kernel its round reaches (select_topk and raw_gram
# once a round, mask_evolve one call over every leaf, gossip_mix once a
# column block of the packed extractor) and its FLConfig changes: a
# gossip plan is packed for gossip_mix only when its degree bound D =
# k + 1 is at most M / 2 (the reference's rule), so at M = 4 dfedpgp
# picks k = 1 peer (at k = 2 both packages mix dense)
LLM_PATHS = (("pfeddst", "select_topk", {}),
             ("pfeddst_random", "raw_gram", {}),
             ("dfedpgp", "gossip_mix", {"peers_per_round": 1}),
             ("dispfl", "mask_evolve", {}))
# (c): one remat pair step a family at full width, its depth cut where the
# functional step's memory (`pair_step_gb`) would pass ~60 GB of the 80;
# deepseek-v3 is left out at full width: one layer's 256 experts hold
# 11.3e9 parameters, 90 GB with their gradients and f32 momenta
TRAIN_DEPTHS = {"rwkv6-7b": 10, "phi3.5-moe-42b-a6.6b": 2,
                "internvl2-76b": 2}
TRAIN_ARCHS = ("rwkv6-7b", "recurrentgemma-2b", "whisper-base",
               "phi3.5-moe-42b-a6.6b", "internvl2-76b")
TRAIN_BATCH, TRAIN_SEQ = 8, 64
# (b): launch/train.py at (a)'s settings (its FLConfig keeps the default
# probe_size and use_score_kernel=False)
TRAIN_CLI_ARGV = ["--arch", LLM_ARCH, "--strategy", "pfeddst",
                  "--clients", "4", "--peers", "2", "--batch-size", "8",
                  "--sample-ratio", "1.0", "--lr", "0.05",
                  "--steps-per-epoch", "1", "--seq-len", str(LLM_SEQ),
                  "--rounds", str(LLM_ROUNDS), "--eval-every", "1"]


def train_config(arch):
    """`arch`'s config at full width, its depth cut to TRAIN_DEPTHS (a
    hybrid's block pattern cut with it)."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    if arch in TRAIN_DEPTHS:
        cfg = dataclasses.replace(cfg, num_layers=TRAIN_DEPTHS[arch])
        if cfg.block_pattern:
            cfg = dataclasses.replace(
                cfg, block_pattern=cfg.block_pattern[:cfg.num_layers])
    return cfg


def pair_step_gb(n_e: int, n_h: int) -> float:
    """Predicted peak GB of a functional pair step (its phase e): bf16
    parameters and f32 SGD momenta of both partitions, and for the
    extractor its gradient (2 B), new momentum (4 B), f32 update (4 B)
    and new values (2 B)."""
    return (6 * (n_e + n_h) + 12 * n_e) / 1e9


def llm_batch(cfg, tokens, dev):
    """A training batch of `cfg`'s family: the tokens, internvl2's
    `num_prefix_tokens` prefix rows (read through vision_proj), whisper's
    encoder frames."""
    import torch

    g = torch.Generator(device=dev).manual_seed(5)
    batch = {"tokens": tokens}
    dt = getattr(torch, cfg.dtype)
    if cfg.family == "vlm":
        batch["prefix_embeds"] = torch.randn(
            (tokens.shape[0], cfg.num_prefix_tokens, cfg.d_model),
            generator=g, device=dev).to(dt)
    if cfg.family == "audio":
        batch["frames"] = torch.randn(
            (tokens.shape[0], cfg.encoder_seq, cfg.d_model), generator=g,
            device=dev).to(dt)
    return batch


class KernelCheck:
    """Patches one `kernels.ops` entry point for a path's run. The real
    call is made (and counted by the kernel's wrapper); the first call's
    inputs (for mask_evolve, which writes in place, its largest leaf and
    grow plane) are copied with its result, and `check()` then holds that
    result to the plain version on the copies, outside the run."""

    def __init__(self, ops, name):
        self.ops, self.name, self.seen = ops, name, None
        self.real = getattr(ops, name)

    def __enter__(self):
        import torch

        real = self.real

        def wrapped(*args, **kw):
            if self.seen is not None:
                return real(*args, **kw)
            if self.name == "mask_evolve_leaves":
                leaves, grows, keeps = args[:3]
                big = max(range(len(leaves)),
                          key=lambda i: leaves[i].numel())
                saved = (leaves[big].clone(), grows[big].clone(),
                         keeps[big])
                out = real(*args, **kw)
                self.seen = (saved, (out[big][0].clone(),
                                     out[big][1].clone()))
                return out
            saved = tuple(a.clone() if isinstance(a, torch.Tensor) else a
                          for a in args)
            out = real(*args, **kw)
            self.seen = (saved, dict(kw), out.clone()
                         if isinstance(out, torch.Tensor)
                         else tuple(o.clone() for o in out))
            return out

        setattr(self.ops, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.ops, self.name, self.real)

    def check(self) -> dict:
        import torch

        from repro_torch.core.selection import topk_to_mask
        from repro_torch.kernels import mask_evolve as me

        if self.seen is None:
            raise AssertionError(f"{self.name} was not called on the path")
        if self.name == "mask_evolve_leaves":
            (x, grow, keep), (out, mask) = self.seen
            p_out, p_mask, _ = me.mask_evolve_plain(x, grow, keep=keep)
            bits = torch.int16 if x.dtype == torch.bfloat16 else torch.int32
            if not (torch.equal(mask, p_mask)
                    and torch.equal(out.view(bits), p_out.view(bits))):
                raise AssertionError("mask_evolve on the LLM path differs "
                                     "from the plain version")
            self.seen = None
            return dict(leaf=list(x.shape), dtype=str(x.dtype).split(".")[-1],
                        bitwise=True)
        args, kw, out = self.seen
        self.seen = None
        kw = {k: v for k, v in kw.items() if k != "impl"}
        plain = self.real(*args, impl="plain", **kw)
        if self.name == "select_topk":
            m = args[0].shape[0]
            if not torch.equal(topk_to_mask(out[1], out[0], m),
                               topk_to_mask(plain[1], plain[0], m)):
                raise AssertionError("select_topk's mask on the LLM path "
                                     "differs from the plain version's")
            return dict(shape=list(args[0].shape), mask_equal=True,
                        max_abs_err=float((out[0] - plain[0]).abs().max()),
                        plan=list(self.ops.KERNELS["select_topk"].last_plan))
        if self.name == "gossip_mix":
            if not torch.equal(out.view(torch.int32),
                               plain.view(torch.int32)):
                raise AssertionError("gossip_mix on the LLM path differs "
                                     "from the plain version (bitwise)")
            return dict(shape=list(args[0].shape), bitwise=True)
        # raw_gram: P-term f32 sums at P = 2.3e8, held as in
        # llm_kernel_cells
        err = float((out - plain).abs().max())
        scale = float(plain.abs().max())
        if not err <= 1e-3 * scale:
            raise AssertionError(f"raw_gram on the LLM path: error {err} > "
                                 f"1e-3 × {scale}")
        return dict(shape=list(args[0].shape), max_abs_err=err,
                    rel_err=err / scale,
                    plan=list(self.ops.KERNELS["raw_gram"].last_plan))


def llm_data(cfg):
    """synth_tokens over LLM_DOMAINS domains, cut as launch/train.py's
    build_data cuts it (the first n // 5 sequences are the test split)."""
    from repro_torch.data.synthetic import synth_tokens

    tokens, _ = synth_tokens(0, LLM_FL["num_clients"], cfg.vocab_size,
                             LLM_SEQ, seqs_per_client=LLM_SEQS,
                             num_domains=LLM_DOMAINS)
    n_te = max(1, LLM_SEQS // 5)
    return {"train_x": tokens[:, n_te:], "train_y": tokens[:, n_te:, 0] * 0,
            "test_x": tokens[:, :n_te], "test_y": tokens[:, :n_te, 0] * 0}


def run_llm_path(name, kernel, changes, cfg, data, dev, ops):
    """(a) one strategy over qwen2-1.5b: LLM_ROUNDS rounds through
    `run_experiment`, eval every round, the launch counters set to 0 just
    before and read just after; the kernel's first call held to its plain
    version (`KernelCheck`)."""
    import torch

    from repro_torch.configs import FLConfig
    from repro_torch.fl.simulator import run_experiment

    fl = FLConfig(**{**LLM_FL, **changes})
    hook = "mask_evolve_leaves" if kernel == "mask_evolve" else kernel
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with KernelCheck(ops, hook) as probe:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        hist = run_experiment(name, cfg, fl, data, num_rounds=LLM_ROUNDS,
                              eval_every=1, steps_per_epoch=1, seed=0,
                              verbose=False, device=dev)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    h = hist.to_dict()
    if not all(math.isfinite(v) for v in h["train_loss"] + h["accuracy"]):
        raise AssertionError(f"llm {name}: losses {h['train_loss']}, "
                             f"accuracy {h['accuracy']}")
    if launches[kernel] < LLM_ROUNDS:
        raise AssertionError(f"llm {name}: {kernel} launched "
                             f"{launches[kernel]} times in {LLM_ROUNDS} "
                             "rounds")
    checked = probe.check()
    row = dict(name=name, kernel=kernel, changes=changes, rounds=LLM_ROUNDS,
               accuracy=h["accuracy"], train_loss=h["train_loss"],
               first_round_s=h["compile_s"], steady_round_s=h["wall_s"][-1],
               run_s=total, peak_gb=peak / 1e9, base_gb=base / 1e9,
               launches={k: v for k, v in launches.items() if v},
               launches_text=f"{launches[kernel]} in {LLM_ROUNDS}",
               kernel_check=checked)
    print(f"llm {name}: steady round {row['steady_round_s']:.3f} s, peak "
          f"{row['peak_gb']:.2f} GB, {kernel} {row['launches_text']} "
          f"rounds, losses {h['train_loss']}", flush=True)
    return row


def run_train_cli(ops) -> dict:
    """(b) launch/train.py's main on TRAIN_CLI_ARGV in this process (the
    launch counters set to 0 around it): its final-accuracy line, finite
    losses."""
    import io
    from contextlib import redirect_stdout

    import torch

    from repro_torch.launch import train

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with redirect_stdout(buf):
        record = train.main(TRAIN_CLI_ARGV)
    total = time.perf_counter() - t0
    text = buf.getvalue()
    last = text.strip().splitlines()[-1]
    print("cli:", last, flush=True)
    if not last.startswith("final personalized accuracy:") or not all(
            math.isfinite(v) for v in record["train_loss"]
            + record["accuracy"]):
        raise AssertionError(f"launch.train: {text[-400:]}")
    row = dict(argv=TRAIN_CLI_ARGV, last_line=last, total_s=total,
               accuracy=record["accuracy"], train_loss=record["train_loss"],
               steady_round_s=record["wall_s"][-1],
               peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               launches={k: v for k, v in ops.launch_counts().items() if v})
    torch.cuda.empty_cache()
    return row


def run_pair_step(arch, dev) -> dict:
    """(c) one `make_train_pair_step(..., remat=True)` step (phase e, then
    phase h; SGD at (a)'s lr) of `arch` at full width and its
    TRAIN_DEPTHS depth, bf16, batch 8 × 64 tokens."""
    import torch

    from repro_torch.configs import FLConfig
    from repro_torch.launch.steps import make_train_pair_step
    from repro_torch.models import model as model_mod
    from repro_torch.models.split import split_params
    from repro_torch.optim.sgd import sgd
    from repro_torch.utils.pytree import tree_size

    cfg = train_config(arch)
    fl = FLConfig(**LLM_FL)
    opt = sgd(fl.lr, momentum=fl.momentum, weight_decay=fl.weight_decay)
    torch.cuda.empty_cache()
    e, h = split_params(cfg, model_mod.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev))
    n_e, n_h = tree_size(e), tree_size(h)
    oe, oh = opt.init(e), opt.init(h)
    tokens = torch.randint(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ), device=dev,
        dtype=torch.int32,
        generator=torch.Generator(device=dev).manual_seed(3))
    batch = llm_batch(cfg, tokens, dev)
    step = make_train_pair_step(cfg, opt, opt, remat=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    e2, h2, _, _, met = step(e, h, oe, oh, batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    losses = {k: float(v) for k, v in met.items()}
    if not all(math.isfinite(v) for v in losses.values()):
        raise AssertionError(f"pair step {arch}: losses {losses}")
    row = dict(arch=arch, layers=cfg.num_layers, params=n_e + n_h,
               extractor=n_e, header=n_h, losses=losses, wall_s=wall,
               predicted_gb=pair_step_gb(n_e, n_h), peak_gb=peak)
    print(f"pair step {arch} ({cfg.num_layers} layers, "
          f"{(n_e + n_h) / 1e9:.3f}e9 params): losses {losses}, "
          f"{wall:.2f} s, peak {peak:.1f} GB (predicted "
          f"{row['predicted_gb']:.1f})", flush=True)
    del e, h, oe, oh, e2, h2, batch
    torch.cuda.empty_cache()
    return row


def check_train_agreement(dev) -> dict:
    """(d) every family's reduced config in f32: loss_fn's total and
    metrics and every parameter's gradient on the card against the CPU's,
    from the same CPU-drawn parameters and batch (rwkv6 by the recurrence
    and by `wkv_chunked_torch`): the loss within 1e-5 relative, each
    gradient within 1e-4 of its scale."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import model as model_mod
    from repro_torch.utils.pytree import tree_leaves, tree_map

    out = {}
    for arch in AGREE_ARCHS:
        cfg = dataclasses.replace(get_config(arch).reduced(),
                                  dtype="float32")
        params = model_mod.init_params(cfg, torch.Generator().manual_seed(0),
                                       "cpu")
        g = torch.Generator().manual_seed(1)
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 24),
                                         generator=g)}
        if cfg.family == "vlm":
            batch["prefix_embeds"] = torch.randn((2, 3, cfg.d_model),
                                                 generator=g)
        if cfg.family == "audio":
            batch["frames"] = torch.randn((2, cfg.encoder_seq, cfg.d_model),
                                          generator=g)
        for backend in (("auto", "chunked") if cfg.family == "ssm"
                        else ("auto",)):
            res = []
            for device in ("cpu", dev):
                p = tree_map(lambda t: t.to(device).requires_grad_(True),
                             params)
                b = {k: v.to(device) for k, v in batch.items()}
                total, met = model_mod.loss_fn(cfg, p, b, backend=backend)
                grads = torch.autograd.grad(total, tree_leaves(p),
                                            allow_unused=True,
                                            materialize_grads=True)
                res.append((float(total),
                            {k: float(v) for k, v in met.items()},
                            [x.detach().cpu() for x in grads]))
            (lc, mc, gc), (lg, mg, gg) = res
            rel = abs(lc - lg) / max(1.0, abs(lc))
            grad_err = max(float((a - b).abs().max())
                           / max(1.0, float(b.abs().max()))
                           for a, b in zip(gg, gc))
            if rel > 1e-5 or grad_err > 1e-4 or any(
                    abs(mc[k] - mg[k]) > 1e-5 * max(1.0, abs(mc[k]))
                    for k in mc):
                raise AssertionError(f"train agreement {arch} {backend}: "
                                     f"loss {lg} vs {lc}, grads {grad_err}")
            out[f"{arch}/{backend}"] = dict(loss_rel_err=rel,
                                            grad_err_of_scale=grad_err)
    return out


def llm_kernel_cells(ops, ref, me, dev, cfg) -> dict:
    """The four kernels on (a)'s path at its shapes, against their plain
    versions, timed beside them and the library call: select_topk (the
    default fabric's cost matrix and candidate mask) and raw_gram on the
    (4, P) f32 headers, gossip_mix on one column block of the packed
    extractor (dfedpgp's directed plan at k = 1, D = 2), mask_evolve on the
    largest stacked leaf (the embedding, 4 × 152064 × 1536 bf16)."""
    import torch

    from repro_torch.fl.engine import F32_BLOCK_COLUMNS

    m = LLM_FL["num_clients"]
    p = cfg.d_model * cfg.padded_vocab + cfg.d_model   # lm_head + norm
    k = LLM_FL["peers_per_round"]
    cells = {}
    # the row statistics are sums of f32 cosines over P = 2.3e8 terms:
    # held within 1e-3 relative, and each route's error against float64
    # reported
    cells["select_topk"] = check_select(ops, ref, select_case(
        m, p, k, matrix_cost=True, cand=True, seed=21, dev=dev), k, 5,
        stats_rtol=1e-3, f64=True)
    torch.cuda.empty_cache()
    cells["raw_gram"] = check_gram(ops, m, p, 22, dev, 5, rtol=1e-3,
                                   f64=True)
    torch.cuda.empty_cache()
    cells["gossip_mix"] = check_gossip(ops, ref, gossip_case(
        m, F32_BLOCK_COLUMNS, 1, m, 23, dev), 10, 2)
    torch.cuda.empty_cache()
    cells["mask_evolve"] = check_evolve(
        me, (m, cfg.padded_vocab, cfg.d_model), torch.bfloat16, 24, dev, 5,
        lib_iters=1)
    torch.cuda.empty_cache()
    for name, row in cells.items():
        print(f"llm shape {name}", json.dumps(row), flush=True)
    return cells


def llm_train_phase(dev, ops, ref, me) -> dict:
    """Phase 12: (a) the four strategies over qwen2-1.5b, (b) the training
    CLI, (c) one pair step a family, (d) card = CPU, then the kernels at
    the LLM path's shapes."""
    cfg = train_config(LLM_ARCH)
    data = llm_data(cfg)
    paths = [run_llm_path(name, kernel, changes, cfg, data, dev, ops)
             for name, kernel, changes in LLM_PATHS]
    cli = run_train_cli(ops)
    steps = [run_pair_step(arch, dev) for arch in TRAIN_ARCHS]
    agree = check_train_agreement(dev)
    print("agree: training loss and gradients, card against CPU",
          json.dumps(agree), flush=True)
    cells = llm_kernel_cells(ops, ref, me, dev, cfg)
    return dict(cells=cells, paths=paths, cli=cli, pair_steps=steps,
                agree=agree)


# ---------------------------------------------------------------------------
# phase 13: the serve_demo twin and the one-card dry run against the card
# ---------------------------------------------------------------------------

# (b): the dry run's cells that fit one card: (name, arch, seq, batch, kind)
DRY_CELLS = (("prefill_4x4096", "qwen2-1.5b", 4096, 4, "prefill"),
             ("train_8x64", "qwen2-1.5b", LLM_SEQ, TRAIN_BATCH, "train"))


def _first_difference(a, b):
    """(row, generated position) of the first greedy token where two
    (B, S + gen) token tensors differ, or None."""
    diff = (a != b).nonzero()
    if not len(diff):
        return None
    row, pos = (int(x) for x in diff[0])
    return [row, pos - SERVE_DEMO_PROMPT]


SERVE_DEMO_PROMPT = 16       # the serve_demo twin's default --prompt-len


def check_serve_demo(ops) -> dict:
    """(a) the serve_demo twin with its defaults (bf16) on the card, its
    launches counted alone, and on the CPU; then both again in float32,
    where the greedy tokens must be equal (bf16 tokens may part: the
    card's kernels and GEMMs round otherwise than the CPU's plain
    versions; where they do is reported)."""
    import torch

    from repro_torch.examples import serve_demo

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    card = serve_demo.main([])
    card_s = time.perf_counter() - t0
    launches = {k: ops.launch_counts()[k]
                for k in ("flash_attention", "wkv_chunked")}
    if not all(launches.values()):
        raise AssertionError(f"serve_demo: a serving kernel never launched: "
                             f"{launches}")
    cpu = serve_demo.main(["--device", "cpu"])
    bf16_first_difference = {a: _first_difference(t, cpu[a])
                             for a, t in card.items()}
    card32 = serve_demo.main(["--dtype", "float32"])
    cpu32 = serve_demo.main(["--device", "cpu", "--dtype", "float32"])
    for arch, toks in card32.items():
        if not torch.equal(toks, cpu32[arch]):
            raise AssertionError(f"serve_demo {arch} (float32): greedy "
                                 "tokens differ between card and CPU: "
                                 f"{toks.tolist()} vs "
                                 f"{cpu32[arch].tolist()}")
    return dict(archs=list(card), launches=launches, card_s=card_s,
                bf16_first_difference=bf16_first_difference)


def check_dryrun_cell(name, arch, seq, batch, kind, dev) -> dict:
    """(b) one dry-run cell: the meta trace's record, then the same step
    on real inputs on the card (built by `dryrun.build` from a seed):
    argument bytes equal, the steady wall (the least of two runs after a
    first) at least the roofline time, the peaks side by side."""
    import torch

    from repro_torch.configs import InputShape, get_config
    from repro_torch.launch import dryrun

    cfg = get_config(arch)
    shape = InputShape(name, seq, batch, kind)
    rec = dryrun.run_combo(arch, name, False, verbose=False, cfg=cfg,
                           shape=shape)
    if rec["status"] != "ok":
        raise AssertionError(f"dry run {arch} {name}: {rec}")
    torch.cuda.empty_cache()
    fn, args = dryrun.build(cfg, shape, False, device=dev, seed=0)
    real_bytes = dryrun.storage_bytes(args)
    if real_bytes != rec["argument_size_in_bytes"]:
        raise AssertionError(f"dry run {arch} {name}: argument bytes "
                             f"{rec['argument_size_in_bytes']} against the "
                             f"real inputs' {real_bytes}")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        del out
    peak_above = torch.cuda.max_memory_allocated() - base
    del args
    torch.cuda.empty_cache()
    steady = min(walls[1:])
    roof = max(rec["t_compute_s"], rec["t_memory_s"])
    row = dict(cell=name, arch=arch, kind=kind, batch=batch, seq=seq,
               argument_bytes=real_bytes, first_s=walls[0], steady_s=steady,
               t_compute_s=rec["t_compute_s"], t_memory_s=rec["t_memory_s"],
               bottleneck=rec["bottleneck"], wall_over_roofline=steady / roof,
               flops=rec["hlo_flops_per_dev"], bytes=rec["hlo_bytes_per_dev"],
               xla_flops=rec["xla_flops_per_dev"],
               kernel_calls=rec["kernel_calls"],
               temp_size_in_bytes=rec["temp_size_in_bytes"],
               max_allocated_above_inputs=peak_above,
               trace_s=rec["t_lower_s"])
    print(f"dry run {arch} {name}: steady {steady:.4f} s against the "
          f"roofline's {roof:.4f} s ({rec['bottleneck']}; ratio "
          f"{steady / roof:.2f}); peak-live reckoning "
          f"{rec['temp_size_in_bytes'] / 1e9:.3f} GB, max_memory_allocated "
          f"above the inputs {peak_above / 1e9:.3f} GB", flush=True)
    if steady < roof:
        raise AssertionError(f"dry run {arch} {name}: the card ran the step "
                             f"in {steady} s, under the roofline's {roof} "
                             "s: the count is wrong")
    return row


def dryrun_phase(dev, ops) -> dict:
    """Phase 13: (a) the serve_demo twin, (b) the dry run's cells."""
    demo = check_serve_demo(ops)
    print("serve_demo: card = CPU greedy tokens in float32 for",
          demo["archs"], json.dumps(demo), flush=True)
    cells = [check_dryrun_cell(*cell, dev) for cell in DRY_CELLS]
    return dict(serve_demo=demo, cells=cells)


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
    from repro_torch.kernels import mask_evolve as me
    from repro_torch.models import model as model_mod

    dev = torch.device("cuda", 0)
    print("torch", torch.__version__, "cuda", torch.version.cuda, flush=True)
    card = card_line()

    walls = {}
    t_phase = time.perf_counter()
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
        if "Performance Loss" in line:      # wgmma serialised by ptxas
            print("  ptxas:", line.strip())
    if build.BUILD_LOG:
        print("ptxas (registers, spill bytes) of the select_topk, "
              "mask_evolve and wkv_chunked kernels:",
              json.dumps(ptxas_report(build.BUILD_LOG)), flush=True)
    else:
        print("ptxas: the library was built by an earlier run; no report",
              flush=True)
    evidence = tensor_core_evidence(so)
    print("tensor cores (SASS HGMMA per flash instance, HMMA per wkv "
          "instance):",
          json.dumps(evidence), flush=True)

    walls["1 build"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    # ---- 2. kernels against their plain versions ---------------------------
    p = 512 * 10 + 10          # ResNet-18 header: fc weight + bias
    # the last case is what the main path sends since the default fabric:
    # the (M, M) cost matrix and the candidate mask; its row is the
    # kernel's line
    main_sel = []
    for matrix_cost, cand in ((False, False), (True, False), (False, True),
                              (True, True)):
        main_sel.append(check_select(
            ops, ref, select_case(16, p, 4, matrix_cost=matrix_cost,
                                  cand=cand, seed=1, dev=dev), 4, 200,
            graph=matrix_cost == cand))
    scale_sel = [
        check_select(ops, ref, select_case(1024, p, 10, matrix_cost=False,
                                           cand=False, seed=2, dev=dev),
                     10, 20, graph=True),
        check_select(ops, ref, select_case(4096, p, 10, matrix_cost=False,
                                           cand=False, seed=3, dev=dev),
                     10, 5, graph=True),
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
    extractor_f = 11_167_040   # ResNet-18 extractor: all leaves but head
    mixes = [check_gossip(ops, ref, gossip_case(16, extractor_f, 4, 4, 8,
                                                dev), 20, 3),
             check_gossip(ops, ref, gossip_case(1024, 65_536, 10, 1024, 9,
                                                dev), 10, 3),
             check_gossip(ops, ref, gossip_case(16, 1_000_003, 4, 4, 10,
                                                dev), 20, 3)]
    evolves = [check_evolve(me, (16, 512, 512, 3, 3), torch.bfloat16, 10,
                            dev, 10),
               check_evolve(me, (16, 10), torch.bfloat16, 11, dev, 50),
               check_evolve(me, (16, 64), torch.bfloat16, 12, dev, 50)]
    # the dispfl round's stacked leaves: M = 16 copies of each parameter
    leaf_shapes = [(16, *t.shape) for t in model_mod.init_params(
        get_config("resnet18-cifar"),
        torch.Generator(device=dev).manual_seed(0), dev).values()]
    edges = check_evolve_edges(me, dev)
    stage = check_evolve_stage(me, leaf_shapes,
                               1 - FLConfig().dispfl_sparsity, 13, dev, 10)
    for row in mixes:
        print("gossip_mix", json.dumps(row), flush=True)
    for row in evolves:
        print("mask_evolve", json.dumps(row), flush=True)
    print("mask_evolve edge cases (NaN at the kth, subnormal threshold), "
          "bitwise:", json.dumps(edges), flush=True)
    print("mask_evolve stage (one call over the dispfl round's leaves)",
          json.dumps(stage), flush=True)
    # the qwen2-1.5b prefill shape first: its row is the kernel's line
    flashes = [check_flash(ops, ref, (4, 4096, 4096, 12, 2, 128, True, 0, 0),
                           torch.bfloat16, dev, 5, library=True)]
    for case in ((2, 1000, 1000, 12, 2, 128, True, 0, 0),    # rep 6, ragged
                 (1, 777, 1300, 4, 4, 64, True, 0, 523),     # rep 1, offset
                 (1, 900, 900, 6, 1, 64, True, 256, 0),      # rep 6, window
                 (1, 333, 1055, 8, 4, 128, True, 200, 722),  # all of them
                 (2, 500, 700, 4, 2, 64, False, 0, 0)):      # not causal
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            flashes.append(check_flash(ops, ref, case, dtype, dev, 5))
    flashes.append(check_flash(ops, ref, (1, 32768, 32768, 12, 2, 128, True,
                                          0, 0), torch.bfloat16, dev, 3,
                               plain=False, library=True))
    # head_dim 256: recurrentgemma-2b's attention (10 heads over 1 kv head,
    # a 2048-token window), and an f32 ragged case at hd 96 (padded to 128)
    flash_hd256 = check_flash(ops, ref, (1, 4096, 4096, 10, 1, 256, True,
                                         2048, 0), torch.bfloat16, dev, 5,
                              library=True)
    flashes += [flash_hd256,
                check_flash(ops, ref, (1, 777, 1300, 6, 2, 96, True, 300,
                                       523), torch.float32, dev, 5)]
    # the new serving paths' prefill shapes: recurrentgemma-2b (hd 256,
    # window 2048), qwen2.5-14b (40 heads over 8), whisper-base's encoder
    # (not causal) and its cross-attention (416 queries over 1500 keys)
    flash_serving = {
        name: check_flash(ops, ref, case, torch.bfloat16, dev, 5,
                          library=True)
        for name, case in (
            ("recurrentgemma-2b", (4, 4096, 4096, 10, 1, 256, True, 2048,
                                   0)),
            ("qwen2.5-14b", (4, 4096, 4096, 40, 8, 128, True, 0, 0)),
            ("whisper-base encoder", (4, 1500, 1500, 8, 8, 64, False, 0,
                                      0)),
            ("whisper-base cross", (4, 416, 1500, 8, 8, 64, False, 0, 0)),
            ("phi3.5-moe", (4, 4096, 4096, 32, 8, 128, True, 0, 0)),
            ("internvl2-76b", (4, 4096, 4096, 64, 8, 128, True, 0, 0)))}
    # deepseek-v3's MLA prefill: q/k head dim 192 and v 128, all three
    # zero-padded to the hd-256 instance; held to the plain version at the
    # shape the path sends
    flash_mla = check_flash(ops, ref, (4, 4096, 4096, 128, 128, 192, True,
                                       0, 0), torch.bfloat16, dev, 5,
                            library=True, dv=128)
    flashes += list(flash_serving.values()) + [flash_mla]
    for row in flashes:
        print("flash_attention", json.dumps(row), flush=True)
    wkvs = [check_wkv(ops, ref, 4, 4096, 64, torch.bfloat16, -1.0, False,
                      dev, 5, 2),
            check_wkv(ops, ref, 1, 4096 + 37, 8, torch.float32, 1.0, True,
                      dev, 5, 2),
            check_wkv(ops, ref, 2, 300, 4, torch.bfloat16, 1.0, True, dev,
                      5, 2),
            check_wkv(ops, ref, 2, 300 + 13, 4, torch.float16, 1.0, True,
                      dev, 5, 2),
            check_wkv(ops, ref, 2, 1000 + 21, 8, torch.float32, 4.5, True,
                      dev, 5, 2, zero_w=True),
            check_wkv(ops, ref, 2, 777, 8, torch.bfloat16, 4.5, True, dev,
                      5, 2, zero_w=True)]
    for row in wkvs:
        print("wkv_chunked", json.dumps(row), flush=True)
    walls["2 kernels"] = time.perf_counter() - t_phase
    print(f"phase 2 wall: {walls['2 kernels']:.1f} s", flush=True)

    t_phase = time.perf_counter()
    # ---- 3. the main path ---------------------------------------------------
    cfg = get_config("resnet18-cifar")             # full width, bf16
    fl = FLConfig(num_clients=16, peers_per_round=4, batch_size=128,
                  client_sample_ratio=0.25, probe_size=16,
                  use_score_kernel=True)
    data = client_datasets_cifar(0, fl.num_clients,
                                 classes_per_client=fl.classes_per_client,
                                 samples_per_class=120, image_size=32)
    n_leaves = len(leaf_shapes)
    # the baselines at lr 0.01: at the paper's 0.1 their full-model SGD
    # step diverges to NaN within a round, in the JAX reference as well
    # (ROADMAP queue 3)
    fl_base = dataclasses.replace(fl, lr=BASELINE_LR)
    # every run goes through the default fabric (FLConfig.comms =
    # CommsConfig(): full topology, uniform links, no events)
    paths = [run_path(name, cfg, fl if name.startswith("pfeddst")
                      else fl_base, data, rounds, dev, run_experiment, ops,
                      n_leaves)
             for name, rounds in (("pfeddst", 3), ("pfeddst_random", 3),
                                  ("dfedpgp", 3), ("dispfl", 3),
                                  ("dfedavgm", 2), ("fedavg", 2),
                                  ("fedper", 2), ("fedbabu", 2))]
    # the default fabric is inert: pfeddst selects in every round as the
    # fabric-less path does (both runs with cuDNN deterministic)
    inert = [pfeddst_masks(cfg, dataclasses.replace(fl, comms=comms), data,
                           dev, run_experiment, ops, 3)[0]
             for comms in (None, fl.comms)]
    compare_masks("default fabric against none", *inert)
    print("default fabric: pfeddst selections equal the fabric-less ones "
          f"in all {len(inert[0])} rounds (edges "
          f"{[int(m.sum()) for m in inert[0]]})", flush=True)
    launches = {PATH_KERNELS[r["name"]]: r["launches"][PATH_KERNELS[r["name"]]]
                for r in paths if r["name"] in PATH_KERNELS}
    evolve_leaves = next(r["launches"]["mask_evolve_leaves"] for r in paths
                         if r["name"] == "dispfl")
    for run in paths:
        print("path", json.dumps(run), flush=True)
    serves = []
    for arch in SERVE_RUNS:
        serves.append(run_serve(arch, dev, ops))
        print("serve", json.dumps(serves[-1]), flush=True)
    # each serving kernel's launches over the serving runs that use it
    launches_serve = {r["arch"]: r["launches"][r["kernel"]] for r in serves}
    for kernel in ("flash_attention", "wkv_chunked"):
        launches[kernel] = sum(r["launches"][kernel] for r in serves
                               if r["kernel"] == kernel)
    print("launches (each kernel in its path's run):", json.dumps(
        {**launches, "mask_evolve_leaves": evolve_leaves}),
          flush=True)
    walls["3 path"] = time.perf_counter() - t_phase
    print(f"phase 3 wall: {walls['3 path']:.1f} s", flush=True)

    t_phase = time.perf_counter()
    # ---- 4. card against CPU at a small size -------------------------------
    agree = check_agreement(dev)
    print("agree: masks exact, loss_matrix max abs diff", json.dumps(agree),
          flush=True)
    agree_base = check_baseline_agreement(dev)
    print("agree: dfedpgp/dispfl edges exact, params within rtol 1e-3",
          json.dumps(agree_base), flush=True)
    agree_serve = check_serve_agreement(dev)
    print("agree: serving greedy tokens equal, prefill max abs diff",
          json.dumps(agree_serve), flush=True)
    walls["4 agree"] = time.perf_counter() - t_phase
    print(f"phase 4 wall: {walls['4 agree']:.1f} s", flush=True)

    t_phase = time.perf_counter()
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
    # the engine's `stage:<name>` profiler ranges also show as device
    # rows (a range's span on the device's timeline); they are not
    # kernels, so they stay out of the kernel sum
    kernels_only = [e for e in events if e.device_type == DeviceType.CUDA
                    and not e.key.startswith("stage:")]
    # device time = the kernels' own rows (the operator rows repeat it)
    dev_us = sum(e.self_device_time_total for e in kernels_only)
    table = events.table(sort_by="self_device_time_total", row_limit=25)
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke_profile.txt").write_text(
        f"{card}\nround wall {wall:.4f} s, device time {dev_us / 1e6:.4f} s"
        f"\n{table}\n")
    print(f"profile: steady pfeddst round wall {wall:.4f} s (profiled), "
          f"device kernel time {dev_us / 1e6:.4f} s "
          f"(busy share {dev_us / 1e6 / wall:.3f})", flush=True)
    top = sorted(kernels_only, key=lambda e: e.self_device_time_total,
                 reverse=True)[:8]
    for e in top:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:5d}x  "
              f"{e.key[:90]}")

    walls["5 profile"] = time.perf_counter() - t_phase
    print(f"phase 5 wall: {walls['5 profile']:.1f} s", flush=True)

    t_phase = time.perf_counter()
    # ---- 6. the comms fabric -------------------------------------------------
    launches_fabric = fabric_phase(cfg, fl, data, dev, run_experiment, ops,
                                   ref)
    walls["6 fabric"] = time.perf_counter() - t_phase
    print(f"phase 6 wall: {walls['6 fabric']:.1f} s", flush=True)

    t_phase = time.perf_counter()
    # ---- 7. semi-async rounds and the round trace ----------------------------
    async_rows = async_phase(cfg, fl, data, dev, run_experiment, ops)
    walls["7 async"] = time.perf_counter() - t_phase
    print(f"phase 7 wall: {walls['7 async']:.1f} s", flush=True)

    t_phase = time.perf_counter()
    # ---- 8. the open world and checkpoints ----------------------------------
    launches_ow = openworld_phase(cfg, fl, data, dev, run_experiment, ops,
                                  n_leaves)
    walls["8 openworld"] = time.perf_counter() - t_phase
    print(f"phase 8 wall: {walls['8 openworld']:.1f} s", flush=True)

    t_phase = time.perf_counter()
    # ---- 9. the experiment drivers and chunked rounds ------------------------
    launches_driver = driver_phase(
        cfg, fl, data, dev, ops, {r["name"]: r["round_walls_s"]
                                  for r in paths})
    walls["9 driver"] = time.perf_counter() - t_phase
    print(f"phase 9 wall: {walls['9 driver']:.1f} s", flush=True)

    t_phase = time.perf_counter()
    # ---- 10. the hybrid family: the RG-LRU scan and a profiled prefill -------
    scan = check_lru_scan(dev)
    print("rg_lru_scan (B=4, S=4096, W=2560, f32) against the sequential "
          "f64 recurrence:", json.dumps(scan), flush=True)
    hybrid_prof = profile_hybrid_prefill(dev, ops)
    print("profile: recurrentgemma-2b steady prefill",
          json.dumps(hybrid_prof), flush=True)
    walls["10 hybrid"] = time.perf_counter() - t_phase
    print(f"phase 10 wall: {walls['10 hybrid']:.1f} s", flush=True)

    t_phase = time.perf_counter()
    # ---- 11. the MoE layer: repeatable prefills, drops, a profile ----------
    moe_rows = moe_phase(dev, ops)
    print("moe (phi3.5-moe, deepseek-v3 at their served depths):",
          json.dumps(moe_rows), flush=True)
    walls["11 moe"] = time.perf_counter() - t_phase
    print(f"phase 11 wall: {walls['11 moe']:.1f} s", flush=True)

    t_phase = time.perf_counter()
    # ---- 12. federated LLM training ----------------------------------------
    llm = llm_train_phase(dev, ops, ref, me)
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke_llm.json").write_text(json.dumps(llm))
    print("llm paths:", json.dumps(llm["paths"]), flush=True)
    print("llm cli:", json.dumps(llm["cli"]), flush=True)
    print("llm pair steps:", json.dumps(llm["pair_steps"]), flush=True)
    walls["12 llm"] = time.perf_counter() - t_phase
    print(f"phase 12 wall: {walls['12 llm']:.1f} s", flush=True)

    t_phase = time.perf_counter()
    # ---- 13. the serve_demo twin and the dry run against the card ---------
    dry = dryrun_phase(dev, ops)
    (OUT_DIR / "chip_smoke_dryrun.json").write_text(json.dumps(dry))
    print("dry run cells:", json.dumps(dry["cells"]), flush=True)
    walls["13 dryrun"] = time.perf_counter() - t_phase
    print(f"phase 13 wall: {walls['13 dryrun']:.1f} s", flush=True)

    # ---- output -------------------------------------------------------------
    k_main = main_sel[-1]
    assert k_main["matrix_cost"] and k_main["cand"]
    g_main = grams[0]
    # the route each dtype's flash cases reached (route_launches)
    flash_routes = {}
    for row in flashes:
        if flash_routes.setdefault(row["dtype"], row["route"]) != row["route"]:
            raise AssertionError(f"flash_attention {row['dtype']} reached "
                                 f"{flash_routes[row['dtype']]} and "
                                 f"{row['route']}")
    kernels = [
        {"name": "select_topk", "route": "cuda",
         "source": "src/repro_torch/csrc/select_topk.cu",
         "replaces": "src/repro/kernels/select_score.py:152",
         "inputs": "M=16, (M, M) cost matrix and candidate mask",
         "launches": launches["select_topk"],
         "max_abs_err": max(r["max_abs_err"] for r in main_sel),
         "ms": k_main["ms"], "device_ms": k_main["device_ms"],
         "plain_ms": k_main["plain_ms"],
         "bound_ms": k_main["bound_ms"], "bound_by": k_main["bound_by"],
         "library_ms": None},
        {"name": "raw_gram", "route": "cuda",
         "source": "src/repro_torch/csrc/raw_gram.cu",
         "replaces": "src/repro/kernels/peer_score.py:83",
         "splits": g_main["splits"],
         "launches": launches["raw_gram"],
         "max_abs_err": g_main["max_abs_err"],
         "ms": g_main["ms"], "plain_ms": g_main["plain_ms"],
         "bound_ms": g_main["bound_ms"], "bound_by": g_main["bound_by"],
         "library_ms": g_main["library_ms"]},
        {"name": "gossip_mix", "route": "cuda",
         "source": "src/repro_torch/csrc/gossip_mix.cu",
         "replaces": "src/repro/kernels/gossip_mix.py:96",
         "launches": launches["gossip_mix"],
         "max_abs_err": mixes[0]["max_abs_err"],
         "ms": mixes[0]["ms"], "plain_ms": mixes[0]["plain_ms"],
         "bound_ms": mixes[0]["bound_ms"], "bound_by": mixes[0]["bound_by"],
         "library_ms": mixes[0]["library_ms"]},
        {"name": "mask_evolve", "route": "cuda",
         "source": "src/repro_torch/csrc/mask_evolve.cu",
         "replaces": "src/repro/kernels/mask_evolve.py:110",
         "launches": launches["mask_evolve"], "leaves": evolve_leaves,
         "stage_ms": stage["ms"], "stage_device_ms": stage["device_ms"],
         "max_abs_err": max(r["max_abs_err"] for r in evolves),
         "ms": evolves[0]["ms"], "plain_ms": evolves[0]["plain_ms"],
         "bound_ms": evolves[0]["bound_ms"],
         "bound_by": evolves[0]["bound_by"],
         "library_ms": evolves[0]["library_ms"]},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:112",
         "routes": flash_routes,
         "launches": launches["flash_attention"],
         "launches_serve": {a: n for a, n in launches_serve.items()
                            if SERVE_RUNS[a][0] == "flash_attention"},
         "hd256": {k: flash_hd256[k] for k in (
             "shape", "dtype", "max_abs_err", "ms", "plain_ms", "bound_ms",
             "bound_by", "library_ms")},
         "serving_shapes": {name: {k: row[k] for k in (
             "shape", "max_abs_err", "ms", "plain_ms", "bound_ms",
             "bound_by", "library_ms")}
             for name, row in flash_serving.items()},
         "mla": {k: flash_mla[k] for k in (
             "shape", "dv", "max_abs_err", "ms", "plain_ms", "bound_ms",
             "bound_by", "library_ms", "tflops")},
         "max_abs_err": flashes[0]["max_abs_err"],
         "ms": flashes[0]["ms"], "plain_ms": flashes[0]["plain_ms"],
         "bound_ms": flashes[0]["bound_ms"],
         "bound_by": flashes[0]["bound_by"],
         "library_ms": flashes[0]["library_ms"]},
        {"name": "wkv_chunked", "route": "cuda",
         "source": "src/repro_torch/csrc/wkv_chunked.cu",
         "replaces": "src/repro/kernels/wkv_chunked.py:107",
         "kernels": list(WKV_KERNELS),
         "launches": launches["wkv_chunked"],
         "launches_serve": {a: n for a, n in launches_serve.items()
                            if SERVE_RUNS[a][0] == "wkv_chunked"},
         "max_abs_err": wkvs[0]["max_abs_err"],
         "ms": wkvs[0]["ms"], "plain_ms": wkvs[0]["plain_ms"],
         "bound_ms": wkvs[0]["bound_ms"], "bound_by": wkvs[0]["bound_by"],
         "library_ms": None},
    ]
    for entry in kernels:
        entry["launches_fabric"] = {run: counts[entry["name"]]
                                    for run, counts in
                                    launches_fabric.items()}
    kernels[0]["launches_async"] = \
        async_rows["stragglers"]["launches"]["select_topk"]
    llm_launches = {r["kernel"]: r["launches"].get(r["kernel"], 0)
                    for r in llm["paths"]}
    for entry in kernels:
        name = entry["name"]
        if name in llm_launches:
            cell = llm["cells"][name]
            entry["launches_llm"] = llm_launches[name]
            entry["llm_shape"] = {k: cell[k] for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms") if k in cell}
        if entry["name"] in launches_ow:
            entry["launches_openworld"] = launches_ow[entry["name"]]
        if entry["name"] in launches_driver:
            entry["launches_driver"] = launches_driver[entry["name"]]
        if name in dry["serve_demo"]["launches"]:
            entry["launches_serve_demo"] = \
                dry["serve_demo"]["launches"][name]
    print("round walls (s):", json.dumps(
        {r["name"]: r["round_walls_s"] for r in paths}), flush=True)
    print("serving (s, tokens/s):", json.dumps(
        {r["arch"]: {k: r[k] for k in (
            "prefill_first_s", "prefill_steady_s", "decode_first_s",
            "decode_steady_s", "prefill_tok_per_s", "decode_tok_per_s")}
         for r in serves}), flush=True)
    for r in serves:
        if r["prefill_profile"]:
            print(f"profile: {r['arch']} steady prefill", json.dumps(
                r["prefill_profile"]), flush=True)
    print("phase walls (s):", json.dumps(walls), flush=True)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
